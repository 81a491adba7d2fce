"""peak_mem_gib (GiB): the most device memory the allocator held over the
window (torch.cuda.max_memory_allocated, reset at its start); None off
the card."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
