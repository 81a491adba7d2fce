"""setup_s (s, host clock): from the start of the process to the window's
first request: imports, the kernel library's load (and build, in a
fresh checkout), the weights, the pool of inputs and the warm-up."""


def read(run):
    return run.setup_s
