"""Example: a long video upscaled in bounded memory, the reference's
SeedVR2_HD_video_upscale workflow with the CLI's chunked streaming. It
prints the port CLI's command:

    python -m seedvr2_tpu_torch.examples.upscale_video_streaming"""

import sys

CMD = [
    sys.executable, "-m", "seedvr2_tpu_torch.cli", "INPUT.mp4",
    "--resolution", "1080",
    "--batch_size", "21",           # largest 4n+1 <= typical shot length
    "--chunk_size", "125",          # frames held in host RAM at once
    "--temporal_overlap", "4",      # Hann-blended seams between batches/chunks
    "--color_correction", "lab",
    "--vae_decode_tiled",           # bound device memory at high resolutions
    "--vae_decode_tile_size", "1024",
    "--cache_dit", "--cache_vae",   # keep the models across chunks
]

if __name__ == "__main__":
    print("example command:\n ", " ".join(CMD))
