"""Example: a single-image upscale through the port's node API, the
reference's SeedVR2_simple_image_upscale workflow:

    python -m seedvr2_tpu_torch.examples.upscale_image IN.png OUT.png [RES]

The checkpoints are looked up (and downloaded when missing) in ./models;
the nodes run on the card (cuda:0). Reading and writing images needs
OpenCV."""

import sys

from ..interfaces import (SeedVR2LoadDiTModel, SeedVR2LoadVAEModel,
                          SeedVR2VideoUpscaler)
from ..utils import video_io


def main(input_path: str, output_path: str, resolution: int = 1080):
    frames = video_io.read_image(input_path)  # (1, H, W, C) in [0, 1]

    dit = SeedVR2LoadDiTModel.execute(
        model="seedvr2_ema_3b_fp16.safetensors", attention_mode="flash")
    vae = SeedVR2LoadVAEModel.execute(model="ema_vae_fp16.safetensors")

    out = SeedVR2VideoUpscaler.execute(
        image=frames, dit=dit, vae=vae, seed=42, resolution=resolution,
        color_correction="lab")
    video_io.write_image(output_path, out[0])
    print(f"wrote {output_path} {out.shape}")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2],
         int(sys.argv[3]) if len(sys.argv) > 3 else 1080)
