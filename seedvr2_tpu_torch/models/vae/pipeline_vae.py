"""VideoVAE: temporal slicing over the encoder/decoder cores.

Port of seedvr2_tpu.models.vae.pipeline_vae, untiled branches: frame 0 plus
4-frame groups (latent: 2 then 1), with the causal-conv tail state threaded
between slices; latent = posterior mode = the first `latent_channels`
channels of the encoder moments. Spatial tiling waits for a later port.

Layout is channels-last: video (B, T, H, W, 3) in [-1, 1], latent
(B, Tl, h, w, latent_channels).
"""

import math
from typing import Optional

import torch
from torch import nn

from ...core.configs import VAEConfig
from .model import VideoAutoencoder, decoder_core, encoder_core


def _encode_slices(vae: VideoAutoencoder, x: torch.Tensor) -> torch.Tensor:
    """Temporally sliced encode; returns the (un-truncated) moments. Tails
    are kept only for slices that have a successor."""
    T = x.shape[1]
    split = vae.cfg.slicing_sample_min_size
    if (T - 1) <= split:
        return encoder_core(vae, x, None, keep_state=False)[0]
    outs = []
    moments, state = encoder_core(vae, x[:, : split + 1], None)
    outs.append(moments)
    pos = split + 1
    while pos < T:
        last = pos + split >= T
        moments, state = encoder_core(vae, x[:, pos: pos + split], state,
                                      keep_state=not last)
        outs.append(moments)
        pos += split
    return torch.cat(outs, dim=1)


def _decode_slices(vae: VideoAutoencoder, z: torch.Tensor) -> torch.Tensor:
    """Temporally sliced decode (latent frame 0 + 1, then one at a time)."""
    Tl = z.shape[1]
    split = vae.cfg.slicing_latent_min_size
    if (Tl - 1) <= split:
        return decoder_core(vae, z, None, keep_state=False)[0]
    outs = []
    out, state = decoder_core(vae, z[:, : split + 1], None)
    outs.append(out)
    pos = split + 1
    while pos < Tl:
        last = pos + split >= Tl
        out, state = decoder_core(vae, z[:, pos: pos + split], state,
                                  keep_state=not last)
        outs.append(out)
        pos += split
    return torch.cat(outs, dim=1)


class VideoVAE:
    """Encode/decode front end over a VideoAutoencoder's parameters."""

    def __init__(self, model: VideoAutoencoder, dtype=torch.bfloat16):
        self.model = model
        self.cfg: VAEConfig = model.cfg
        self.dtype = dtype

    @torch.no_grad()
    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T, H, W, 3) in [-1, 1], T % 4 == 1 -> latent mode
        (B, (T-1)/4+1, H/8, W/8, latent_channels)."""
        moments = _encode_slices(self.model, x.to(self.dtype))
        return moments[..., : self.cfg.latent_channels]

    @torch.no_grad()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z: (B, Tl, h, w, latent) -> (B, (Tl-1)*4+1, 8h, 8w, 3)."""
        return _decode_slices(self.model, z.to(self.dtype))


@torch.no_grad()
def init_vae_params(cfg: VAEConfig, device, dtype=torch.bfloat16,
                    generator: Optional[torch.Generator] = None
                    ) -> VideoAutoencoder:
    """Random VAE drawn directly on `device` with the JAX package's
    init_vae_params distributions: conv and linear weights and biases
    U(+-1/sqrt(fan_in)), group norms weight 1 / bias 0; drawn in fp32 and
    rounded to `dtype`."""
    with torch.device("meta"):
        model = VideoAutoencoder(cfg, dtype=dtype)
    model = model.to_empty(device=device)
    for mod in model.modules():
        if isinstance(mod, (nn.Conv3d, nn.Linear)):
            w = mod.weight
            bound = 1.0 / math.sqrt(w[0].numel())
            for p in (w, mod.bias):
                tmp = torch.empty(p.shape, dtype=torch.float32, device=p.device)
                p.copy_(tmp.uniform_(-bound, bound, generator=generator))
        elif isinstance(mod, nn.GroupNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    return model
