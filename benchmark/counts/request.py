"""The counted work of one request of a cell: the NaDiT forward and the
VAE's encode and decode, from the configuration and the traffic mix."""

from typing import List

from .. import traffic
from ..reference import geometry
from . import dit as dit_counts, vae as vae_counts
from .work import Work


def request(cfg: dict, mix: dict) -> List[Work]:
    vae = cfg["vae"]
    tl, hl, wl, _ = traffic.latent_shape(mix, vae)
    t = (tl - 1) * vae["temporal_downsample_factor"] + 1
    hp, wp = geometry.padded_dims(mix["height"], mix["width"],
                                  mix["resolution"])
    if cfg["lane"]["vae_quant"] != "none":
        raise ValueError("the counts hold the VAE's bf16 lane only")
    return (dit_counts.dit_request(cfg["dit"], (tl, hl, wl), mix["txt_len"],
                                   cfg["lane"]["quant"])
            + vae_counts.request(vae, cfg["lane"]["vae_tiling"], t, hp, wp))
