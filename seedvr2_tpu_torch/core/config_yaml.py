"""Reference-format YAML config ingestion.

A copy of seedvr2_tpu.core.config_yaml building the port's DiTConfig /
VAEConfig. The reference configures models with OmegaConf YAMLs using
`${.sibling}` interpolation and an `${eval:'...'}` resolver
(src/common/config.py:24-133, configs_3b/main.yaml). This module parses
that exact format into the dataclass configs so users can bring custom
model YAMLs unchanged. PyYAML is imported inside the functions: no entry
point needs this module, and a host without PyYAML imports it still.

The eval resolver runs with empty builtins (same trust model as the
reference, which evals config strings via OmegaConf)."""

import re
from dataclasses import replace
from typing import Any, Dict

from .configs import DIT_3B, DIT_7B, DiTConfig, VAEConfig

_INTERP = re.compile(r"\$\{\.(\w+)\}")
_EVAL = re.compile(r"^\$\{eval:'(.*)'\}$", re.S)


def _resolve(value: Any, scope: Dict[str, Any]) -> Any:
    if not isinstance(value, str):
        return value
    m = _EVAL.match(value.strip())
    expr = m.group(1) if m else None
    target = expr if expr is not None else value

    def sub(match):
        return repr(_resolve(scope[match.group(1)], scope))

    target = _INTERP.sub(sub, target)
    if expr is not None:
        return eval(target, {"__builtins__": {}}, {})  # noqa: S307
    if _INTERP.search(value):
        return target
    # plain "${.name}" full-string interpolation
    if value.startswith("${.") and value.endswith("}"):
        return _resolve(scope[value[3:-1]], scope)
    return value


def _resolved_model_dict(raw: dict) -> Dict[str, Any]:
    model = dict(raw["dit"]["model"])
    return {k: _resolve(v, model) for k, v in model.items()
            if k != "__object__"}


def dit_config_from_yaml(path: str) -> DiTConfig:
    """Parse a reference main.yaml into a DiTConfig."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    m = _resolved_model_dict(raw)
    family = ("dit_7b" if "7b" in raw["dit"]["model"]["__object__"]["path"]
              else "dit_3b")
    base = DIT_7B if family == "dit_7b" else DIT_3B

    window = m.get("window")
    if isinstance(window, list):
        if not all(tuple(w) == tuple(window[0]) for w in window):
            raise ValueError("per-layer heterogeneous windows are not "
                             "supported")
        window = tuple(window[0])
    methods = m.get("window_method")
    if isinstance(methods, list):
        expected = ["720pwin_by_size_bysize", "720pswin_by_size_bysize"]
        if not all(mm == expected[i % 2] for i, mm in enumerate(methods)):
            raise ValueError("only alternating plain/shifted window methods "
                             "are supported")

    kwargs = dict(
        family=family,
        vid_in_channels=m.get("vid_in_channels", base.vid_in_channels),
        vid_out_channels=m.get("vid_out_channels", base.vid_out_channels),
        vid_dim=m.get("vid_dim", base.vid_dim),
        txt_in_dim=m.get("txt_in_dim", base.txt_in_dim),
        heads=m.get("heads", base.heads),
        head_dim=m.get("head_dim", base.head_dim),
        expand_ratio=m.get("expand_ratio", base.expand_ratio),
        norm_eps=float(m.get("norm_eps", base.norm_eps)),
        qk_bias=bool(m.get("qk_bias", base.qk_bias)),
        patch_size=tuple(m.get("patch_size", base.patch_size)),
        num_layers=m.get("num_layers", base.num_layers),
        mlp_type=m.get("mlp_type", base.mlp_type),
        vid_out_norm=bool(m.get("vid_out_norm", base.vid_out_norm)),
    )
    if window is not None:
        kwargs["window"] = window
    if family == "dit_3b":
        kwargs["mm_layers"] = m.get("mm_layers", base.mm_layers)
        kwargs["rope_dim"] = m.get("rope_dim", base.rope_dim)
    else:
        kwargs["shared_qkv"] = bool(m.get("shared_qkv", False))
        kwargs["shared_mlp"] = bool(m.get("shared_mlp", False))
        kwargs["rope_dim"] = m.get("head_dim", base.head_dim) // 2
    return replace(base, **kwargs)


def vae_config_from_yaml(path: str) -> VAEConfig:
    """Parse the reference VAE yaml (s8_c16_t4_inflation_sd3.yaml)."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    base = VAEConfig()
    return replace(
        base,
        in_channels=raw.get("in_channels", base.in_channels),
        out_channels=raw.get("out_channels", base.out_channels),
        latent_channels=raw.get("latent_channels", base.latent_channels),
        block_out_channels=tuple(raw.get("block_out_channels",
                                         base.block_out_channels)),
        layers_per_block=raw.get("layers_per_block", base.layers_per_block),
        norm_num_groups=raw.get("norm_num_groups", base.norm_num_groups),
        temporal_scale_num=raw.get("temporal_scale_num",
                                   base.temporal_scale_num),
        spatial_downsample_factor=raw.get("spatial_downsample_factor",
                                          base.spatial_downsample_factor),
        temporal_downsample_factor=raw.get("temporal_downsample_factor",
                                           base.temporal_downsample_factor),
        slicing_sample_min_size=raw.get("slicing_sample_min_size",
                                        base.slicing_sample_min_size),
    )
