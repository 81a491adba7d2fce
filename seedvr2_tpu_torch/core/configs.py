"""Model / pipeline configuration.

Copied whole from the JAX package (seedvr2_tpu.core.configs) and pinned equal
to it by tests/test_torch_configs.py: plain frozen dataclasses whose numbers
mirror the published SeedVR2 configs (configs_3b/main.yaml,
configs_7b/main.yaml, s8_c16_t4_inflation_sd3.yaml).
"""

from dataclasses import dataclass, field, replace
from typing import Tuple


@dataclass(frozen=True)
class DiTConfig:
    """NaDiT architecture config (3B: configs_3b/main.yaml; 7B:
    configs_7b/main.yaml)."""

    family: str  # "dit_3b" | "dit_7b"
    vid_in_channels: int = 33
    vid_out_channels: int = 16
    vid_dim: int = 2560
    txt_in_dim: int = 5120
    heads: int = 20
    head_dim: int = 128
    expand_ratio: int = 4
    norm_eps: float = 1e-5
    qk_bias: bool = False
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    num_layers: int = 32
    # 3B: first `mm_layers` blocks have separate vid/txt weights, rest shared.
    mm_layers: int = 10
    mlp_type: str = "swiglu"  # "swiglu" (3B) | "normal" (7B)
    window: Tuple[int, int, int] = (4, 3, 3)
    # Alternating plain/shifted 720p-normalized windows (main.yaml window_method).
    rope_type: str = "mmrope3d"  # "mmrope3d" (3B) | "rope3d_window" (7B)
    rope_dim: int = 128  # 3B: rope_dim; 7B uses head_dim//2 = 64
    vid_out_norm: bool = True  # 3B only
    # 7B: shared_qkv / shared_mlp control MMModule sharing for all layers.
    shared_qkv: bool = False
    shared_mlp: bool = False
    # NaDiTUpscaler variant: extra emb_scale TimeEmbedding on a downscale
    # factor.
    upscaler: bool = False

    @property
    def txt_dim(self) -> int:
        return self.vid_dim

    @property
    def emb_dim(self) -> int:
        return 6 * self.vid_dim

    def block_shared(self, i: int) -> bool:
        """Whether block i uses one weight set for both vid and txt streams."""
        if self.family == "dit_3b":
            return not (i < self.mm_layers)
        return self.shared_qkv  # 7B: False in the published config

    def block_vid_only(self, i: int) -> bool:
        """3B last layer drops the txt mlp branch (mmsr_block.py:73-81)."""
        return self.family == "dit_3b" and i == self.num_layers - 1

    def window_method(self, i: int) -> str:
        return "window" if i % 2 == 0 else "shifted_window"


DIT_3B = DiTConfig(family="dit_3b")

DIT_7B = DiTConfig(
    family="dit_7b",
    vid_dim=3072,
    heads=24,
    num_layers=36,
    mlp_type="normal",
    rope_type="rope3d_window",
    rope_dim=64,  # head_dim // 2 (dit_7b/nablocks/mmsr_block.py:50)
    vid_out_norm=False,
    mm_layers=0,
)


@dataclass(frozen=True)
class VAEConfig:
    """Causal video VAE config (s8_c16_t4_inflation_sd3.yaml)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    temporal_scale_num: int = 2  # number of temporal down/up stages
    spatial_downsample_factor: int = 8
    temporal_downsample_factor: int = 4
    slicing_sample_min_size: int = 4  # set_causal_slicing split_size
    scaling_factor: float = 0.9152
    shifting_factor: float = 0.0
    # "full": all resnet convs are full causal 3x3x3; the legacy family's
    # "half" stores resnet conv2 as (1,3,3). The temporal pad is derived from
    # each conv's kernel depth at run time.
    time_receptive_field: str = "full"
    # Legacy family switches: no mid-block attention, optional 1x1x1 causal
    # quant/post-quant convs around the latent.
    mid_attention: bool = True
    use_quant_conv: bool = False
    use_post_quant_conv: bool = False
    # "int8": the decoder's 3x3x3 resnet convs as int8 convs (kernel K11).
    conv_quant: str = "none"

    @property
    def slicing_latent_min_size(self) -> int:
        return self.slicing_sample_min_size // self.temporal_downsample_factor


VAE_V3 = VAEConfig()


@dataclass(frozen=True)
class DiffusionConfig:
    """Rectified-flow diffusion settings (configs_*/main.yaml diffusion block)."""

    schedule_T: float = 1000.0
    prediction_type: str = "v_lerp"
    sampling_steps: int = 50  # pipeline overrides to 1 for the distilled model
    cfg_scale: float = 7.5  # pipeline overrides to 1.0
    cfg_rescale: float = 0.0
    timestep_transform: bool = True


@dataclass(frozen=True)
class RunnerConfig:
    """Everything the pipeline runner needs for one model pair."""

    dit: DiTConfig = DIT_3B
    vae: VAEConfig = VAE_V3
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    condition_noise_scale: float = 0.25


def dit_config_for(name: str) -> DiTConfig:
    """Map a checkpoint filename or family name to a DiTConfig."""
    lowered = name.lower()
    if "7b" in lowered:
        return DIT_7B
    return DIT_3B


def small_test_config(
    family: str = "dit_3b",
    vid_dim: int = 64,
    heads: int = 2,
    head_dim: int = 32,
    num_layers: int = 2,
    txt_in_dim: int = 48,
) -> DiTConfig:
    """Tiny config for unit tests (keeps the same structural wiring)."""
    base = DIT_3B if family == "dit_3b" else DIT_7B
    return replace(
        base,
        vid_dim=vid_dim,
        heads=heads,
        head_dim=head_dim,
        num_layers=num_layers,
        txt_in_dim=txt_in_dim,
        mm_layers=1 if family == "dit_3b" else 0,
        rope_dim=(head_dim if family == "dit_3b" else head_dim // 2),
    )
