"""The port's checkpoint loader (seedvr2_tpu_torch.core.loader) against the
JAX package's (seedvr2_tpu.core.model_manager.load_dit_checkpoint /
load_vae_checkpoint) on synthetic reference-layout files:

 - the repairs: a DiT file carrying the reference's rope buffers
   (`*.rope.freqs`, `*.dummy`) loads, and a VAE file in the deprecated
   layout (`model.` prefix, query/key/value/proj_attn names, (C, C, 1, 1)
   attention projections, 2D-stored convs) loads as in JAX;
 - every DiT route: .safetensors, .pth and fp8 .safetensors under every
   --quant, and a mixed GGUF file under every --quant, each equal to the JAX
   tree (through state_dict_from_jax) key for key and bit for bit;
 - the config sniffing (and its fallback to the base config on quantised
   leaves), the model registry;
 - the 7B family: fp16, fp8-mixed and .pth files and a Q4_K_M-like GGUF
   under every --quant, each loaded equal to the JAX loader's tree and
   forward; its sniffing; a 7B under a neutral name; the CLI's runner;
 - tiny NaDiT forwards of the q8, q4 and q4k lanes against the JAX forward
   of the same tree: fp32 on both sides, 1e-4 as for the dense forward
   (tests/test_torch_dit.py; the plain K6/K7 sum in another order).

The tiny configs pass a small min_dim (and w8a8 align) to both packages'
conversions: the JAX loader's are patched to take it.
"""

import dataclasses
import functools
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seedvr2_tpu.core import export as jexport
from seedvr2_tpu.core import loader as jloader
from seedvr2_tpu.core import model_manager as jmm
from seedvr2_tpu.core.configs import DIT_3B as JDIT_3B
from seedvr2_tpu.core.configs import DIT_7B as JDIT_7B
from seedvr2_tpu.core.configs import VAEConfig as JVAEConfig
from seedvr2_tpu.core.configs import small_test_config as j_small
from seedvr2_tpu.models.dit import nadit as jn
from seedvr2_tpu.models.vae.pipeline_vae import init_vae_params
from seedvr2_tpu.ops import int8_matmul as jim
from seedvr2_tpu.ops import quant_matmul as jqm
from seedvr2_tpu.utils import model_registry as jreg
from seedvr2_tpu_torch.core import configs as tc
from seedvr2_tpu_torch.core import loader as tl
from seedvr2_tpu_torch.core.weights import state_dict_from_jax
from seedvr2_tpu_torch.models.dit import nadit as tn
from seedvr2_tpu_torch.ops import gguf as tg
from seedvr2_tpu_torch.ops.int8_matmul import W8A8Linear
from seedvr2_tpu_torch.ops.quant_matmul import AffineLinear, Q8Linear
from seedvr2_tpu_torch.utils import model_registry as treg

from .test_torch_dit import random_params
from .test_torch_gguf import write_gguf

MIN_DIM, ALIGN = 64, 32
QUANTS = ("none", "q8", "q4", "q4k", "w8a8")
VAE_KW = dict(block_out_channels=(8, 8, 16, 16), layers_per_block=1,
              latent_channels=4, norm_num_groups=4)


def _same_cfg(ours, ref):
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


def assert_state_equal(model, jparams):
    """The port module's state dict equals the JAX tree's, key for key (the
    quantised linears' buffers included) and bit for bit."""
    ref = state_dict_from_jax(jax.device_get(jparams))
    sd = model.state_dict()
    assert sd.keys() == ref.keys()
    for k, v in ref.items():
        assert sd[k].dtype == v.dtype, k
        np.testing.assert_array_equal(sd[k].numpy(), v.numpy(), err_msg=k)


@pytest.fixture
def jax_min_dim(monkeypatch):
    """The JAX loader's conversions with the tiny configs' size rules."""
    monkeypatch.setattr(jqm, "quantize_dit_params", functools.partial(
        jqm.quantize_dit_params, min_dim=MIN_DIM))
    monkeypatch.setattr(jqm, "quantize_dit_params_affine4",
                        functools.partial(jqm.quantize_dit_params_affine4,
                                          min_dim=MIN_DIM))
    monkeypatch.setattr(jim, "quantize_dit_params_w8a8", functools.partial(
        jim.quantize_dit_params_w8a8, min_dim=MIN_DIM, align=ALIGN))


def _jax_load(path, quant):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jmm.load_dit_checkpoint(path, dtype=jnp.float32, quant=quant)


def _port_load(path, quant, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return tl.load_dit_checkpoint(path, "cpu", torch.float32,
                                      quant=quant, **kw)


# ------------------------------------------------------------ tiny DiT files


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A tiny 3B-family tree and the same weights as fp16 .safetensors with
    the reference's rope buffers, fp32 .pth, and fp8-linear .safetensors."""
    import safetensors.torch

    params = random_params(lambda k: jn.init_dit_params(
        k, j_small(), dtype=jnp.float32), 11)
    d = tmp_path_factory.mktemp("dit")
    state = jexport.to_torch_state_dict(params, dtype=np.float32)
    extra = {"blocks.0.attn.rope.freqs": np.arange(16, dtype=np.float32),
             "blocks.1.attn.rope.dummy": np.zeros(1, np.float32)}
    files = {"st": str(d / "dit_fp16.safetensors"),
             "pth": str(d / "dit_fp32.pth"),
             "fp8": str(d / "dit_fp8_e4m3fn.safetensors")}
    safetensors.torch.save_file(
        {k: torch.from_numpy(v).half() for k, v in {**state, **extra}.items()},
        files["st"])
    torch.save({k: torch.from_numpy(v) for k, v in state.items()},
               files["pth"])
    safetensors.torch.save_file(
        {k: (torch.from_numpy(v).to(torch.float8_e4m3fn) if v.ndim == 2
             else torch.from_numpy(v).half()) for k, v in state.items()},
        files["fp8"])
    return params, files


def test_rope_buffers_are_dropped(tiny, tmp_path):
    """A reference-layout DiT file with `blocks.0.attn.rope.freqs` and a
    `.dummy` buffer: the JAX loader drops them and loads the file; so does
    the port's load_dit_checkpoint, strict for every other key: a really
    missing weight still fails."""
    import safetensors.torch

    params, files = tiny
    jparams, jcfg = _jax_load(files["st"], "none")
    loaded = _port_load(files["st"], "none")
    _same_cfg(loaded.cfg, jcfg)
    assert_state_equal(loaded, jparams)
    state = safetensors.torch.load_file(files["st"])
    del state["blocks.1.mlp.all.proj_out.weight"]
    path = str(tmp_path / "dit_missing.safetensors")
    safetensors.torch.save_file(state, path)
    with pytest.raises(RuntimeError, match="Missing key"):
        _port_load(path, "none")


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("fmt", ["st", "pth", "fp8"])
def test_float_file_routes_match_jax(tiny, jax_min_dim, fmt, quant):
    """Each float checkpoint format under each --quant gives the JAX
    loader's tree: the same sniffed config, the same linears converted
    (Q8 for q8/q4k, affine for q4, w8a8 with gate+up joined), equal
    integers and tables."""
    _, files = tiny
    jparams, jcfg = _jax_load(files[fmt], quant)
    model = _port_load(files[fmt], quant, min_dim=MIN_DIM, align=ALIGN)
    _same_cfg(model.cfg, jcfg)
    assert_state_equal(model, jparams)
    cls = {"none": None, "q8": Q8Linear, "q4k": Q8Linear,
           "q4": AffineLinear, "w8a8": W8A8Linear}[quant]
    kinds = {type(m) for m in model.modules()}
    assert (cls in kinds) if cls else not kinds & {Q8Linear, AffineLinear,
                                                   W8A8Linear}


# ------------------------------------------------------------ a GGUF file

# wide enough that the K-quant serving paths engage (min(N, K) >= 1024,
# K % 256 == 0): width 1024, swiglu hidden 2816
WIDE = dict(vid_dim=1024, heads=8, head_dim=128, num_layers=2,
            txt_in_dim=48)


def _q8_0_bytes(w):
    """Q8_0 blocks of an (N, K) float weight: f16 absmax/127 + 32 int8."""
    n, k = w.shape
    g = w.reshape(n * k // 32, 32).astype(np.float32)
    d = (np.abs(g).max(1) / 127.0).astype(np.float16)
    d32 = d.astype(np.float32)
    inv = np.divide(1.0, d32, out=np.zeros_like(d32), where=d32 > 0)
    q = np.clip(np.round(g * inv[:, None]), -127, 127).astype(np.int8)
    return np.concatenate([d[:, None].view(np.uint8), q.view(np.uint8)],
                          1).tobytes()


def _kquant_bytes(qtype, shape, seed):
    """Random valid Q4_K/Q5_K blocks with small positive d and dmin, so the
    weights have a linear's magnitude."""
    size, elems = tg.BLOCK_SIZES[qtype]
    rng = np.random.default_rng(seed)
    nb = int(np.prod(shape)) // elems
    blocks = rng.integers(0, 256, (nb, size), dtype=np.uint8)
    for off in (0, 2):
        blocks[:, off:off + 2] = rng.uniform(1e-5, 4e-5, (nb, 1)).astype(
            np.float16).view(np.uint8)
    return blocks.tobytes()


@pytest.fixture(scope="module")
def gguf_file(tmp_path_factory):
    """A Q4_K_M-like file of the wide config: Q8_0 attention linears (block
    0's video qkv kept F32 so the config sniff reads it), Q4_K gate/up and
    Q5_K mlp out, F16 dense linears, F32 vectors, all under the
    `model.diffusion_model.` prefix, plus a rope buffer."""
    cfg = j_small(**WIDE)
    params = random_params(lambda k: jn.init_dit_params(
        k, cfg, dtype=jnp.float32), 12)
    state = jexport.to_torch_state_dict(params, dtype=np.float32)
    tensors = []
    for i, (name, v) in enumerate(sorted(state.items())):
        if name == "blocks.0.attn.proj_qkv.vid.weight" or v.ndim == 1:
            qt, raw = tg.F32, v.tobytes()
        elif ".attn.proj_" in name:
            qt, raw = tg.Q8_0, _q8_0_bytes(v)
        elif ".mlp." in name:
            qt = tg.Q5_K if "proj_out" in name else tg.Q4_K
            raw = _kquant_bytes(qt, v.shape, i)
        else:
            qt, raw = tg.F16, v.astype(np.float16).tobytes()
        tensors.append(("model.diffusion_model." + name, v.shape, qt, raw,
                        None))
    tensors.append(("model.diffusion_model.blocks.0.attn.rope.freqs", (64,),
                    tg.F32, np.ones(64, np.float32).tobytes(), None))
    path = tmp_path_factory.mktemp("gguf") / "seedvr2_wide-Q4_K_M.gguf"
    write_gguf(path, tensors)
    return str(path)


@pytest.mark.parametrize("quant", QUANTS)
def test_gguf_routes_match_jax(gguf_file, quant):
    """The GGUF file under each --quant: dense (none), Q8_0 kept with the
    K-quants requantized to Q8 on the host (q8, q4), native Q4_K/Q5_K as
    affine (q4k), everything large to w8a8 (w8a8, Q8 layers dequantized and
    requantized per channel); equal to the JAX loader's tree."""
    jparams, jcfg = _jax_load(gguf_file, quant)
    model = _port_load(gguf_file, quant)
    _same_cfg(model.cfg, jcfg)
    assert_state_equal(model, jparams)
    qkv = model.blocks[1].attn.proj_qkv["all"]
    gate = model.blocks[1].mlp["all"].proj_in_gate
    want = {"none": (torch.nn.Linear, torch.nn.Linear),
            "q8": (Q8Linear, Q8Linear), "q4": (Q8Linear, Q8Linear),
            "q4k": (Q8Linear, AffineLinear),
            "w8a8": (W8A8Linear, W8A8Linear)}[quant]
    assert (type(qkv), type(gate)) == want
    assert isinstance(model.blocks[0].attn.proj_qkv["vid"],
                      W8A8Linear if quant == "w8a8" else torch.nn.Linear)


def test_gguf_q4k_warns_and_serves_as_is(gguf_file):
    with pytest.warns(UserWarning, match="does not re-quantize GGUF"):
        tl.load_dit_checkpoint(gguf_file, "cpu", torch.float32, quant="q4k")


# ------------------------------------------------------------ forwards


def _forward_pair(model, jparams, jcfg, shape=(3, 6, 8), txt_len=7):
    cfg = model.cfg
    rng = np.random.default_rng(42)
    vid = rng.standard_normal((1, *shape, cfg.vid_in_channels),
                              dtype=np.float32)
    txt = rng.standard_normal((1, txt_len, cfg.txt_in_dim), dtype=np.float32)
    plan = jn.build_dit_plan(jcfg, shape, txt_len)
    ref = np.asarray(jax.jit(lambda p, v, x, t: jn.nadit_forward(
        p, jcfg, v, x, t, plan))(jparams, jnp.asarray(vid), jnp.asarray(txt),
                                 jnp.asarray([500.0])))
    dplan = tn.upload_plan(tn.build_dit_plan(cfg, shape, txt_len), cfg, "cpu")
    with torch.no_grad():
        out = tn.nadit_forward(model, torch.from_numpy(vid),
                               torch.from_numpy(txt), torch.tensor([500.0]),
                               dplan).numpy()
    return out, ref


@pytest.mark.parametrize("quant", ["q8", "q4"])
def test_quantised_nadit_forward_matches_jax(tiny, jax_min_dim, quant):
    _, files = tiny
    jparams, jcfg = _jax_load(files["st"], quant)
    model = _port_load(files["st"], quant, min_dim=MIN_DIM)
    out, ref = _forward_pair(model, jparams, jcfg)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_q4k_gguf_nadit_forward_matches_jax(gguf_file):
    """The wide model from the GGUF file in the q4k lane (Q8 attention, K7
    on the native Q4_K/Q5_K mlp) against the JAX forward."""
    jparams, jcfg = _jax_load(gguf_file, "q4k")
    model = _port_load(gguf_file, "q4k")
    out, ref = _forward_pair(model, jparams, jcfg, shape=(1, 6, 6))
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


# ------------------------------------------------- sniffing and refusals


def test_sniff_falls_back_on_quantised_leaves(tiny, tmp_path):
    """sniff_dit_config reads the tiny config off the float tensors, and
    returns the base config when block 0's qkv is a quantised dict leaf, in
    JAX and in the port (kept as is). A quantised GGUF of another depth
    therefore loads in neither: JAX hands back the full 3B config with the
    tiny tree, the port's strict load of that config raises."""
    params, _ = tiny
    state = jexport.to_torch_state_dict(params, dtype=np.float32)
    _same_cfg(tl.sniff_dit_config(state, tc.DIT_3B),
              jloader.sniff_dit_config(state, JDIT_3B))
    _same_cfg(tl.sniff_dit_config(state, tc.DIT_3B), tc.small_test_config())
    tensors = []
    for name, v in state.items():
        if name == "blocks.0.attn.proj_qkv.vid.weight":
            tensors.append((name, v.shape, tg.Q8_0, _q8_0_bytes(v), None))
        else:
            tensors.append((name, v.shape, tg.F32, v.tobytes(), None))
    path = str(tmp_path / "tiny-Q8_0.gguf")
    write_gguf(path, tensors)
    raw = tg.load_gguf_state_dict(path, keep_q8=True)
    assert tl.sniff_dit_config(raw, tc.DIT_3B) == tc.DIT_3B
    _, jcfg = _jax_load(path, "q8")
    assert jcfg == JDIT_3B
    with pytest.raises(RuntimeError, match="size mismatch|Missing key"):
        _port_load(path, "q8")


# ------------------------------------------------------------ the 7B family

@pytest.fixture(scope="module")
def tiny7b(tmp_path_factory):
    """A tiny 7B-family tree and the same weights as fp16 .safetensors (a
    rope buffer too), fp32 .pth, and the fp8-mixed layout of
    seedvr2_ema_7b_fp8_e4m3fn_mixed_block35_fp16 (the last block and every
    vector fp16, every other tensor fp8_e4m3fn), as the JAX package's
    tests/test_checkpoint_contract.py writes it."""
    import safetensors.torch

    jcfg = j_small("dit_7b")
    params = random_params(lambda k: jn.init_dit_params(
        k, jcfg, dtype=jnp.float32), 23)
    d = tmp_path_factory.mktemp("dit7b")
    state = jexport.to_torch_state_dict(params, dtype=np.float32)
    last = f"blocks.{jcfg.num_layers - 1}."
    files = {"st": str(d / "seedvr2_ema_7b_fp16.safetensors"),
             "pth": str(d / "seedvr2_ema_7b.pth"),
             "fp8_mixed": str(
                 d / "seedvr2_ema_7b_fp8_e4m3fn_mixed_block1_fp16.safetensors")}
    safetensors.torch.save_file(
        {k: torch.from_numpy(v).half() for k, v in {
            **state, "blocks.0.attn.rope.freqs": np.arange(
                8, dtype=np.float32)}.items()}, files["st"])
    torch.save({k: torch.from_numpy(v) for k, v in state.items()},
               files["pth"])
    safetensors.torch.save_file(
        {k: (torch.from_numpy(v).half() if k.startswith(last) or v.ndim < 2
             else torch.from_numpy(v).to(torch.float8_e4m3fn))
         for k, v in state.items()}, files["fp8_mixed"])
    return params, files


@pytest.mark.parametrize("fmt", ["st", "fp8_mixed", "pth"])
def test_7b_float_file_loads_and_forwards_as_jax(tiny7b, fmt):
    """Each 7B float format loads strictly into the 7B config JAX sniffs
    (fp8 widened per tensor, the fp16 block kept fp16-exact), equal to the
    JAX loader's tree bit for bit, and forwards as the JAX loader's model
    does."""
    _, files = tiny7b
    jparams, jcfg = _jax_load(files[fmt], "none")
    model = _port_load(files[fmt], "none")
    _same_cfg(model.cfg, jcfg)
    assert model.cfg.family == "dit_7b" and model.cfg.mlp_type == "normal"
    assert model.cfg == tc.small_test_config(family="dit_7b")
    assert_state_equal(model, jparams)
    out, ref = _forward_pair(model, jparams, jcfg)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def gguf_7b_file(tmp_path_factory):
    """A Q4_K_M-like file of a 1024-wide 7B (so the K-quant serving paths
    engage): Q8_0 attention linears (block 0's video qkv F32 so the config
    sniff reads it), Q4_K mlp proj_in, Q5_K mlp proj_out, F16 dense
    linears, F32 vectors (the MLP biases among them)."""
    cfg = j_small("dit_7b", **WIDE)  # plain MLP 1024 -> 4096 -> 1024
    params = random_params(lambda k: jn.init_dit_params(
        k, cfg, dtype=jnp.float32), 24)
    state = jexport.to_torch_state_dict(params, dtype=np.float32)
    tensors = []
    for i, (name, v) in enumerate(sorted(state.items())):
        if name == "blocks.0.attn.proj_qkv.vid.weight" or v.ndim == 1:
            qt, raw = tg.F32, v.tobytes()
        elif ".attn.proj_" in name:
            qt, raw = tg.Q8_0, _q8_0_bytes(v)
        elif ".mlp." in name:
            qt = tg.Q5_K if "proj_out" in name else tg.Q4_K
            raw = _kquant_bytes(qt, v.shape, i)
        else:
            qt, raw = tg.F16, v.astype(np.float16).tobytes()
        tensors.append(("model.diffusion_model." + name, v.shape, qt, raw,
                        None))
    path = tmp_path_factory.mktemp("gguf7b") / "seedvr2_wide_7b-Q4_K_M.gguf"
    write_gguf(path, tensors)
    return str(path)


@pytest.mark.parametrize("quant", ["none", "q8", "q4", "q4k"])
def test_7b_gguf_routes_match_jax(gguf_7b_file, quant):
    """The 7B GGUF under each --quant, exactly as the 3B's: dense (none),
    Q8_0 kept and the K-quants requantized to Q8_0 (q8, q4), native Q4_K /
    Q5_K as affine (q4k); the tree equal to the JAX loader's and the
    forward equal to the JAX loader's model's."""
    jparams, jcfg = _jax_load(gguf_7b_file, quant)
    model = _port_load(gguf_7b_file, quant)
    _same_cfg(model.cfg, jcfg)
    assert model.cfg.family == "dit_7b"
    assert_state_equal(model, jparams)
    qkv = model.blocks[1].attn.proj_qkv["vid"]
    mlp = model.blocks[1].mlp["txt"]
    want = {"none": (torch.nn.Linear, torch.nn.Linear),
            "q8": (Q8Linear, Q8Linear), "q4": (Q8Linear, Q8Linear),
            "q4k": (Q8Linear, AffineLinear)}[quant]
    assert (type(qkv), type(mlp.proj_in)) == want
    assert type(mlp.proj_out) is want[1] and mlp.proj_out.bias is not None
    out, ref = _forward_pair(model, jparams, jcfg, shape=(1, 6, 6))
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_7b_sniffing_matches_jax(tiny7b):
    """sniff_family reads the 7B off its key names (also of quantised
    leaves), the 3B stays 3B; sniff_dit_config gives JAX's 7B config
    (heads from qkv, expand_ratio from proj_in, rope_dim head_dim / 2, the
    sharing flags) and reads the upscaler off emb_scale keys."""
    params, _ = tiny7b
    state = jexport.to_torch_state_dict(params, dtype=np.float32)
    assert tl.sniff_family(state) == "dit_7b"
    assert tl.sniff_family({k: {"q8": None} for k in state}) == "dit_7b"
    three = jexport.to_torch_state_dict(random_params(
        lambda k: jn.init_dit_params(k, j_small(), dtype=jnp.float32), 1),
        dtype=np.float32)
    assert tl.sniff_family(three) == "dit_3b"
    _same_cfg(tl.sniff_dit_config(state, tc.DIT_7B),
              jloader.sniff_dit_config(state, JDIT_7B))
    assert tl.sniff_dit_config(state, tc.DIT_7B) == tc.small_test_config(
        family="dit_7b")
    up = dict(state, **{"emb_scale.proj_in.weight": np.zeros((64, 256),
                                                             np.float32)})
    _same_cfg(tl.sniff_dit_config(up, tc.DIT_7B),
              jloader.sniff_dit_config(up, JDIT_7B))
    assert tl.sniff_dit_config(up, tc.DIT_7B).upscaler


@pytest.mark.parametrize("fmt", ["safetensors", "gguf"])
def test_7b_under_a_neutral_name_loads_as_7b(tiny7b, tmp_path, fmt):
    """A 7B-shaped state under a name that says nothing of its family loads
    as the 7B (its structure decides, also with quantised linears), equal
    to what the JAX loader makes of the same file under a 7B name."""
    import shutil

    import safetensors.torch

    params, _ = tiny7b
    state = jexport.to_torch_state_dict(params, dtype=np.float32)
    path = str(tmp_path / f"dit.{fmt}")
    if fmt == "gguf":
        # the blocks' linears Q8_0 but block 0's video qkv, which the
        # config sniff reads, as in gguf_file
        write_gguf(path, [
            (k, v.shape, tg.Q8_0, _q8_0_bytes(v), None)
            if k.startswith("blocks.") and v.ndim == 2
            and k != "blocks.0.attn.proj_qkv.vid.weight"
            else (k, v.shape, tg.F32, v.tobytes(), None)
            for k, v in state.items()])
    else:
        safetensors.torch.save_file(
            {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in state.items()}, path)
    named = str(tmp_path / f"dit_7b.{fmt}")
    shutil.copy(path, named)
    jparams, jcfg = _jax_load(named, "q8")
    model = _port_load(path, "q8", min_dim=MIN_DIM)
    _same_cfg(model.cfg, jcfg)
    assert model.cfg.family == "dit_7b"
    if fmt == "gguf":
        assert_state_equal(model, jparams)


def test_cli_make_runner_takes_7b(tiny7b, tmp_path, monkeypatch):
    """cli.make_runner loads a 7B file, builds random weights of the family
    it is given (the 3B when none), and raises on a missing --dit_model
    file rather than drawing random weights."""
    from seedvr2_tpu_torch import cli

    _, files = tiny7b
    monkeypatch.setattr(cli, "VAE_V3", tc.VAEConfig(**VAE_KW))
    monkeypatch.setattr(cli, "DIT_3B", tc.small_test_config())
    runner = cli.make_runner("cpu", dit_model=files["st"])
    assert runner.dit_cfg == tc.small_test_config(family="dit_7b")
    small7 = tc.small_test_config(family="dit_7b")
    runner = cli.make_runner("cpu", seed=0, dit_cfg=small7, quant="w8a8")
    assert runner.dit_cfg == small7 and runner.config.dit == small7
    assert cli.make_runner("cpu", seed=0).dit_cfg == tc.small_test_config()
    with pytest.raises(FileNotFoundError):
        cli.make_runner("cpu", dit_model=str(tmp_path / "seedvr2_ema_7b_"
                                             "fp16.safetensors"))


def test_model_registry_equal():
    assert treg.MODEL_REGISTRY.keys() == jreg.MODEL_REGISTRY.keys()
    for k, v in treg.MODEL_REGISTRY.items():
        assert dataclasses.asdict(v) == dataclasses.asdict(
            jreg.MODEL_REGISTRY[k])
    assert (treg.DEFAULT_DIT, treg.DEFAULT_VAE) == (jreg.DEFAULT_DIT,
                                                    jreg.DEFAULT_VAE)
    for cat in ("dit", "vae"):
        assert treg.get_available_models(cat) == jreg.get_available_models(cat)


# ------------------------------------------------------------------ VAE


@pytest.fixture(scope="module")
def vae_state():
    cfg = JVAEConfig(**VAE_KW)
    params = random_params(lambda k: init_vae_params(k, cfg,
                                                     dtype=jnp.float32), 13)
    return jexport.to_torch_state_dict(params, dtype=np.float32)


def _deprecated_layout(state, two_d_convs: bool):
    """`model.` prefix, query/key/value/proj_attn names, (C, C, 1, 1)
    attention projections; with two_d_convs every 3D conv stored 2D (its
    last temporal tap)."""
    names = {"to_q": "query", "to_k": "key", "to_v": "value",
             "to_out.0": "proj_attn"}
    out = {}
    for k, v in state.items():
        for new, old in names.items():
            if f".{new}." in k:
                k = k.replace(f".{new}.", f".{old}.")
                if v.ndim == 2:
                    v = v[:, :, None, None]
        if two_d_convs and v.ndim == 5:
            v = np.ascontiguousarray(v[:, :, -1])
        out["model." + k] = v
    return out


@pytest.mark.parametrize("two_d", [False, True], ids=["3d", "2d_convs"])
def test_vae_deprecated_layout_loads_as_in_jax(vae_state, tmp_path, two_d):
    """The VAE file in the deprecated layout: the JAX load_vae_checkpoint
    and the port's sniff the same config and give the same weights (2D
    convs inflated in tail mode: zero taps but the last)."""
    import safetensors.numpy

    path = str(tmp_path / "vae.safetensors")
    safetensors.numpy.save_file(_deprecated_layout(vae_state, two_d), path)
    jparams, jcfg = jmm.load_vae_checkpoint(path, dtype=jnp.float32)
    model = tl.load_vae_checkpoint(path, "cpu", torch.float32)
    _same_cfg(model.cfg, jcfg)
    assert_state_equal(model, jparams)
    w = model.state_dict()["encoder.conv_in.weight"]
    if two_d:
        assert w[:, :, :-1].abs().max() == 0
    np.testing.assert_array_equal(w[:, :, -1].numpy(),
                                  vae_state["encoder.conv_in.weight"][:, :, -1])


def test_vae_load_is_strict(vae_state, tmp_path):
    """After the fixups every key must match: a VAE file with a key the
    model lacks raises, as a missing one does."""
    import safetensors.numpy

    state = _deprecated_layout(vae_state, False)
    for bad, msg in (
            (dict(state, **{"model.encoder.extra.bias": np.zeros(
                2, np.float32)}), "Unexpected key"),
            ({k: v for k, v in state.items()
              if k != "model.decoder.conv_out.bias"}, "Missing key")):
        path = str(tmp_path / "vae_bad.safetensors")
        safetensors.numpy.save_file(bad, path)
        with pytest.raises(RuntimeError, match=msg):
            tl.load_vae_checkpoint(path, "cpu", torch.float32)


def test_inflation_and_template_equal(vae_state):
    cfg_j = JVAEConfig(**VAE_KW)
    cfg_t = tc.VAEConfig(**VAE_KW)
    assert tl.vae_template_shapes(cfg_t) == jloader.vae_template_shapes(cfg_j)
    two_d = {k[len("model."):]: v for k, v in
             _deprecated_layout(vae_state, True).items()
             if ".query." not in k and ".key." not in k
             and ".value." not in k and ".proj_attn." not in k}
    two_d["aux.head.weight"] = np.ones((2, 2, 3, 3), np.float32)
    with pytest.warns(UserWarning, match="no counterpart"):
        ours = tl.inflate_vae_2d_convs(two_d, cfg_t)
    with pytest.warns(UserWarning, match="no counterpart"):
        ref = jloader.inflate_vae_2d_convs(two_d, cfg_j, mode="tail")
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(np.asarray(ours[k]), ref[k], err_msg=k)
    bad = dict(two_d, **{"encoder.conv_in.weight": np.ones((3, 3, 3, 3),
                                                           np.float32)})
    with pytest.raises(ValueError, match="cannot inflate"):
        tl.inflate_vae_2d_convs(bad, cfg_t)
