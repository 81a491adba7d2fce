"""The port's host library (seedvr2_tpu_torch/csrc/host/seedvr2_native.cpp,
ops/native.py), built here with g++: the Q8_0 / Q4_K / Q6_K dequantizers
bit-equal to the port's numpy plain versions (ops/gguf.py `_deq_*`) and to
the JAX package's `dequantize`, whatever the thread count; the two frame
converters equal to seedvr2_tpu.ops.native's; a small GGUF file read
through the library and through the plain versions; and a build that
fails raising with the compiler's output instead of falling back. Every
comparison is exact: the flags (-O3 -ffp-contract=off, no -march) keep
each value's roundings those of numpy."""

import numpy as np
import pytest

from seedvr2_tpu.ops import gguf as jg
from seedvr2_tpu.ops import native as jnative
from seedvr2_tpu_torch.ops import gguf as tg
from seedvr2_tpu_torch.ops import native

from .test_torch_gguf import make_blocks, payload, write_gguf

TYPES = [tg.Q8_0, tg.Q4_K, tg.Q6_K]


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def special_scales(qtype, n_blocks, seed):
    """Blocks whose f16 scale fields take zero, -0, subnormal, the largest
    and tiny normal values, so half_to_float's branches all run."""
    blocks = make_blocks(qtype, n_blocks, seed)
    vals = np.array([0.0, -0.0, 6e-8, -3e-6, 6.1e-5, 65504.0, -1.5, 1e-4],
                    np.float16)
    for off in _f16_fields(qtype):
        d = vals[np.arange(n_blocks) % len(vals)]
        blocks[:, off:off + 2] = d.view(np.uint8).reshape(n_blocks, 2)
    return blocks


def _f16_fields(qtype):
    return {tg.Q8_0: [0], tg.Q4_K: [0, 2], tg.Q6_K: [208]}[qtype]


def test_library_builds_in_build_dir():
    lib = native.library()
    assert "/build/torch_kernels/host/libseedvr2_native_" in lib._name
    assert "-ffp-contract=off" in native.GXX_FLAGS
    assert native.library() is lib  # built once a process


@pytest.mark.parametrize("qtype", TYPES, ids=["q8_0", "q4_k", "q6_k"])
@pytest.mark.parametrize("special", [False, True], ids=["random", "special"])
def test_dequant_bit_equal_to_numpy_and_jax(qtype, special):
    """3000 blocks (several threads) bit-equal to the numpy plain version
    and to the JAX package's dequantize; the same blocks in pieces of 200
    (one thread each) give the same bits."""
    n = 3000
    blocks = (special_scales if special else make_blocks)(qtype, n,
                                                          qtype + 40)
    got = native.dequantize_blocks(blocks, qtype)
    plain = tg._DEQUANT[qtype](blocks)
    np.testing.assert_array_equal(_bits(got), _bits(plain))
    elems = tg.BLOCK_SIZES[qtype][1]
    ref = jg.dequantize(blocks.reshape(-1), qtype, n * elems)
    np.testing.assert_array_equal(_bits(got.reshape(-1)), _bits(ref))
    pieces = np.concatenate([native.dequantize_blocks(blocks[i:i + 200],
                                                      qtype)
                             for i in range(0, n, 200)])
    np.testing.assert_array_equal(_bits(pieces), _bits(got))
    # the module's entry point takes the library, plain=True the numpy path
    flat = tg.dequantize(blocks.reshape(-1), qtype, n * elems)
    np.testing.assert_array_equal(_bits(flat), _bits(got.reshape(-1)))
    np.testing.assert_array_equal(
        _bits(tg.dequantize(blocks.reshape(-1), qtype, n * elems,
                            plain=True)), _bits(flat))


def test_dequant_refuses_wrong_block_width():
    with pytest.raises(ValueError, match="expected"):
        native.dequantize_blocks(np.zeros((4, 33), np.uint8), tg.Q8_0)
    with pytest.raises(KeyError):
        native.dequantize_blocks(np.zeros((4, 18), np.uint8), tg.Q4_0)


@pytest.mark.parametrize("channels,swap", [(3, False), (3, True), (4, True),
                                           (1, True)])
def test_frame_converters_equal_jax(channels, swap):
    """uint8 -> float32 and back equal to the JAX package's converters
    (its host library here; its numpy fallback rounds x / 255 where the
    library multiplies by 1 / 255, so without it the floats may differ by
    an ulp), with the channel swap; out-of-range floats clamp."""
    rng = np.random.default_rng(channels + swap)
    u8 = rng.integers(0, 256, (3, 17, 23, channels), dtype=np.uint8)
    f = native.frames_to_float(u8, swap_rb=swap)
    ref = jnative.frames_to_float(u8, swap_rb=swap)
    if jnative.available():
        np.testing.assert_array_equal(_bits(f), _bits(ref))
    else:
        np.testing.assert_allclose(f, ref, rtol=2 ** -23, atol=0)
    back = native.frames_to_uint8(f, swap_rb=swap)
    np.testing.assert_array_equal(back, u8)
    wide = (rng.standard_normal((2, 9, 11, channels)) * 0.8 + 0.5).astype(
        np.float32)
    np.testing.assert_array_equal(native.frames_to_uint8(wide, swap),
                                  jnative.frames_to_uint8(wide, swap))


def test_gguf_file_read_both_ways(tmp_path, monkeypatch):
    """A file of Q8_0 / Q4_K / Q6_K / F16 tensors read through the host
    library equals the same file read through the numpy plain versions and
    the JAX reader, dense and under keep_q8 (whose host requantization of
    the K-quants starts from these dequantized values)."""
    p = "model.diffusion_model."
    shapes = {"q8.big": (64, 1024), "q4k.big": (1024, 1024),
              "q6k.big": (1024, 1024), "q6k.small": (8, 256),
              "f16.vec": (1024,)}
    types = {"q8": tg.Q8_0, "q4k": tg.Q4_K, "q6k": tg.Q6_K, "f16": tg.F16}
    tensors = [(p + name, shape, types[name.split(".")[0]],
                payload(types[name.split(".")[0]], shape, i), None)
               for i, (name, shape) in enumerate(shapes.items())]
    path = str(tmp_path / "three.gguf")
    write_gguf(path, tensors)
    for keep_q8 in (False, True):
        ours = tg.read_gguf(path, keep_q8=keep_q8)[0]
        ref = jg.read_gguf(path, keep_q8=keep_q8)[0]
        plain = tg.dequantize
        monkeypatch.setattr(tg, "dequantize", lambda *a: plain(*a,
                                                              plain=True))
        slow = tg.read_gguf(path, keep_q8=keep_q8)[0]
        monkeypatch.setattr(tg, "dequantize", plain)
        assert ours.keys() == slow.keys() == ref.keys()
        for k in ours:
            if isinstance(ours[k], dict):
                for leaf in ours[k]:
                    np.testing.assert_array_equal(ours[k][leaf],
                                                  slow[k][leaf])
                    np.testing.assert_array_equal(ours[k][leaf],
                                                  ref[k][leaf].T)
            else:
                np.testing.assert_array_equal(_bits(ours[k]),
                                              _bits(slow[k]))
                np.testing.assert_array_equal(_bits(ours[k]), _bits(ref[k]))
        assert isinstance(ours[p + "q6k.big"], dict) == keep_q8


def test_failed_build_raises_instead_of_falling_back(tmp_path, monkeypatch):
    """A source that does not compile, or no compiler at all: the call
    raises with the compiler's output, and GGUF dequantization raises
    too; nothing falls back to numpy."""
    bad = tmp_path / "broken.cpp"
    bad.write_text('extern "C" void dequant_q8_0( { this is not C++ }\n')
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "host")
    monkeypatch.setattr(native, "_lib", None)
    blocks = make_blocks(tg.Q8_0, 4, 0)
    with pytest.raises(RuntimeError, match="build failed") as err:
        native.dequantize_blocks(blocks, tg.Q8_0)
    assert "error" in str(err.value)
    with pytest.raises(RuntimeError, match="build failed"):
        tg.dequantize(blocks.reshape(-1), tg.Q8_0, 4 * 32)
    assert not list((tmp_path / "host").glob("*.so"))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot run"):
        native.frames_to_float(np.zeros((1, 2, 2, 3), np.uint8))


def test_port_sources_name_no_jax_and_read_no_native_dir():
    """No module of seedvr2_tpu_torch, and not chip_smoke.py, imports jax
    or the JAX package (its name appears in strings only, as the
    reference a comment or a record names), and no string of theirs points
    at the JAX package's native/ directory: the host library is the
    port's own csrc/host copy."""
    import ast
    import re
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    files = sorted((root / "seedvr2_tpu_torch").rglob("*.py")) + [
        root / "chip_smoke.py"]
    assert len(files) > 35
    bad = []
    for path in files:
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "seedvr2_tpu"):
                    bad.append((path.name, node.lineno, name))
            if isinstance(node, ast.Constant) and isinstance(node.value,
                                                             str):
                if re.search(r"(^|[^\w])native/", node.value):
                    bad.append((path.name, node.lineno, node.value[:60]))
    assert not bad
    for src in (root / "seedvr2_tpu_torch" / "csrc").rglob("*"):
        if src.suffix in (".cpp", ".cu", ".cuh"):
            assert not re.search(r"(^|[^\w])native/", src.read_text())
