"""The port's GGUF reader (seedvr2_tpu_torch.ops.gguf) against the JAX
package's on synthetic files written by a helper here: the block
dequantizers, the container parser, the Q8_0 and native K-quant serving
layouts (the port's (N, K) = the JAX (K, N) transposed), the host
requantization of K-quants under keep_q8, `comfy.gguf.orig_shape` metadata
and the `model.diffusion_model.` prefix strip. Everything is exact: both
sides run the same numpy arithmetic."""

import struct

import numpy as np
import pytest

from seedvr2_tpu.ops import gguf as jg
from seedvr2_tpu_torch.ops import gguf as tg

# byte offsets of the f16 scale fields of a block, per type
_F16_FIELDS = {tg.Q8_0: [0], tg.Q4_0: [0], tg.Q4_1: [0, 2], tg.Q5_0: [0],
               tg.Q5_1: [0, 2], tg.Q4_K: [0, 2], tg.Q5_K: [0, 2],
               tg.Q6_K: [208], tg.Q2_K: [80, 82], tg.Q3_K: [108]}


def make_blocks(qtype, n_blocks, seed):
    """Random blocks of `qtype` with finite f16 scale fields."""
    size, _ = tg.BLOCK_SIZES[qtype]
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 256, (n_blocks, size), dtype=np.uint8)
    d = rng.uniform(-2, 2, (n_blocks, len(_F16_FIELDS[qtype]))).astype(
        np.float16)
    for i, off in enumerate(_F16_FIELDS[qtype]):
        blocks[:, off:off + 2] = d[:, i:i + 1].view(np.uint8)
    return blocks


def payload(qtype, shape, seed):
    """Raw bytes of a tensor of torch `shape` stored as `qtype`."""
    n = int(np.prod(shape))
    rng = np.random.default_rng(seed)
    if qtype == tg.F32:
        return rng.standard_normal(n).astype(np.float32).tobytes()
    if qtype == tg.F16:
        return rng.standard_normal(n).astype(np.float16).tobytes()
    if qtype == tg.BF16:
        f = rng.standard_normal(n).astype(np.float32)
        return (f.view(np.uint32) >> 16).astype(np.uint16).tobytes()
    return make_blocks(qtype, n // tg.BLOCK_SIZES[qtype][1], seed).tobytes()


def write_gguf(path, tensors, meta=()):
    """A GGUF v3 file: tensors [(name, torch shape, type, raw bytes,
    stored dims or None)], metadata [(key, uint32 list)] as arrays."""
    def s(b):
        return struct.pack("<Q", len(b)) + b

    with open(path, "wb") as f:
        f.write(b"GGUF" + struct.pack("<IQQ", 3, len(tensors), 1 + len(meta)))
        f.write(s(b"general.alignment") + struct.pack("<II", 4, 32))
        for key, vals in meta:
            f.write(s(key.encode()) + struct.pack("<IIQ", 9, 4, len(vals)))
            f.write(struct.pack(f"<{len(vals)}I", *vals))
        offset = 0
        for name, shape, qtype, raw, dims in tensors:
            dims = dims or tuple(reversed(shape))
            f.write(s(name.encode()) + struct.pack("<I", len(dims)))
            f.write(struct.pack(f"<{len(dims)}Q", *dims))
            f.write(struct.pack("<IQ", qtype, offset))
            offset += len(raw) + (-len(raw)) % 32
        f.write(b"\0" * ((-f.tell()) % 32))
        for *_, raw, _ in tensors:
            f.write(raw + b"\0" * ((-len(raw)) % 32))


def _transposed(v):
    """A JAX serving-layout leaf in the port's (N, K) order."""
    if isinstance(v, dict):
        return {k: np.ascontiguousarray(a.T) for k, a in v.items()}
    return v


def assert_same(ours, jax_side):
    assert ours.keys() == jax_side.keys()
    for k, v in ours.items():
        ref = _transposed(jax_side[k])
        if isinstance(v, dict):
            assert v.keys() == ref.keys(), k
            for part in v:
                assert v[part].dtype == ref[part].dtype, (k, part)
                np.testing.assert_array_equal(v[part], ref[part])
        else:
            assert v.dtype == ref.dtype and v.shape == ref.shape, k
            np.testing.assert_array_equal(v, ref)


@pytest.mark.parametrize("qtype", [tg.Q8_0, tg.Q4_0, tg.Q4_1, tg.Q5_0,
                                   tg.Q5_1, tg.Q2_K, tg.Q3_K, tg.Q4_K,
                                   tg.Q5_K, tg.Q6_K])
def test_block_dequantizers_equal(qtype):
    blocks = make_blocks(qtype, 8, seed=qtype)
    n = 8 * tg.BLOCK_SIZES[qtype][1]
    np.testing.assert_array_equal(tg.dequantize(blocks.reshape(-1), qtype, n),
                                  jg._DEQUANT[qtype](blocks).reshape(-1))


# (K, N) of the test linear: K % 256 == 0 and min >= 1024, so the K-quant
# serving paths engage
K, N = 1024, 1280


@pytest.fixture(scope="module")
def mixed_file(tmp_path_factory):
    """One file of every dense and quantised type the published checkpoints
    use, large linears and small tensors, prefixed as ComfyUI writes them,
    plus an unprefixed tensor (dropped) and a flattened one with
    comfy.gguf.orig_shape metadata."""
    p = "model.diffusion_model."
    tensors = [
        (p + "a.f32", (64, 32), tg.F32, payload(tg.F32, (64, 32), 1), None),
        (p + "a.f16", (96,), tg.F16, payload(tg.F16, (96,), 2), None),
        (p + "a.bf16", (8, 64), tg.BF16, payload(tg.BF16, (8, 64), 3), None),
        (p + "q8.big", (N, K), tg.Q8_0, payload(tg.Q8_0, (N, K), 4), None),
        (p + "q8.small", (40, 64), tg.Q8_0, payload(tg.Q8_0, (40, 64), 5),
         None),
        (p + "q4k.big", (N, K), tg.Q4_K, payload(tg.Q4_K, (N, K), 6), None),
        (p + "q5k.big", (N, K), tg.Q5_K, payload(tg.Q5_K, (N, K), 7), None),
        (p + "q6k.big", (N, K), tg.Q6_K, payload(tg.Q6_K, (N, K), 8), None),
        (p + "q4k.small", (64, 256), tg.Q4_K, payload(tg.Q4_K, (64, 256), 9),
         None),
        (p + "conv", (8, 4, 2, 2, 2), tg.F16,
         payload(tg.F16, (8, 4, 2, 2, 2), 10), (256,)),
        ("stray.weight", (4, 4), tg.F32, payload(tg.F32, (4, 4), 11), None),
    ]
    path = tmp_path_factory.mktemp("gguf") / "mixed.gguf"
    write_gguf(path, tensors,
               meta=[(f"comfy.gguf.orig_shape.{p}conv", [8, 4, 2, 2, 2])])
    return str(path)


@pytest.mark.parametrize("keep_q8,native", [(False, False), (True, False),
                                            (True, True)],
                         ids=["dense", "keep_q8", "native_kquants"])
def test_read_gguf_equal(mixed_file, keep_q8, native):
    """read_gguf: every tensor equal to the JAX reader's (serving layouts
    transposed once), the type ids and the metadata too. Under keep_q8 the
    Q8_0 tensors keep their bytes (f16 scales widened to fp32) and the large
    K-quant linears requantize to Q8_0 on the host; under native_kquants the
    large Q4_K/Q5_K ones keep their affine form, Q6_K still requantizes."""
    ours, oq, om = tg.read_gguf(mixed_file, keep_q8=keep_q8,
                                native_kquants=native)
    ref, rq, rm = jg.read_gguf(mixed_file, keep_q8=keep_q8,
                               native_kquants=native)
    assert oq == rq and om == rm
    assert_same(ours, ref)
    p = "model.diffusion_model."
    big = {k: v for k, v in ours.items() if k.endswith(".big")}
    if not keep_q8:
        assert all(not isinstance(v, dict) for v in ours.values())
        return
    assert set(big[p + "q8.big"]) == {"q8", "scales"}
    assert big[p + "q8.big"]["q8"].shape == (N, K)
    assert big[p + "q8.big"]["scales"].shape == (N, K // 32)
    assert set(ours[p + "q8.small"]) == {"q8", "scales"}
    assert not isinstance(ours[p + "q4k.small"], dict)
    assert set(big[p + "q6k.big"]) == {"q8", "scales"}
    for name in ("q4k.big", "q5k.big"):
        want = {"qa", "s", "m"} if native else {"q8", "scales"}
        assert set(big[p + name]) == want


def test_native_kquants_reconstruct_exactly(mixed_file):
    """The affine form qa * s - m reproduces the full dequantization bit for
    bit (no requantization error), with quants in [0, 15] (Q4_K) and [0, 31]
    (Q5_K)."""
    dense = tg.read_gguf(mixed_file)[0]
    kept = tg.read_gguf(mixed_file, keep_q8=True, native_kquants=True)[0]
    p = "model.diffusion_model."
    for name, top in (("q4k.big", 15), ("q5k.big", 31)):
        v = kept[p + name]
        assert v["qa"].dtype == np.int8 and v["qa"].min() >= 0
        assert v["qa"].max() <= top
        recon = (v["qa"].reshape(N, K // 32, 32).astype(np.float32)
                 * v["s"][:, :, None] - v["m"][:, :, None]).reshape(N, K)
        np.testing.assert_array_equal(recon, dense[p + name])


def test_load_state_dict_strips_prefix_and_reads_orig_shape(mixed_file):
    """load_gguf_state_dict: the `model.diffusion_model.` prefix is stripped
    and the unprefixed tensor dropped, as in the JAX loader; a flattened
    tensor comes back in its comfy.gguf.orig_shape."""
    ours = tg.load_gguf_state_dict(mixed_file, keep_q8=True)
    ref = jg.load_gguf_state_dict(mixed_file, keep_q8=True)
    assert_same(ours, ref)
    assert "stray.weight" not in ours and "q8.big" in ours
    assert ours["conv"].shape == (8, 4, 2, 2, 2)
    bad = mixed_file.replace("mixed", "bad")
    write_gguf(bad, [("w", (4, 4), tg.F32, payload(tg.F32, (4, 4), 0),
                      None)], meta=[("comfy.gguf.orig_shape.w", [3, 4])])
    with pytest.raises(ValueError, match="orig_shape"):
        tg.read_gguf(bad)
