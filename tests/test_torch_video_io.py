"""The port's video / image IO (seedvr2_tpu_torch.utils.video_io) against
the JAX package's on the CPU with OpenCV: images of every kind read
bit-equal, writes read back equal, VideoReader's fields and chunked reads,
VideoWriter's files, directories, the input kinds; and the port's .npy
reader and writer (skip, cap, remaining, memory maps). Frames are uint8
steps / 255 wherever a codec is lossless, so equality is exact."""

import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from seedvr2_tpu.utils import video_io as jvio  # noqa: E402
from seedvr2_tpu_torch.utils import video_io as tvio  # noqa: E402


def _u8(rng, *shape):
    return rng.integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("kind", ["rgb", "rgba", "gray", "jpg"])
def test_read_image_bit_equal(tmp_path, kind):
    rng = np.random.default_rng(1)
    img = {"rgb": _u8(rng, 20, 24, 3), "rgba": _u8(rng, 20, 24, 4),
           "gray": _u8(rng, 20, 24), "jpg": _u8(rng, 20, 24, 3)}[kind]
    path = str(tmp_path / ("x.jpg" if kind == "jpg" else "x.png"))
    assert cv2.imwrite(path, img)
    out = tvio.read_image(path)
    ref = jvio.read_image(path)
    assert out.dtype == ref.dtype == np.float32
    assert out.shape == ref.shape == (1, 20, 24, 4 if kind == "rgba" else 3)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("channels", [3, 4])
def test_write_image_reads_back_equal(tmp_path, channels):
    frame = np.random.default_rng(2).uniform(
        0, 1, (18, 22, channels)).astype(np.float32)
    a, b = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    tvio.write_image(a, frame)
    jvio.write_image(b, frame)
    back = tvio.read_image(a)
    np.testing.assert_array_equal(back, jvio.read_image(b))
    assert back.shape == (1, 18, 22, channels)
    # the writer truncates to uint8 as JAX's does
    np.testing.assert_array_equal(
        back[0], np.clip(frame * 255.0, 0, 255).astype(np.uint8).astype(
            np.float32) / 255.0)


def _write_mp4(path, frames_u8, fps=12.0):
    h, w = frames_u8.shape[1:3]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
    for f in frames_u8:
        writer.write(f)
    writer.release()


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = tmp_path_factory.mktemp("video") / "clip.mp4"
    _write_mp4(path, _u8(np.random.default_rng(3), 11, 32, 48, 3))
    return str(path)


@pytest.mark.parametrize("skip,cap,chunk", [
    (0, 0, 4), (2, 0, 3), (0, 5, 2), (3, 6, 4), (12, 0, 4)])
def test_video_reader_fields_and_chunks_equal(clip, skip, cap, chunk):
    t, j = tvio.VideoReader(clip, skip, cap), jvio.VideoReader(clip, skip, cap)
    try:
        for name in ("fps", "total", "width", "height", "remaining"):
            assert getattr(t, name) == getattr(j, name), name
        assert (t.total, t.width, t.height, t.fps) == (11, 48, 32, 12.0)
        while True:
            a, b = t.read_frames(chunk), j.read_frames(chunk)
            np.testing.assert_array_equal(a, b)
            assert t.remaining == j.remaining
            if a.shape[0] == 0:
                break
    finally:
        t.close()
        j.close()


def test_video_writer_files_read_back_equal(tmp_path):
    frames = np.random.default_rng(4).uniform(
        0, 1, (6, 32, 48, 4)).astype(np.float32)
    for mod, name in ((tvio, "port.mp4"), (jvio, "jax.mp4")):
        w = mod.VideoWriter(str(tmp_path / name), 24.0, (32, 48))
        w.write_frames(frames[:4])
        w.write_frames(frames[4:])
        w.close()
    t = tvio.VideoReader(str(tmp_path / "port.mp4"))
    j = jvio.VideoReader(str(tmp_path / "jax.mp4"))
    assert (t.total, t.fps, t.height, t.width) == (j.total, j.fps, j.height,
                                                   j.width) == (6, 24.0, 32,
                                                                48)
    np.testing.assert_array_equal(t.read_frames(6), j.read_frames(6))
    t.close()
    j.close()


def test_read_directory_equal_on_mixed_channels(tmp_path):
    rng = np.random.default_rng(5)
    for i, c in enumerate((3, 4, 3, 4)):
        cv2.imwrite(str(tmp_path / f"f_{3 - i:02d}.png"), _u8(rng, 10, 12, c))
    (tmp_path / "notes.txt").write_text("not a frame")
    out = tvio.read_directory(str(tmp_path))
    np.testing.assert_array_equal(out, jvio.read_directory(str(tmp_path)))
    assert out.shape == (4, 10, 12, 3)  # cut to the fewest channels


def test_read_directory_without_images_raises(tmp_path):
    (tmp_path / "a.txt").write_text("x")
    with pytest.raises(IOError, match="no images"):
        tvio.read_directory(str(tmp_path))
    with pytest.raises(IOError, match="no images"):
        jvio.read_directory(str(tmp_path))


@pytest.mark.parametrize("ext", sorted(jvio.VIDEO_EXTS | jvio.IMAGE_EXTS
                                       | {".PNG", ".Mp4", ".txt"}))
def test_detect_input_type_agrees(tmp_path, ext):
    path = str(tmp_path / f"x{ext}")
    try:
        ref = jvio.detect_input_type(path)
    except ValueError:
        with pytest.raises(ValueError):
            tvio.detect_input_type(path)
        return
    assert tvio.detect_input_type(path) == ref


def test_detect_input_type_directory_and_array(tmp_path):
    assert tvio.detect_input_type(str(tmp_path)) == jvio.detect_input_type(
        str(tmp_path)) == "directory"
    # the port's own .npy input, which JAX's CLI does not take
    assert tvio.detect_input_type(str(tmp_path / "x.npy")) == "array"
    with pytest.raises(ValueError):
        jvio.detect_input_type(str(tmp_path / "x.npy"))


@pytest.mark.parametrize("skip,cap,chunk", [
    (0, 0, 4), (2, 0, 3), (0, 5, 2), (3, 6, 4), (11, 0, 4), (14, 3, 2)])
def test_array_reader_skip_cap_and_chunks(tmp_path, skip, cap, chunk):
    frames = np.random.default_rng(6).uniform(
        0, 1, (11, 6, 8, 4)).astype(np.float16)
    path = str(tmp_path / "in.npy")
    np.save(path, frames)
    r = tvio.ArrayReader(path, skip, cap)
    assert isinstance(r.frames, np.memmap)
    assert (r.total, r.height, r.width, r.fps) == (11, 6, 8, 30.0)
    want = frames[skip:][:cap or None].astype(np.float32)
    assert r.remaining == (min(11 - skip, cap) if cap else 11 - skip)
    got = []
    while r.remaining > 0:
        got.append(r.read_frames(chunk))
        assert got[-1].dtype == np.float32
    assert r.read_frames(chunk).shape[0] == 0
    out = np.concatenate(got) if got else np.zeros((0, 6, 8, 4), np.float32)
    np.testing.assert_array_equal(out, want)
    r.close()


def test_array_reader_single_frame_and_bad_rank(tmp_path):
    img = np.random.default_rng(7).uniform(0, 1, (6, 8, 3)).astype(np.float32)
    np.save(tmp_path / "one.npy", img)
    r = tvio.ArrayReader(str(tmp_path / "one.npy"))
    assert (r.total, r.remaining) == (1, 1)
    np.testing.assert_array_equal(r.read_frames(5), img[None])
    np.save(tmp_path / "bad.npy", np.zeros((2, 3), np.float32))
    with pytest.raises(ValueError, match="frames must be"):
        tvio.ArrayReader(str(tmp_path / "bad.npy"))


def test_array_writer_memory_mapped_and_counted(tmp_path):
    rng = np.random.default_rng(8)
    frames = rng.uniform(0, 1, (7, 5, 6, 4)).astype(np.float32)
    path = str(tmp_path / "sub" / "out.npy")
    w = tvio.ArrayWriter(path, 7, (5, 6, 4))
    assert isinstance(w.out, np.memmap)
    w.write_frames(frames[:3])
    w.write_frames(frames[3:])
    with pytest.raises(ValueError, match="8 frames written"):
        w.write_frames(frames[:1])
    w.close()
    np.testing.assert_array_equal(np.load(path), frames)
    short = tvio.ArrayWriter(str(tmp_path / "short.npy"), 3, (5, 6, 4))
    short.write_frames(frames[:2])
    with pytest.raises(ValueError, match="2 of 3 frames"):
        short.close()
    assert os.path.isfile(tmp_path / "short.npy")
