"""Host-side video / image IO, feeding the port's pipeline.

Port of seedvr2_tpu.utils.video_io: RGB float32 [0, 1] THWC frames,
streaming reads with skip and cap, incremental mp4v writes, PNG round trips
with alpha, directories of frames. OpenCV is imported as the JAX package
imports it; a video, image or directory path used without it raises an
ImportError that names OpenCV. BGR <-> RGB and uint8 <-> float go through
the port's host library (ops/native.py), as in JAX.

The port adds the `.npy` array input (`"array"`): (T, H, W, C) float frames
in [0, 1], or one (H, W, C) frame. `ArrayReader` has VideoReader's
interface over a memory-mapped np.load (fps 30), and `ArrayWriter`
VideoWriter's over np.lib.format.open_memmap, so a chunked run never holds
the whole array in memory. It needs no OpenCV.
"""

import os
from typing import List, Tuple

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

VIDEO_EXTS = {".mp4", ".avi", ".mov", ".mkv", ".webm", ".m4v"}
IMAGE_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".webp", ".tiff"}
ARRAY_EXTS = {".npy"}
ARRAY_FPS = 30.0


def _cv2():
    if cv2 is None:
        raise ImportError("video and image IO needs OpenCV (cv2), which is "
                          "not installed; give the frames as a .npy array")
    return cv2


def detect_input_type(path: str) -> str:
    if os.path.isdir(path):
        return "directory"
    ext = os.path.splitext(path)[1].lower()
    if ext in VIDEO_EXTS:
        return "video"
    if ext in IMAGE_EXTS:
        return "image"
    if ext in ARRAY_EXTS:
        return "array"
    raise ValueError(f"unsupported input: {path}")


def read_image(path: str) -> np.ndarray:
    """-> (1, H, W, C) float32 [0,1], C=3 or 4 (alpha preserved)."""
    cv = _cv2()
    img = cv.imread(path, cv.IMREAD_UNCHANGED)
    if img is None:
        raise IOError(f"cannot read image: {path}")
    if img.ndim == 2:
        img = cv.cvtColor(img, cv.COLOR_GRAY2RGB)
    elif img.shape[2] == 4:
        img = cv.cvtColor(img, cv.COLOR_BGRA2RGBA)
    else:
        img = cv.cvtColor(img, cv.COLOR_BGR2RGB)
    return (img.astype(np.float32) / 255.0)[None]


def write_image(path: str, frame: np.ndarray):
    """frame: (H, W, C) float32 [0,1]."""
    cv = _cv2()
    img = np.clip(frame * 255.0, 0, 255).astype(np.uint8)
    if img.shape[2] == 4:
        img = cv.cvtColor(img, cv.COLOR_RGBA2BGRA)
    else:
        img = cv.cvtColor(img, cv.COLOR_RGB2BGR)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if not cv.imwrite(path, img):
        raise IOError(f"cannot write image: {path}")


class VideoReader:
    def __init__(self, path: str, skip_first_frames: int = 0,
                 load_cap: int = 0):
        cv = _cv2()
        self.cap = cv.VideoCapture(path)
        if not self.cap.isOpened():
            raise IOError(f"cannot open video: {path}")
        self.fps = self.cap.get(cv.CAP_PROP_FPS) or 30.0
        self.total = int(self.cap.get(cv.CAP_PROP_FRAME_COUNT))
        self.width = int(self.cap.get(cv.CAP_PROP_FRAME_WIDTH))
        self.height = int(self.cap.get(cv.CAP_PROP_FRAME_HEIGHT))
        if skip_first_frames:
            self.cap.set(cv.CAP_PROP_POS_FRAMES, skip_first_frames)
        self.remaining = self.total - skip_first_frames
        if load_cap > 0:
            self.remaining = min(self.remaining, load_cap)

    def read_frames(self, count: int) -> np.ndarray:
        frames: List[np.ndarray] = []
        while len(frames) < count and self.remaining > 0:
            ok, frame = self.cap.read()
            if not ok:
                break
            frames.append(frame)  # BGR uint8
            self.remaining -= 1
        if not frames:
            return np.zeros((0, self.height, self.width, 3), np.float32)
        from ..ops.native import frames_to_float

        return frames_to_float(np.stack(frames), swap_rb=True)

    def close(self):
        self.cap.release()


class VideoWriter:
    def __init__(self, path: str, fps: float, size_hw: Tuple[int, int]):
        cv = _cv2()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        h, w = size_hw
        fourcc = cv.VideoWriter_fourcc(*"mp4v")
        self.writer = cv.VideoWriter(path, fourcc, fps, (w, h))
        if not self.writer.isOpened():
            raise IOError(f"cannot open video writer: {path}")

    def write_frames(self, frames: np.ndarray):
        """frames: (T, H, W, 3) float32 [0,1]."""
        from ..ops.native import frames_to_uint8

        for frame in frames:
            self.writer.write(frames_to_uint8(frame[..., :3], swap_rb=True))

    def close(self):
        self.writer.release()


def read_directory(path: str) -> np.ndarray:
    _cv2()
    files = sorted(
        f for f in os.listdir(path)
        if os.path.splitext(f)[1].lower() in IMAGE_EXTS)
    if not files:
        raise IOError(f"no images in directory: {path}")
    frames = [read_image(os.path.join(path, f))[0] for f in files]
    c = min(f.shape[-1] for f in frames)
    return np.stack([f[..., :c] for f in frames])


class ArrayReader:
    """VideoReader's interface over a .npy array of frames, memory-mapped:
    (T, H, W, C), or (H, W, C) as one frame; each read comes back as
    float32."""

    def __init__(self, path: str, skip_first_frames: int = 0,
                 load_cap: int = 0):
        frames = np.load(path, mmap_mode="r")
        if frames.ndim == 3:
            frames = frames[None]
        if frames.ndim != 4:
            raise ValueError(f"{path}: frames must be (T, H, W, C) or "
                             f"(H, W, C), got shape {frames.shape}")
        self.frames = frames
        self.fps = ARRAY_FPS
        self.total = frames.shape[0]
        self.height, self.width = frames.shape[1:3]
        self.pos = min(skip_first_frames, self.total)
        self.remaining = self.total - skip_first_frames
        if load_cap > 0:
            self.remaining = min(self.remaining, load_cap)

    def read_frames(self, count: int) -> np.ndarray:
        n = max(0, min(count, self.remaining))
        out = np.array(self.frames[self.pos:self.pos + n], dtype=np.float32)
        self.pos += n
        self.remaining -= n
        return out

    def close(self):
        self.frames = None


class ArrayWriter:
    """VideoWriter's interface into a .npy file of `total` frames of
    `frame_shape` (H, W, C) float32, written through a memory map; every
    channel is kept (RGBA stays RGBA)."""

    def __init__(self, path: str, total: int, frame_shape: Tuple[int, ...]):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self.total = total
        self.out = np.lib.format.open_memmap(
            path, mode="w+", dtype=np.float32,
            shape=(total, *frame_shape))
        self.written = 0

    def write_frames(self, frames: np.ndarray):
        n = frames.shape[0]
        if self.written + n > self.total:
            raise ValueError(f"{self.path}: {self.written + n} frames "
                             f"written into an array of {self.total}")
        self.out[self.written:self.written + n] = frames
        self.written += n

    def close(self):
        if self.written != self.total:
            raise ValueError(f"{self.path}: {self.written} of {self.total} "
                             "frames written")
        self.out.flush()
        self.out = None
