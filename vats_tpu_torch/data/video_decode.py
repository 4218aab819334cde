"""Self-contained video clip decoding: Y4M, MJPEG-AVI, frame directories.

The port's own copy of ``vats_tpu/data/video_decode.py`` (numpy, and PIL
imported lazily where a JPEG or a frame image is decoded or a frame
resized; nothing on the card's path needs it).  It feeds
:func:`vats_tpu_torch.data.vision_data.setup_video_loaders`:

  * ``.y4m``   — YUV4MPEG2 raw video (I420 / I444 frames)
  * ``.avi``   — RIFF/AVI containers holding MJPEG streams ('##dc'/'##db'
                 chunks decoded per frame by PIL's JPEG codec)
  * directory  — one image file per frame (the layout of preprocessed
                 academic video datasets such as UCF101 / Kinetics dumps)
  * ``.npy``   — pre-extracted [C, T, H, W] or [T, H, W, C] arrays

plus temporal clip sampling (uniform or random) and spatial resize +
center crop, producing [C, T, H, W] float32 clips in [0, 1].
"""

from __future__ import annotations

import io
import os
import struct as _struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "decode_y4m",
    "decode_mjpeg_avi",
    "load_frame_dir",
    "decode_video",
    "sample_clip_indices",
    "resize_center_crop",
    "load_clip",
]


# ---------------------------------------------------------------------------
# Y4M (YUV4MPEG2)
# ---------------------------------------------------------------------------


def _yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """BT.601 studio-swing YCbCr -> RGB uint8.  y/u/v: [H, W] float32.

    Luma occupies [16, 235] (219 steps), chroma [16, 240] (224 steps)."""
    y = (y - 16.0) * (255.0 / 219.0)
    pb = (u - 128.0) * (255.0 / 224.0)
    pr = (v - 128.0) * (255.0 / 224.0)
    r = y + 1.402 * pr
    b = y + 1.772 * pb
    g = (y - 0.299 * r - 0.114 * b) / 0.587
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode_y4m(path: str, max_frames: Optional[int] = None) -> np.ndarray:
    """Decode a YUV4MPEG2 file -> [T, H, W, 3] uint8 RGB.

    Supports C420 (default, chroma at half resolution) and C444."""
    with open(path, "rb") as f:
        header = bytearray()
        while True:
            ch = f.read(1)
            if not ch:
                raise ValueError(f"{path}: truncated y4m header")
            if ch == b"\n":
                break
            header += ch
        fields = header.decode("ascii", "replace").split(" ")
        if not fields or fields[0] != "YUV4MPEG2":
            raise ValueError(f"{path}: not a YUV4MPEG2 file")
        w = h = None
        fmt = "420"
        for tok in fields[1:]:
            if tok.startswith("W"):
                w = int(tok[1:])
            elif tok.startswith("H"):
                h = int(tok[1:])
            elif tok.startswith("C"):
                fmt = tok[1:]
        if not w or not h:
            raise ValueError(f"{path}: missing W/H in y4m header")
        if fmt.startswith("420"):
            cw, ch_ = w // 2, h // 2
        elif fmt.startswith("444"):
            cw, ch_ = w, h
        else:
            raise ValueError(f"{path}: unsupported y4m chroma format C{fmt}")
        ysize, csize = w * h, cw * ch_

        frames: List[np.ndarray] = []
        while max_frames is None or len(frames) < max_frames:
            line = f.readline()
            if not line:
                break
            if not line.startswith(b"FRAME"):
                raise ValueError(f"{path}: bad frame marker {line[:16]!r}")
            raw = f.read(ysize + 2 * csize)
            if len(raw) < ysize + 2 * csize:
                break
            y = np.frombuffer(raw, np.uint8, ysize).reshape(h, w)
            u = np.frombuffer(raw, np.uint8, csize, ysize).reshape(ch_, cw)
            v = np.frombuffer(
                raw, np.uint8, csize, ysize + csize
            ).reshape(ch_, cw)
            if (ch_, cw) != (h, w):  # upsample chroma (nearest)
                u = u.repeat(h // ch_, 0).repeat(w // cw, 1)
                v = v.repeat(h // ch_, 0).repeat(w // cw, 1)
            frames.append(
                _yuv_to_rgb(
                    y.astype(np.float32),
                    u.astype(np.float32),
                    v.astype(np.float32),
                )
            )
    if not frames:
        raise ValueError(f"{path}: no frames decoded")
    return np.stack(frames)


# ---------------------------------------------------------------------------
# MJPEG-AVI (RIFF demux + PIL JPEG decode)
# ---------------------------------------------------------------------------


def _iter_riff_chunks(buf: memoryview, offset: int, end: int):
    """Yield (fourcc, payload_start, payload_size) for chunks in [offset, end)."""
    pos = offset
    while pos + 8 <= end:
        fourcc = bytes(buf[pos : pos + 4])
        (size,) = _struct.unpack_from("<I", buf, pos + 4)
        yield fourcc, pos + 8, size
        pos += 8 + size + (size & 1)  # chunks are word-aligned


def decode_mjpeg_avi(path: str, max_frames: Optional[int] = None) -> np.ndarray:
    """Demux an AVI container and PIL-decode its MJPEG frames.

    Walks the RIFF tree to the 'movi' LIST and decodes every video chunk
    ('##dc'/'##db').  Returns [T, H, W, 3] uint8 RGB."""
    from PIL import Image

    with open(path, "rb") as f:
        data = memoryview(f.read())
    if len(data) < 12 or bytes(data[:4]) != b"RIFF" or bytes(data[8:12]) != b"AVI ":
        raise ValueError(f"{path}: not a RIFF/AVI file")

    frames: List[np.ndarray] = []

    def walk(offset: int, end: int):
        for fourcc, start, size in _iter_riff_chunks(data, offset, end):
            if max_frames is not None and len(frames) >= max_frames:
                return
            if fourcc == b"LIST":
                list_type = bytes(data[start : start + 4])
                if list_type in (b"movi", b"hdrl", b"rec "):
                    walk(start + 4, start + size)
            elif len(fourcc) == 4 and fourcc[2:] in (b"dc", b"db") and size > 0:
                payload = bytes(data[start : start + size])
                # MJPEG frames are bare JPEGs (maybe with AVI1 APP0)
                if payload[:2] == b"\xff\xd8":
                    img = Image.open(io.BytesIO(payload)).convert("RGB")
                    frames.append(np.asarray(img))

    walk(12, len(data))
    if not frames:
        raise ValueError(f"{path}: no MJPEG frames found (codec unsupported?)")
    return np.stack(frames)


# ---------------------------------------------------------------------------
# frame directories / npy / dispatch
# ---------------------------------------------------------------------------

_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def load_frame_dir(path: str, max_frames: Optional[int] = None) -> np.ndarray:
    """Directory of per-frame images (sorted by name) -> [T, H, W, 3] uint8."""
    from PIL import Image

    names = sorted(
        n for n in os.listdir(path)
        if os.path.splitext(n)[1].lower() in _IMAGE_EXTS
    )
    if max_frames is not None:
        names = names[:max_frames]
    if not names:
        raise ValueError(f"{path}: no frame images")
    frames = [
        np.asarray(Image.open(os.path.join(path, n)).convert("RGB"))
        for n in names
    ]
    return np.stack(frames)


def decode_video(path: str, max_frames: Optional[int] = None) -> np.ndarray:
    """Dispatch on source type -> [T, H, W, 3] uint8 RGB frames."""
    if os.path.isdir(path):
        return load_frame_dir(path, max_frames)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".y4m":
        return decode_y4m(path, max_frames)
    if ext == ".avi":
        return decode_mjpeg_avi(path, max_frames)
    if ext == ".npy":
        arr = np.load(path)
        if arr.ndim != 4:
            raise ValueError(f"{path}: expected 4D clip, got {arr.shape}")
        if arr.shape[0] in (1, 3) and arr.shape[-1] not in (1, 3):
            arr = arr.transpose(1, 2, 3, 0)  # [C,T,H,W] -> [T,H,W,C]
        if max_frames is not None:
            arr = arr[:max_frames]
        if arr.dtype != np.uint8:
            a = arr.astype(np.float32)
            if a.max() <= 1.5:
                a = a * 255.0
            arr = np.clip(a, 0, 255).astype(np.uint8)
        return arr
    raise ValueError(f"{path}: unsupported video source (ext {ext!r})")


# ---------------------------------------------------------------------------
# sampling + spatial ops
# ---------------------------------------------------------------------------


def sample_clip_indices(
    total: int,
    num_frames: int,
    *,
    stride: int = 1,
    random: bool = False,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """Temporal sampling: a window of num_frames at the given stride, placed
    uniformly (center) or at a random offset; short videos loop."""
    span = (num_frames - 1) * stride + 1
    if total >= span:
        start_max = total - span
        if random:
            start = int((rng or np.random).randint(0, start_max + 1))
        else:
            start = start_max // 2
        return start + np.arange(num_frames) * stride
    # loop short videos
    return (np.arange(num_frames) * stride) % total


def resize_center_crop(frames: np.ndarray, size: int) -> np.ndarray:
    """[T, H, W, 3] uint8 -> short side resized to ``size`` (bilinear via
    PIL), then center-cropped to [T, size, size, 3]."""
    from PIL import Image

    t, h, w, _ = frames.shape
    if (h, w) != (size, size):
        scale = size / min(h, w)
        nh, nw = max(size, round(h * scale)), max(size, round(w * scale))
        resized = np.stack(
            [
                np.asarray(
                    Image.fromarray(f).resize((nw, nh), Image.BILINEAR)
                )
                for f in frames
            ]
        )
        y0 = (nh - size) // 2
        x0 = (nw - size) // 2
        frames = resized[:, y0 : y0 + size, x0 : x0 + size]
    return frames


def load_clip(
    path: str,
    *,
    num_frames: int,
    image_size: int,
    stride: int = 1,
    random_sample: bool = False,
    rng: Optional[np.random.RandomState] = None,
) -> np.ndarray:
    """Decode + temporally sample + spatially crop one clip.

    Returns [C, T, H, W] float32 in [0, 1] (model layout)."""
    frames = decode_video(path)
    idx = sample_clip_indices(
        len(frames), num_frames, stride=stride, random=random_sample, rng=rng
    )
    clip = resize_center_crop(frames[idx], image_size)
    return clip.astype(np.float32).transpose(3, 0, 1, 2) / 255.0
