"""The port's vision data against ``vats_tpu``: mixup / cutmix given JAX's
own draws, the array and video loaders, and the video decoders on
synthetic files written to the public formats (YUV4MPEG2 and RIFF/AVI
headers byte by byte, as ``tests/test_video_decode.py`` writes them).

The decoders and loaders are numpy copies: their outputs must equal
``vats_tpu``'s exactly.  mixup / cutmix: the test replays ``jax.random``
on the JAX op's keys and hands the port's cores the same draws; images
atol 1e-6 (one fp32 blend), labels and lam exactly."""

import io
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vats_tpu.data import augmentations as JA
from vats_tpu.data import video_decode as JV
from vats_tpu.data import vision_data as JD
from vats_tpu_torch.data import augmentations as TA
from vats_tpu_torch.data import video_decode as TV
from vats_tpu_torch.data import vision_data as TD

torch.set_num_threads(1)

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402


def t(x):
    return torch.from_numpy(np.array(x))


# --- mixup / cutmix -----------------------------------------------------------


def _batch(seed=0, b=6, dtype=np.float32):
    rs = np.random.RandomState(seed)
    return rs.randn(b, 3, 12, 10).astype(dtype), np.arange(10, 10 + b, dtype=np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mixup_core_matches_jax_with_its_draws(seed):
    x, y = _batch(seed)
    key = jax.random.PRNGKey(seed)
    jm, jta, jtb, jlam = JA.mixup_data(key, jnp.asarray(x), jnp.asarray(y), 0.8)
    rng_lam, rng_perm = jax.random.split(key)
    lam = float(jax.random.beta(rng_lam, 0.8, 0.8))
    index = np.asarray(jax.random.permutation(rng_perm, x.shape[0]))
    m, ta, tb, tlam = TA.mixup_blend(t(x), t(y), lam, t(index))
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=1e-6)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(jta))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jtb))
    assert float(tlam) == float(jlam)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cutmix_core_matches_jax_with_its_draws(seed):
    x, y = _batch(seed)
    key = jax.random.PRNGKey(seed)
    jm, jta, jtb, jlam = JA.cutmix_data(key, jnp.asarray(x), jnp.asarray(y), 1.0)
    rng_lam, rng_perm, rng_cx, rng_cy = jax.random.split(key, 4)
    lam0 = float(jax.random.beta(rng_lam, 1.0, 1.0))
    index = np.asarray(jax.random.permutation(rng_perm, x.shape[0]))
    cx = int(jax.random.randint(rng_cx, (), 0, 10))
    cy = int(jax.random.randint(rng_cy, (), 0, 12))
    m, ta, tb, tlam = TA.cutmix_given(t(x), t(y), torch.tensor(lam0, dtype=torch.float32),
                                      t(index), torch.tensor(cx), torch.tensor(cy))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jtb))
    assert float(tlam) == float(jlam)


def test_augmentation_wrappers_invariants():
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    x, y = _batch(4)
    m, ta, tb, lam = TA.mixup_data(gen(0), t(x), t(y), 0.8)
    assert 0.0 <= float(lam) <= 1.0 and sorted(tb.tolist()) == sorted(y.tolist())
    expected = float(lam) * x + (1 - float(lam)) * x[[y.tolist().index(v) for v in tb.tolist()]]
    np.testing.assert_allclose(m.numpy(), expected, atol=1e-5)
    m, _, _, lam = TA.mixup_data(gen(0), t(x), t(y), 0)
    assert float(lam) == 1.0 and torch.equal(m, t(x))
    m, _, tb, lam = TA.cutmix_data(gen(1), t(x), t(y), 1.0)
    assert not torch.equal(tb, t(y))  # a partner other than itself somewhere
    changed = (m.numpy() != x).any(axis=(0, 1)).mean()  # the box's share of the image
    assert 1.0 - changed == pytest.approx(float(lam), abs=1e-6)
    seen = {TA.random_augmentation(gen(s), t(x), t(y), 0.8)[3].item() == 1.0 for s in range(12)}
    assert seen == {True, False}  # the chooser picks "none" and a mix
    bx = t(x).to(torch.bfloat16)
    assert TA.random_augmentation(gen(3), bx, t(y), 0.8)[0].dtype == torch.bfloat16


# --- array loader -------------------------------------------------------------


def test_array_batches_and_normalize_match_jax():
    rs = np.random.RandomState(5)
    images = rs.randint(0, 256, (10, 3, 8, 8)).astype(np.uint8)
    labels = np.arange(10, dtype=np.int32)
    for kw in (dict(), dict(shuffle=False, drop_last=False, normalize=False)):
        got = list(TD.array_batches(images, labels, 4, seed=3, **kw))
        want = list(JD.array_batches(images, labels, 4, seed=3, **kw))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["images"], w["images"])
            np.testing.assert_array_equal(g["labels"], w["labels"])
    np.testing.assert_array_equal(TD.normalize_images(images), JD.normalize_images(images))


def test_setup_data_loaders_needs_torchvision_or_raises(tmp_path, monkeypatch):
    """Without torchvision (absent on both machines, and made absent here
    whatever another test installed) the ImageFolder loaders raise."""
    import sys

    monkeypatch.setitem(sys.modules, "torchvision", None)
    with pytest.raises(RuntimeError, match="torchvision"):
        TD.setup_data_loaders(str(tmp_path), str(tmp_path))


# --- video decoding (the writers follow the public formats) --------------------


def _solid_frames(t=4, h=24, w=32):
    colors = [(255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0),
              (0, 255, 255), (255, 0, 255)]
    frames = np.zeros((t, h, w, 3), np.uint8)
    for i in range(t):
        frames[i] = colors[i % len(colors)]
    return frames


def _write_y4m(path, frames, chroma="444"):
    """BT.601 studio-swing RGB -> YCbCr planes in a YUV4MPEG2 stream."""
    t, h, w, _ = frames.shape
    f32 = frames.astype(np.float32)
    r, g, b = f32[..., 0], f32[..., 1], f32[..., 2]
    y_full = 0.299 * r + 0.587 * g + 0.114 * b
    y = np.clip(16.0 + (219.0 / 255.0) * y_full, 0, 255)
    u = np.clip(128.0 + (224.0 / 255.0) * (b - y_full) / 1.772, 0, 255)
    v = np.clip(128.0 + (224.0 / 255.0) * (r - y_full) / 1.402, 0, 255)
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F25:1 Ip A1:1 C{chroma}\n".encode())
        for i in range(t):
            f.write(b"FRAME\n")
            f.write(y[i].astype(np.uint8).tobytes())
            for plane in (u[i], v[i]):
                if chroma == "420":
                    plane = plane.reshape(h // 2, 2, w // 2, 2).mean((1, 3))
                f.write(plane.astype(np.uint8).tobytes())


def _write_mjpeg_avi(path, frames):
    """A minimal RIFF/AVI: an hdrl LIST (avih) and a movi LIST of 00dc JPEGs."""
    jpegs = []
    for fr in frames:
        buf = io.BytesIO()
        Image.fromarray(fr).save(buf, format="JPEG", quality=95)
        jpegs.append(buf.getvalue())

    def chunk(fourcc, payload):
        pad = b"\x00" if len(payload) & 1 else b""
        return fourcc + struct.pack("<I", len(payload)) + payload + pad

    avih = struct.pack("<14I", 40000, 0, 0, 0x10, len(jpegs), 0, 1, 0,
                       frames.shape[2], frames.shape[1], 0, 0, 0, 0)
    hdrl = chunk(b"LIST", b"hdrl" + chunk(b"avih", avih))
    movi = chunk(b"LIST", b"movi" + b"".join(chunk(b"00dc", j) for j in jpegs))
    body = b"AVI " + hdrl + movi
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


@pytest.mark.parametrize("chroma", ["444", "420"])
def test_decode_y4m_matches_jax(tmp_path, chroma):
    frames = _solid_frames(t=6)
    p = str(tmp_path / "clip.y4m")
    _write_y4m(p, frames, chroma)
    out = TV.decode_y4m(p)
    np.testing.assert_array_equal(out, JV.decode_y4m(p))
    assert out.shape == frames.shape and np.abs(out.astype(int) - frames).max() <= 6
    assert TV.decode_y4m(p, max_frames=3).shape[0] == 3


def test_decode_mjpeg_avi_matches_jax_and_rejects_non_avi(tmp_path):
    frames = _solid_frames()
    p = str(tmp_path / "clip.avi")
    _write_mjpeg_avi(p, frames)
    out = TV.decode_mjpeg_avi(p)
    np.testing.assert_array_equal(out, JV.decode_mjpeg_avi(p))
    assert np.abs(out.astype(int) - frames.astype(int)).max() <= 10
    bad = str(tmp_path / "x.avi")
    with open(bad, "wb") as f:
        f.write(b"not a riff file")
    with pytest.raises(ValueError):
        TV.decode_mjpeg_avi(bad)


def test_frame_dir_and_npy_layouts_match_jax(tmp_path):
    frames = _solid_frames(t=3, h=16, w=16)
    d = tmp_path / "vid"
    d.mkdir()
    for i, fr in enumerate(frames):
        Image.fromarray(fr).save(str(d / f"frame_{i:04d}.png"))
    np.testing.assert_array_equal(TV.load_frame_dir(str(d)), frames)
    thwc = _solid_frames(t=3, h=8, w=10)
    for name, arr in (("a.npy", thwc), ("b.npy", thwc.transpose(3, 0, 1, 2)),
                      ("c.npy", thwc.astype(np.float32) / 255.0)):
        p = str(tmp_path / name)
        np.save(p, arr)
        np.testing.assert_array_equal(TV.decode_video(p), JV.decode_video(p))
    np.testing.assert_array_equal(TV.decode_video(str(d)), frames)


def test_sample_clip_indices_and_resize_match_jax():
    np.testing.assert_array_equal(TV.sample_clip_indices(10, 4, stride=2), [1, 3, 5, 7])
    np.testing.assert_array_equal(TV.sample_clip_indices(3, 5), [0, 1, 2, 0, 1])
    a, b = np.random.RandomState(0), np.random.RandomState(0)
    for _ in range(10):
        np.testing.assert_array_equal(
            TV.sample_clip_indices(20, 4, stride=3, random=True, rng=a),
            JV.sample_clip_indices(20, 4, stride=3, random=True, rng=b))
    frames = np.random.RandomState(1).randint(0, 256, (2, 24, 48, 3)).astype(np.uint8)
    out = TV.resize_center_crop(frames, 16)
    assert out.shape == (2, 16, 16, 3)
    np.testing.assert_array_equal(out, JV.resize_center_crop(frames, 16))


def test_clip_and_video_loaders_match_jax(tmp_path):
    root = tmp_path / "dataset"
    for cls in ("drumming", "surfing"):
        cdir = root / cls
        cdir.mkdir(parents=True)
        _write_mjpeg_avi(str(cdir / "v0.avi"), _solid_frames(t=6, h=24, w=32))
        _write_y4m(str(cdir / "v1.y4m"), _solid_frames(t=5, h=24, w=32))
    kw = dict(batch_size=2, num_frames=4, image_size=16, epochs=1)
    for shuffle in (False, True):
        got = list(TD.setup_video_loaders(str(root), shuffle=shuffle, **kw))
        want = list(JD.setup_video_loaders(str(root), shuffle=shuffle, **kw))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g["videos"].shape == (2, 3, 4, 16, 16) and g["videos"].dtype == np.float32
            np.testing.assert_array_equal(g["videos"], w["videos"])
            np.testing.assert_array_equal(g["labels"], w["labels"])
    clip = TV.load_clip(str(root / "drumming" / "v0.avi"), num_frames=4, image_size=16)
    np.testing.assert_array_equal(
        clip, JV.load_clip(str(root / "drumming" / "v0.avi"), num_frames=4, image_size=16))
    flat = tmp_path / "flat"
    flat.mkdir()
    for i in range(4):
        np.save(str(flat / f"c{i}_{i % 2}.npy"), np.full((3, 2, 4, 4), i, np.float32))
    got = list(TD.setup_video_loaders(str(flat), 2, shuffle=False))
    want = list(JD.setup_video_loaders(str(flat), 2, shuffle=False))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["videos"], w["videos"])
        np.testing.assert_array_equal(g["labels"], w["labels"])
