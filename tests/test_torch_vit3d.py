"""The port's ViT-3D against ``vats_tpu``: 3-D axial RoPE in every mode,
``PatchEmbeddings3D`` (resize, pad, truncate, the frame mask onto the patch
grid) and ``VideoTransformer`` with padded frames in one row only, through
the features and the masked-mean head.

Inputs are made from a seed with numpy; the JAX params are carried across
with ``params_from_jax``; both packages run on the CPU.  Tolerances: fp32
RoPE atol 1e-5; fp32 model outputs atol 2e-5, rtol 1e-5 (fp32 sums in
another order); bf16 model outputs atol 0.02, rtol 0.02 (bf16 rounded at
other places, a few ulps of outputs below ~1); masks exactly.  The
per-frame resize: bit for bit in bf16 (``jax.image.resize``'s weights and
its contractions in ``jnp.einsum``'s order, each rounded to bf16), within
1e-5 in fp32.

A temporal mask reshaped without its transpose (the original repository's
fault) would mask other tokens than JAX's in the padded row, so the
comparison with padding in one row catches it, and the valid patches'
features must not move when the padded frames' content does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import meta

from vats_tpu.configs.vit3d import vit3d_tiny_test as j_tiny
from vats_tpu.models.vit3d import PatchEmbeddings3D as JPatch3D
from vats_tpu.models.vit3d import VideoTransformer as JVideo
from vats_tpu.nn.rope import apply_rope_3d_axial as j_rope_3d
from vats_tpu_torch.configs import vit3d_tiny_test
from vats_tpu_torch.models import PatchEmbeddings3D, VideoTransformer
from vats_tpu_torch.models.vit2d import _resize_order, resize_bilinear
from vats_tpu_torch.nn.rope import apply_rope_3d_axial
from vats_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

F32_TOL = dict(atol=2e-5, rtol=1e-5)
BF16_TOL = dict(atol=0.02, rtol=0.02)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def t(x):
    return torch.from_numpy(np.asarray(x))


def f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("mode,shape", [("all", (2, 24, 2, 12)), ("spatial", (4, 6, 2, 12)),
                                        ("temporal", (6, 4, 2, 12))])
@pytest.mark.parametrize("ntk", [None, 0.5])
def test_rope_3d_axial_matches_jax(mode, shape, ntk):
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    got = apply_rope_3d_axial(t(x), 4, 2, 3, 30000.0, mode=mode, ntk_scale_factor=ntk)
    want = j_rope_3d(jnp.asarray(x), 4, 2, 3, 30000.0, mode=mode, ntk_scale_factor=ntk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    third = shape[-1] // 3
    passed = {"spatial": slice(0, third), "temporal": slice(third, None)}.get(mode)
    if passed is not None:  # the other thirds pass through unchanged
        np.testing.assert_array_equal(got.numpy()[..., passed], x[..., passed])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_3d_temporal_positions_and_bf16(dtype):
    x = np.random.RandomState(2).randn(3, 4, 2, 18).astype(np.float32)
    pos = np.array([5, 6, 7, 9])
    got = apply_rope_3d_axial(t(x).to(TDT[dtype]), 4, 2, 3, 100.0, mode="temporal",
                              t_positions=t(pos))
    want = j_rope_3d(jnp.asarray(x).astype(JDT[dtype]), 4, 2, 3, 100.0, mode="temporal",
                     t_positions=jnp.asarray(pos))
    assert got.dtype == TDT[dtype]
    np.testing.assert_allclose(got.float().numpy(), f32(want),
                               atol=1e-5 if dtype == "float32" else 2**-7 * 4)
    with pytest.raises(ValueError, match="divisible by 6"):
        apply_rope_3d_axial(t(x)[..., :16], 4, 2, 3, 100.0)


@pytest.mark.parametrize("frames,mask_row1", [(6, None), (20, None), (8, 3)])
def test_patch_embeddings_3d_pad_truncate_mask_match_jax(frames, mask_row1):
    cfg, jcfg = vit3d_tiny_test(dtype="float32"), j_tiny(dtype="float32")
    x = np.random.RandomState(3).randn(2, 3, frames, 40, 36).astype(np.float32)
    fm = None
    if mask_row1 is not None:
        fm = np.ones((2, frames), bool)
        fm[1, mask_row1:] = False
    jm = JPatch3D(jcfg)
    p = jax.device_get(meta.unbox(jm.init(jax.random.PRNGKey(4), jnp.asarray(x))))
    jx, jmask, jgrid = jm.apply(p, jnp.asarray(x),
                                frame_mask=None if fm is None else jnp.asarray(fm))
    pe = PatchEmbeddings3D(cfg)
    with torch.no_grad():
        pe.projection.weight.copy_(t(np.array(p["params"]["projection"]["kernel"])
                                     .transpose(4, 3, 0, 1, 2)))
        tx, tmask, tgrid = pe(t(x), None if fm is None else t(fm))
    assert tgrid == tuple(jgrid) == (4, 4, 4)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **F32_TOL)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    m = tmask.numpy().reshape(2, 4, 16)
    if frames == 6:  # frames 6, 7 padded: cells 0-2 valid, cell 3 not
        assert m[:, :3].all() and not m[:, 3].any()
    if mask_row1 == 3:  # row 1: frames 0-2 valid -> cells 0, 1 (any of 2, 3)
        assert m[0].all() and m[1, :2].all() and not m[1, 2:].any()
    with torch.no_grad():
        _, none_mask, _ = pe(t(x), use_padding=False)
    assert none_mask is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw,size,first", [((40, 36), (32, 32), "H"),  # vit3d_tiny_test
                                           ((120, 160), (224, 224), "W"),
                                           ((100, 30), (64, 64), "H")])
def test_per_frame_resize_matches_jax(dtype, hw, size, first):
    """[B, C, T, H, W] -> [B, C, T, h, w], as ``PatchEmbeddings3D`` resizes
    (the frame axis stays, and counts in the batch of jnp.einsum's cost)."""
    x = np.random.RandomState(sum(hw)).randn(2, 3, 5, *hw).astype(np.float32)
    assert _resize_order(30, hw, size) == first
    got = resize_bilinear(t(x).to(TDT[dtype]), size)
    want = f32(jax.image.resize(jnp.asarray(x).astype(JDT[dtype]), (2, 3, 5) + size,
                                method="bilinear"))
    assert got.dtype == TDT[dtype] and tuple(got.shape) == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    else:
        np.testing.assert_array_equal(got.float().numpy(), want)


def jax_and_port(dtype, x, **kw):
    jcfg, cfg = j_tiny(dtype=dtype, **kw), vit3d_tiny_test(dtype=dtype, **kw)
    jm = JVideo(jcfg)
    p = jax.device_get(meta.unbox(jm.init(jax.random.PRNGKey(5), jnp.asarray(x))))
    model = VideoTransformer(cfg, device="cpu")
    model.load_state_dict(params_from_jax(p, cfg))
    return jm, p, model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head", [False, True])
def test_video_transformer_padded_row_matches_jax(dtype, head):
    """Row 1 has its last 3 of 8 frames padded (row 0 none): features and
    the masked-mean head against JAX."""
    x = np.random.RandomState(6).randn(2, 3, 8, 40, 36).astype(np.float32)
    fm = np.ones((2, 8), bool)
    fm[1, 5:] = False
    jm, p, model = jax_and_port(dtype, x, use_classifier_head=head)
    want = f32(jm.apply(p, jnp.asarray(x), frame_mask=jnp.asarray(fm)))
    with torch.no_grad():
        got = model(t(x), frame_mask=t(fm))
    cfg = model.cfg
    gt, gh, gw = cfg.grid_size
    assert tuple(got.shape) == want.shape == ((2, cfg.num_classes) if head
                                              else (2, gt * gh * gw, cfg.d_model))
    np.testing.assert_allclose(got.float().numpy(), want,
                               **(F32_TOL if dtype == "float32" else BF16_TOL))


def test_video_transformer_valid_features_ignore_padded_frames():
    x = np.random.RandomState(7).randn(2, 3, 6, 32, 32).astype(np.float32)
    _, _, model = jax_and_port("float32", x)
    garbage = np.concatenate([x, 99.0 * np.ones((2, 3, 2, 32, 32), np.float32)], axis=2)
    fm = np.concatenate([np.ones((2, 6), bool), np.zeros((2, 2), bool)], axis=1)
    with torch.no_grad():
        a = model(t(x)).numpy()
        b = model(t(garbage), frame_mask=t(fm)).numpy()
    n_valid = 3 * 16  # the first 3 temporal cells
    np.testing.assert_allclose(a[:, :n_valid], b[:, :n_valid], atol=2e-4, rtol=2e-3)


def test_video_transformer_remat_gradients_equal_plain():
    """use_checkpointing recomputes each block in the backward: same loss
    and gradients as without it (dropout on, one seed)."""
    x = t(np.random.RandomState(8).randn(2, 3, 8, 32, 32).astype(np.float32))
    grads = []
    for remat in (False, True):
        cfg = vit3d_tiny_test(dtype="float32", dropout=0.1, use_checkpointing=remat,
                              use_classifier_head=True)
        model = VideoTransformer(cfg, device="cpu", seed=3)
        model(x, deterministic=False, dropout_seed=11).square().sum().backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, atol=1e-6, rtol=1e-5, msg=name)
