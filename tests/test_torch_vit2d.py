"""The port's ViT-2D against ``vats_tpu``: 2-D axial RoPE, SwiGLU / FFN
block, the resize and crop, ``ImageEncoder`` (features, mean and max heads,
the plain and the flash attention path) and its gradients.

Inputs are made from a seed with numpy; the JAX params are carried across
with ``params_from_jax``; both packages run on the CPU.  Tolerances:

  * fp32 elementwise math (RoPE, resize): atol 1e-5 (the same operations in
    another library);
  * fp32 model outputs: atol 2e-5, rtol 1e-5 (fp32 sums in another order);
  * bf16 resize: equal bit for bit (the port computes ``jax.image.resize``'s
    weight matrices and its contractions in ``jnp.einsum``'s order, each
    rounded to bf16 as JAX rounds it), at shapes that take each order and
    a tie;
  * bf16 model outputs: atol 0.1, rtol 0.02 — the packages round bf16 at
    other places (each product's sum), a few bf16 ulps (2^-8 relative)
    over two layers at magnitudes up to ~5;
  * gradients (fp32): atol 2e-5, rtol 1e-4 against ``jax.grad``.

The flash path: the JAX model runs its Pallas kernel in interpret mode
('flash_interpret'), the port's wrapper its plain version (the CPU tensor),
at 256 patches and head dim 72 (the width of ``vit2d_medium``'s heads)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import meta

from vats_tpu.configs.vit2d import vit2d_xsmall as j_vit2d_xsmall
from vats_tpu.models.vit2d import ImageEncoder as JImageEncoder
from vats_tpu.models.vit2d import resize_and_center_crop as j_resize
from vats_tpu.nn.activations import FFNBlock as JFFNBlock
from vats_tpu.nn.activations import SwiGLU as JSwiGLU
from vats_tpu.nn.attention import Attention as JAttention
from vats_tpu.nn.kv_cache import KVCache as JKVCache
from vats_tpu.nn.rope import apply_rope_2d_axial as j_rope_2d
from vats_tpu.nn.rope import grid_positions_2d as j_grid
from vats_tpu_torch.configs import vit2d_xsmall
from vats_tpu_torch.models import ImageEncoder, resize_and_center_crop
from vats_tpu_torch.models.vit2d import _resize_order, resize_bilinear
from vats_tpu_torch.nn import Attention, FFNBlock, SwiGLU
from vats_tpu_torch.nn.rope import apply_rope_2d_axial, grid_positions_2d
from vats_tpu_torch.nn.kv_cache import KVCache
from vats_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

F32_TOL = dict(atol=2e-5, rtol=1e-5)
BF16_TOL = dict(atol=0.1, rtol=0.02)
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def t(x):
    return torch.from_numpy(np.asarray(x))


def f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def jax_model(cfg, x):
    model = JImageEncoder(cfg)
    params = jax.device_get(meta.unbox(model.init(jax.random.PRNGKey(0), jnp.asarray(x))))
    return model, params


def port_model(cfg, jparams):
    model = ImageEncoder(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jparams, cfg))
    return model


# --- RoPE, SwiGLU, FFN, resize ------------------------------------------------


def test_grid_positions_2d_row_major():
    r, c = grid_positions_2d(3, 4)
    jr, jc = j_grid(3, 4)
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ntk", [None, 1.7])
def test_rope_2d_axial_matches_jax(dtype, ntk):
    x = np.random.RandomState(1).randn(2, 12, 3, 16).astype(np.float32)
    got = apply_rope_2d_axial(t(x).to(TDT[dtype]), 3, 4, 30000.0, ntk).float().numpy()
    want = f32(j_rope_2d(jnp.asarray(x).astype(JDT[dtype]), 3, 4, 30000.0, ntk))
    # bf16: the rotation is fp32 on both sides, rounded once
    tol = dict(atol=1e-5) if dtype == "float32" else dict(atol=2**-7 * 4, rtol=2**-8)
    np.testing.assert_allclose(got, want, **tol)
    if ntk is None:  # position (0, 0) is the identity
        np.testing.assert_allclose(got[:, 0], f32(jnp.asarray(x).astype(JDT[dtype]))[:, 0],
                                   atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_and_ffn_block_match_jax(dtype):
    d, f = 24, 40
    x = np.random.RandomState(2).randn(2, 7, d).astype(np.float32)
    for jmod, tmod, prefix in (
        (JSwiGLU(d, f, dtype=JDT[dtype]), SwiGLU(d, f, dtype=TDT[dtype]), ""),
        (JFFNBlock(d, f, dtype=JDT[dtype]), FFNBlock(d, f, dtype=TDT[dtype]), "swiglu."),
    ):
        p = jax.device_get(meta.unbox(jmod.init(jax.random.PRNGKey(3), jnp.asarray(x))))
        tree = p["params"]
        sd = {}
        sw = tree.get("SwiGLU_0", tree)
        for name in ("w_gate", "w_up", "w_down"):
            sd[f"{prefix}{name}.weight"] = t(np.array(sw[name]).T.copy())
        if prefix:
            sd["norm.weight"] = t(np.array(tree["RMSNorm_0"]["weight"]))
        tmod.load_state_dict(sd)
        with torch.no_grad():
            got = tmod(t(x)).float().numpy()
        want = f32(jmod.apply(p, jnp.asarray(x)))
        tol = F32_TOL if dtype == "float32" else dict(atol=0.03, rtol=0.02)
        np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,target", [((2, 3, 75, 90), 64),  # down, wide
                                          ((1, 3, 31, 47), 64),  # up, odd sizes
                                          ((2, 2, 129, 100), 37)])  # down, tall, odd
def test_resize_and_center_crop_matches_jax(dtype, shape, target):
    x = (np.random.RandomState(4).rand(*shape) * 3 - 1).astype(np.float32)
    got = resize_and_center_crop(t(x).to(TDT[dtype]), target)
    want = f32(j_resize(jnp.asarray(x).astype(JDT[dtype]), target))
    assert tuple(got.shape) == want.shape == shape[:2] + (target, target)
    assert got.dtype == TDT[dtype]
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    else:
        np.testing.assert_array_equal(got.float().numpy(), want)


# (H, W) -> (h, w) at B*C = 6, and the contraction jnp.einsum takes first
RESIZE_SHAPES = [((37, 53), (64, 92), "W"), ((500, 20), (280, 11), "W"),
                 ((300, 120), (560, 224), "H"), ((256, 320), (224, 280), "H"),
                 ((64, 64), (224, 224), "H"),  # equal cost: H, the earlier
                 ((480, 640), (224, 299), "H"),  # vit2d_medium's crop of a 480 x 640 photo
                 ((1, 1), (4, 4), "outer")]  # the weight matrices' product first


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw,size,first", RESIZE_SHAPES)
def test_resize_bilinear_matches_jax_image_resize(dtype, hw, size, first):
    """Both contraction orders, a tie and the outer product: bit for bit in
    bf16, within 1e-5 in fp32."""
    x = np.random.RandomState(sum(hw)).randn(2, 3, *hw).astype(np.float32)
    assert _resize_order(6, hw, size) == first
    got = resize_bilinear(t(x).to(TDT[dtype]), size)
    want = f32(jax.image.resize(jnp.asarray(x).astype(JDT[dtype]), (2, 3) + size,
                                method="bilinear"))
    assert got.dtype == TDT[dtype] and tuple(got.shape) == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    else:
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_resize_order_is_jnp_einsums_path():
    """The port's rule against the path ``jnp.einsum`` asks opt_einsum for
    (operands x, the H weights, the W weights), over sizes and batch
    products where each order wins and where costs tie."""
    names = {(0, 1): "H", (0, 2): "W", (1, 2): "outer"}
    for bc in (1, 6, 48):
        for hw in ((1, 1), (2, 3), (37, 53), (64, 64), (480, 640)):
            for size in ((4, 4), (11, 280), (64, 92), (224, 224), (224, 299)):
                path, _ = jnp.einsum_path("bhw,hk,wl->bkl", np.empty((bc,) + hw),
                                          np.empty((hw[0], size[0])),
                                          np.empty((hw[1], size[1])), optimize="auto")
                assert _resize_order(bc, hw, size) == names[path[0]], (bc, hw, size)


def test_resize_keeps_a_matching_size_exactly():
    x = np.random.RandomState(5).randn(1, 3, 64, 80).astype(np.float32)
    got = resize_and_center_crop(t(x), 64).numpy()
    np.testing.assert_array_equal(got, x[:, :, :, 8:72])
    np.testing.assert_array_equal(got, np.asarray(j_resize(jnp.asarray(x), 64)))


# --- attention: 2-D RoPE, 'none' and '3d_ntk'; the cache paths refuse '2d_axial' -


@pytest.mark.parametrize("rope_type", ["2d_axial", "none"])
def test_attention_uncached_rope_types_match_jax(rope_type):
    d, h, g = 32, 4, 2
    x = np.random.RandomState(6).randn(2, 12, d).astype(np.float32)
    jm = JAttention(d, h, g, rope_theta=30000.0, rope_type=rope_type, impl="xla")
    p = jax.device_get(meta.unbox(jm.init(jax.random.PRNGKey(7), jnp.asarray(x),
                                          causal=False, grid_shape=(3, 4))))
    want, _ = jm.apply(p, jnp.asarray(x), causal=False, grid_shape=(3, 4))
    tm = Attention(d, h, g, rope_theta=30000.0, rope_type=rope_type, impl="xla")
    tm.load_state_dict({f"{n}.weight": t(np.array(p["params"][n]["kernel"]).T.copy())
                        for n in ("w_qkv", "w_o")})
    with torch.no_grad():
        got, cache = tm(t(x), causal=False, grid_shape=(3, 4))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    kv = KVCache.create(num_layers=1, batch_size=2, max_seq_len=16, kv_heads=g,
                        head_dim=d // h, dtype=torch.float32, device="cpu")
    if rope_type == "2d_axial":  # JAX refuses it under a cache too
        with pytest.raises(NotImplementedError, match="rope_type"):
            tm(t(x), causal=True, cache=kv, grid_shape=(3, 4))
    else:  # 'none' under a dense cache: a prefill, then a decode token
        jkv = JKVCache.create(num_layers=1, batch_size=2, max_seq_len=16, kv_heads=g,
                              head_dim=d // h, dtype=jnp.float32)
        x1 = np.random.RandomState(9).randn(2, 1, d).astype(np.float32)
        for xs in (x, x1):
            want, jkv = jm.apply(p, jnp.asarray(xs), causal=True, cache=jkv)
            jkv = jkv.advance(xs.shape[1])
            with torch.no_grad():
                got, kv = tm(t(xs), causal=True, cache=kv)
            kv = kv.advance(xs.shape[1])
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    # '3d_ntk' (ported with video generation; head dim 12): raster t-major
    # positions over 2 frames of 2 x 3, uncached
    j3 = JAttention(48, 4, 2, rope_type="3d_ntk", rope_ntk_scale=0.7, impl="xla")
    x3 = np.random.RandomState(10).randn(2, 12, 48).astype(np.float32)
    p3 = jax.device_get(meta.unbox(j3.init(jax.random.PRNGKey(11), jnp.asarray(x3),
                                           grid_shape=(2, 2, 3))))
    want, _ = j3.apply(p3, jnp.asarray(x3), grid_shape=(2, 2, 3))
    t3 = Attention(48, 4, 2, rope_type="3d_ntk", rope_ntk_scale=0.7, impl="xla")
    t3.load_state_dict({f"{n}.weight": t(np.array(p3["params"][n]["kernel"]).T.copy())
                        for n in ("w_qkv", "w_o")})
    with torch.no_grad():
        got, _ = t3(t(x3), grid_shape=(2, 2, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


# --- ImageEncoder --------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head", [None, "mean", "max"])
def test_image_encoder_matches_jax(dtype, head):
    kw = dict(dtype=dtype, attention_impl="xla")
    if head is not None:
        kw.update(num_classes=7, pooling=head)
    x = np.random.RandomState(8).randn(2, 3, 75, 90).astype(np.float32)
    jm, p = jax_model(j_vit2d_xsmall(**kw), x)
    cfg = vit2d_xsmall(**kw)
    want = f32(jm.apply(p, jnp.asarray(x)))
    with torch.no_grad():
        got = port_model(cfg, p)(t(x))
    shape = (2, cfg.num_patches, cfg.d_model) if head is None else (2, 7)
    assert tuple(got.shape) == want.shape == shape
    assert got.dtype == (torch.float32 if head else TDT[dtype])
    np.testing.assert_allclose(got.float().numpy(), want,
                               **(F32_TOL if dtype == "float32" else BF16_TOL))


#: xsmall widened to medium's head dim (144 / 2 heads = 72) at 256 patches, so
#: the flash path runs at the shape class of vit2d_medium
FLASH_KW = dict(target_size=128, patch_size=8, d_model=144, num_heads=2,
                query_groups=1, d_ffn=288, num_layers=2, num_classes=5)


@pytest.mark.parametrize("dtype,head", [("float32", "mean"), ("float32", None),
                                        ("bfloat16", "max")])
def test_image_encoder_flash_path_matches_jax_kernel_interpret(dtype, head):
    x = np.random.RandomState(9).randn(2, 3, 128, 128).astype(np.float32)
    kw = dict(FLASH_KW, num_classes=head and 5, pooling=head or "mean")
    jcfg = j_vit2d_xsmall(dtype=dtype, attention_impl="flash_interpret", **kw)
    cfg = vit2d_xsmall(dtype=dtype, attention_impl="flash", **kw)
    assert cfg.num_patches == 256 and cfg.head_dim == 72
    jm, p = jax_model(jcfg, x)
    want = f32(jm.apply(p, jnp.asarray(x)))
    with torch.no_grad():
        got = port_model(cfg, p)(t(x)).numpy()
    np.testing.assert_allclose(got, want, **(F32_TOL if dtype == "float32" else
                                             dict(atol=5e-3, rtol=0.02)))


def test_image_encoder_gradients_match_jax_grad():
    """Smoothed CE's gradients through the port's flash path (the autograd
    Function over the plain K2' / K5 versions) under remat, against
    jax.grad of the same loss, leaf by leaf (fp32, dropout 0)."""
    from vats_tpu.train.vision import smoothed_ce as j_ce
    from vats_tpu_torch.train.vision import smoothed_ce

    x = np.random.RandomState(10).randn(2, 3, 128, 128).astype(np.float32)
    labels = np.array([1, 3])
    kw = dict(FLASH_KW, num_layers=1)
    jcfg = j_vit2d_xsmall(dtype="float32", attention_impl="xla", **kw)
    cfg = vit2d_xsmall(dtype="float32", attention_impl="flash", use_checkpointing=True, **kw)
    jm, p = jax_model(jcfg, x)

    def jloss(params):
        logits = jm.apply({"params": params}, jnp.asarray(x), deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(0)})
        return j_ce(logits, jnp.asarray(labels), 0.1, 5)

    jl, jg = jax.value_and_grad(jloss)(p["params"])
    model = port_model(cfg, p)
    loss = smoothed_ce(model(t(x), deterministic=False, dropout_seed=0), t(labels), 0.1, 5)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    want = params_from_jax(jax.device_get(jg), cfg)
    assert set(want) == {n for n, _ in model.named_parameters()}
    for name, g in want.items():
        np.testing.assert_allclose(model.get_parameter(name).grad.numpy(), g.numpy(),
                                   err_msg=name, **GRAD_TOL)
