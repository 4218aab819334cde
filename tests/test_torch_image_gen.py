"""The port's text->image stack against ``vats_tpu``, on the CPU.

Covers what tests/test_image_gen.py covers, each against the JAX package
with the same weights (``params_from_jax``; JAX runs its XLA paths on the
CPU), at ``image_gen_tiny_test`` (d64, 2 layers, 8 heads in 2 groups, head
dim 8, a 32-entry codebook, 32 px images -> an 8 x 8 latent grid):
the config, the '2d_ntk' RoPE functions, the cross-attention, the text
encoder with padding, the VQ-VAE encoder, quantizer and decoder, the
composite, the AR transformer's features and logits, cached decode (dense
and paged) against the full forward, greedy and sampled token generation,
the pipeline, two trainer steps, ``evaluate`` and the image-gen script.
Three traps have their own tests: the nearest resize of the image mask
(``nearest-exact``), flax's ``ConvTranspose(padding="SAME")`` at k4/s2 and
k3/s1 (the flipped kernel) and flax's BatchNorm running statistics.

Tolerances:
  * fp32: atol 2e-5, rtol 1e-5 on activations, logits and images (fp32 sums
    in another order); losses rtol 1e-5; indices and greedy tokens exact;
  * bf16: atol 0.05, rtol 0.02 on activations and logits (the packages round
    bf16 at other places, a few bf16 ulps over two layers); images atol
    1/128 (sigmoid outputs in [0, 1], one bf16 ulp at 1); the quantizer
    computes in fp32 from the same bf16 latents: indices exact;
  * greedy tokens in bf16: equal up to the first step where JAX's top two
    logits lie within twice the logit tolerance (a near tie, which either
    side may break; the test says which step it excused), the same rule as
    the LM's card-against-CPU parity;
  * trainer (fp32, dropout 0), two steps against vats_tpu's trainer:
    metrics rtol 1e-5 and BatchNorm statistics atol 5e-6, rtol 1e-5 after
    each step; each step's gradients atol 1e-6, rtol 1e-5 against eager
    ``jax.grad`` of the trainer's loss at the trainer's params (~1.5e-7
    seen: fp32 sums in another order); params after step 1 atol 5e-6,
    rtol 1e-5, except elements whose JAX gradient was below 1e-5 (100x the
    gradients' noise; the conv biases in front of a BatchNorm, zero in
    exact arithmetic, are such), held to Adam's bound of 2 lr a step:
    AdamW's lr * m / (sqrt(v) + eps) turns a 1e-7 difference of such a
    gradient into any update up to ~lr.  After step 2 every param is held
    to that bound only: the trainer's jitted gradient there differs from
    eager ``jax.grad`` at the same params by up to 1.5e-4 of 0.02 in the
    reconstruction's gradient into the encoder's convolutions (XLA's
    fusion), and AdamW's second update carries such differences into up
    to ~lr; the gradients themselves are held tightly above.  ``evaluate``
    on those params: losses atol 1e-5, rtol 1e-4 (3.4e-6 seen).
Sampled draws are not JAX's bits: sampled generation is checked for shape,
range and determinism under a seed.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax.linen import meta

import vats_tpu.configs.image_gen as jcfgmod
from vats_tpu.inference.image_generation import ImageGenerationPipeline as JPipeline
from vats_tpu.inference.image_generation import ImageGenerationSampler as JSampler
from vats_tpu.inference.image_generation import generate_image_tokens as j_gen
from vats_tpu.inference.image_generation import generate_image_tokens_paged as j_gen_paged
from vats_tpu.models import image_gen as jig
from vats_tpu.nn.cross_attention import CrossAttentionBlock as JCrossBlock
from vats_tpu.nn.rope import apply_rope_2d_ntk as j_ntk
from vats_tpu.nn.rope import apply_rope_2d_ntk_positions as j_ntk_pos
from vats_tpu.train.image_gen import ImageGenTrainer as JTrainer
from vats_tpu.train.image_gen import ImageGenTrainingArgs as JTrainingArgs
import vats_tpu_torch.configs.image_gen as tcfgmod
from vats_tpu_torch.inference import (
    ImageGenerationPipeline,
    ImageGenerationSampler,
    generate_image_tokens,
    generate_image_tokens_paged,
)
from vats_tpu_torch.models import image_gen as tig
from vats_tpu_torch.nn import CrossAttentionBlock
from vats_tpu_torch.nn.rope import apply_rope_2d_ntk, apply_rope_2d_ntk_positions
from vats_tpu_torch.scripts.image_gen import train as image_gen_script
from vats_tpu_torch.train import ImageGenTrainer, ImageGenTrainingArgs
from vats_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

F32_TOL = dict(atol=2e-5, rtol=1e-5)
BF16_TOL = dict(atol=0.05, rtol=0.02)
PARAM_TOL = dict(atol=5e-6, rtol=1e-5)
GRAD_TOL = dict(atol=1e-6, rtol=1e-5)
LR = 1e-3
FLAT_GRAD = 1e-5  # 100x the gradients' fp32 noise (~1e-7)
TOL = {"float32": F32_TOL, "bfloat16": BF16_TOL}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
DTYPES = ["float32", "bfloat16"]


def cfgs(dtype="float32", **kw):
    return jcfgmod.image_gen_tiny_test(dtype=dtype, **kw), tcfgmod.image_gen_tiny_test(
        dtype=dtype, **kw)


def t(x):
    return torch.from_numpy(np.array(x))


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def jinit(module, *args, seed=0, **kw):
    return jax.device_get(meta.unbox(module.init(jax.random.PRNGKey(seed), *args, **kw)))


def port(module, variables, cfg):
    module.load_state_dict(params_from_jax(variables, cfg))
    return module.eval()


def data(seed, b=2, txt=6, d=64, img=32):
    rs = np.random.RandomState(seed)
    images = rs.rand(b, 3, img, img).astype(np.float32)
    text = rs.randn(b, txt, d).astype(np.float32)
    tmask = np.ones((b, txt), bool)
    tmask[0, txt - 2:] = False
    imask = np.ones((b, img * img), bool)
    imask[1, img * img // 2 + 5:] = False
    return images, text, tmask, imask


# --- config, RoPE, the traps ---------------------------------------------------


def test_config_copy_matches_jax():
    fields = lambda c: [(f.name, f.default) for f in dataclasses.fields(c)]  # noqa: E731
    assert fields(tcfgmod.ImageGenArgs) == fields(jcfgmod.ImageGenArgs)
    for tier in ("image_gen_xsmall", "image_gen_tiny_test"):
        j, p = getattr(jcfgmod, tier)(), getattr(tcfgmod, tier)()
        assert dataclasses.asdict(p) == dataclasses.asdict(j) and p.head_dim == j.head_dim
    x = tcfgmod.image_gen_xsmall()
    assert (x.d_model, x.num_layers, x.num_heads, x.query_groups, x.head_dim,
            x.target_size // 4) == (768, 12, 32, 4, 24, 64)
    with pytest.raises(ValueError, match="divisible by 4"):
        tcfgmod.ImageGenArgs(d_model=60, num_heads=6, query_groups=2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ntk", [None, 0.7])
def test_rope_2d_ntk_functions_match_jax(dtype, ntk):
    x = np.random.RandomState(1).randn(2, 12, 3, 24).astype(np.float32)
    tol = dict(atol=1e-5) if dtype == "float32" else dict(atol=2**-7 * 4, rtol=2**-8)
    got = apply_rope_2d_ntk(t(x).to(TDT[dtype]), 3, 4, 10000.0, ntk)
    want = j_ntk(jnp.asarray(x).astype(JDT[dtype]), 3, 4, 10000.0, ntk)
    np.testing.assert_allclose(f32(got), f32(want), **tol)
    pos = np.array([[0, 5, 11], [3, 7, 10]], np.int32)  # [B, T] raster positions
    got = apply_rope_2d_ntk_positions(t(x[:, :3]).to(TDT[dtype]), t(pos), 4, 10000.0, ntk)
    want = j_ntk_pos(jnp.asarray(x[:, :3]).astype(JDT[dtype]), jnp.asarray(pos), 4, 10000.0,
                     ntk)
    np.testing.assert_allclose(f32(got), f32(want), **tol)
    # the positional form at arange(N) is the grid form
    full = apply_rope_2d_ntk(t(x), 3, 4, 10000.0, ntk)
    assert torch.equal(apply_rope_2d_ntk_positions(t(x), torch.arange(12), 4, 10000.0, ntk),
                       full)


@pytest.mark.parametrize("src,dst", [(16, 4), (32, 8), (10, 4), (7, 3)])
def test_mask_resize_is_nearest_exact(src, dst):
    m = np.random.RandomState(src).rand(2, 1, src, src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(m), (2, 1, dst, dst), method="nearest"))
    got = torch.nn.functional.interpolate(t(m), size=(dst, dst), mode="nearest-exact")
    np.testing.assert_array_equal(got.numpy(), want)
    if src == 16:  # half-pixel centres pick 2, 6, 10, 14; plain 'nearest' 0, 4, 8, 12
        np.testing.assert_array_equal(want[0, 0, :, 0], m[0, 0, [2, 6, 10, 14], 2])


@pytest.mark.parametrize("k,s", [(4, 2), (3, 1)])
def test_conv_transpose_same_is_flipped_conv_transpose2d(k, s):
    x = np.random.RandomState(k).randn(2, 5, 6, 7).astype(np.float32)  # NHWC
    jm = fnn.ConvTranspose(features=4, kernel_size=(k, k), strides=(s, s), padding="SAME")
    p = jinit(jm, jnp.asarray(x))["params"]
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(x)))
    w = t(np.ascontiguousarray(np.asarray(p["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1)))
    got = torch.nn.functional.conv_transpose2d(
        t(x).permute(0, 3, 1, 2), w, t(p["bias"]), s, 1).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 5 * s, 6 * s, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    unflipped = torch.nn.functional.conv_transpose2d(
        t(x).permute(0, 3, 1, 2), t(np.asarray(p["kernel"]).transpose(2, 3, 0, 1)),
        t(p["bias"]), s, 1).permute(0, 2, 3, 1)
    assert np.abs(unflipped.numpy() - want).max() > 1e-2  # the trap


def test_batch_norm_running_statistics_match_flax_after_two_steps():
    rs = np.random.RandomState(3)
    jm = fnn.BatchNorm()
    x0 = rs.randn(4, 5, 5, 6).astype(np.float32) * 3 + 1
    v = jinit(jm, jnp.asarray(x0), use_running_average=False)
    bn = tig.BatchNorm(6, torch.float32, torch.float32, device="cpu")
    for step in range(2):
        x = rs.randn(4, 5, 5, 6).astype(np.float32) * (2 + step) - step
        want, mut = jm.apply(v, jnp.asarray(x), use_running_average=False,
                             mutable=["batch_stats"])
        v = {"params": v["params"], "batch_stats": mut["batch_stats"]}
        got = bn(t(x).permute(0, 3, 1, 2), use_running_average=False).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32_TOL)
        stats = jax.device_get(mut["batch_stats"])
        np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"], atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(), stats["var"], atol=1e-6, rtol=1e-6)
    want = jm.apply(v, jnp.asarray(x0), use_running_average=True)
    got = bn(t(x0).permute(0, 3, 1, 2), use_running_average=True).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32_TOL)


# --- modules -------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention_block_matches_jax(dtype):
    _, text, tmask, _ = data(4)
    x = np.random.RandomState(5).randn(2, 9, 64).astype(np.float32)
    jm = JCrossBlock(64, 8, softmax_scale=0.3, num_layers=2, dtype=JDT[dtype])
    p = jinit(jm, jnp.asarray(x), jnp.asarray(text), jnp.asarray(tmask))["params"]
    want = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(text), jnp.asarray(tmask))
    tm = CrossAttentionBlock(64, 8, softmax_scale=0.3, num_layers=2, dtype=TDT[dtype])
    sd = {"norm.weight": t(p["RMSNorm_0"]["weight"])}
    for n in ("w_q", "w_k", "w_v", "w_o"):
        sd[f"attn.{n}.weight"] = t(np.asarray(p["CrossAttention_0"][n]["kernel"]).T)
    tm.load_state_dict(sd)
    with torch.no_grad():
        got = tm(t(x), t(text), t(tmask))
    np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_text_encoder_with_padding_matches_jax(dtype):
    jcfg, cfg = cfgs(dtype)
    rs = np.random.RandomState(6)
    ids = rs.randint(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    mask = np.concatenate([np.ones((2, 8), bool), np.zeros((2, 4), bool)], 1)
    jm = jig.TransformerTextEncoder(jcfg)
    v = jinit(jm, jnp.asarray(ids))
    want = jm.apply(v, jnp.asarray(ids), padding_mask=jnp.asarray(mask))
    tm = port(tig.TransformerTextEncoder(cfg, device="cpu"), v, cfg)
    with torch.no_grad():
        got = tm(t(ids), padding_mask=t(mask))
        ids2 = ids.copy()
        ids2[:, 9:] = 7  # padded content must not reach valid positions
        got2 = tm(t(ids2), padding_mask=t(mask))
    assert got.shape == (2, 12, cfg.d_model) and got.dtype == TDT[dtype]
    np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])
    assert torch.equal(got[:, :8], got2[:, :8])


@pytest.mark.parametrize("dtype", DTYPES)
def test_vqvae_encoder_and_decoder_match_jax(dtype):
    jcfg, cfg = cfgs(dtype)
    images = data(7)[0]
    je = jig.VQVAEEncoder(jcfg)
    ve = jinit(je, jnp.asarray(images))
    jz = je.apply(ve, jnp.asarray(images))
    te = port(tig.VQVAEEncoder(cfg, device="cpu"), ve, cfg)
    with torch.no_grad():
        z = te(t(images))
    assert z.shape == (2, 8, 8, cfg.d_model)
    np.testing.assert_allclose(f32(z), f32(jz), **TOL[dtype])
    jd = jig.VQVAEDecoder(jcfg)
    vd = jinit(jd, jz, seed=1)
    want = jd.apply(vd, jz)
    td = port(tig.VQVAEDecoder(cfg, device="cpu"), vd, cfg)
    with torch.no_grad():
        got = td(t(f32(jz)).to(TDT[dtype]))
    assert got.shape == (2, 3, 32, 32) and 0 <= float(got.min()) and float(got.max()) <= 1
    tol = F32_TOL if dtype == "float32" else dict(atol=1 / 128)
    np.testing.assert_allclose(f32(got), f32(want), **tol)


def test_quantizer_indices_loss_and_straight_through_gradient():
    jcfg, cfg = cfgs()
    z = np.random.RandomState(8).randn(2, 4, 4, cfg.d_model).astype(np.float32) * 0.05
    jq = jig.VectorQuantizer(jcfg)
    v = jinit(jq, jnp.asarray(z))
    jz_q, jloss, jidx = jq.apply(v, jnp.asarray(z))
    tq = port(tig.VectorQuantizer(cfg, device="cpu"), v, cfg)
    zt = t(z).requires_grad_(True)
    z_q, loss, idx = tq(zt)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(z_q.detach().numpy(), np.asarray(jz_q), **F32_TOL)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    cb = np.asarray(v["params"]["embedding"])
    np.testing.assert_allclose(z_q.detach().numpy(), cb[idx.numpy()], atol=1e-6)
    # gradients of z_q^2 + loss w.r.t. z (straight through) and the codebook

    def jfun(params, zz):
        out, l_, _ = jq.apply(params, zz)
        return jnp.sum(out ** 2) + l_

    jgp, jgz = jax.grad(jfun, argnums=(0, 1))(v, jnp.asarray(z))
    (z_q.square().sum() + loss).backward()
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(jgz), **F32_TOL)
    np.testing.assert_allclose(tq.embedding.grad.numpy(),
                               np.asarray(jgp["params"]["embedding"]), **F32_TOL)


@pytest.fixture(scope="module")
def ar32():
    jcfg, cfg = cfgs()
    jm = jig.AutoregressiveImageTransformer(jcfg)
    p = jinit(jm, jnp.zeros((2, 4, 4), jnp.int32), jnp.zeros((2, 6, cfg.d_model)), seed=7)
    tm = port(tig.AutoregressiveImageTransformer(cfg, device="cpu"), p, cfg)
    return jm, p, tm, cfg


@pytest.mark.parametrize("dtype", DTYPES)
def test_ar_transformer_features_and_logits_match_jax(dtype):
    jcfg, cfg = cfgs(dtype)
    jm = jig.AutoregressiveImageTransformer(jcfg)
    p = jinit(jm, jnp.zeros((2, 4, 4), jnp.int32), jnp.zeros((2, 6, cfg.d_model)), seed=7)
    tm = port(tig.AutoregressiveImageTransformer(cfg, device="cpu"), p, cfg)
    _, text, tmask, _ = data(9)
    idx = np.random.RandomState(10).randint(0, cfg.num_embeddings, (2, 4, 4))
    cmask = np.ones((2, 16), bool)
    cmask[1, 11:] = False
    jf = jm.apply(p, jnp.asarray(idx), jnp.asarray(text), jnp.asarray(cmask), jnp.asarray(tmask))
    jl, _ = jm.apply(p, jnp.asarray(idx), jnp.asarray(text), return_logits=True)
    with torch.no_grad():
        feats = tm(t(idx), t(text), t(cmask), t(tmask))
        logits, cache = tm(t(idx), t(text), return_logits=True)
    assert feats.shape == (2, 4, 4, cfg.d_model) and cache is None
    assert logits.shape == (2, 16, cfg.num_embeddings) and logits.dtype == torch.float32
    np.testing.assert_allclose(f32(feats), f32(jf), **TOL[dtype])
    np.testing.assert_allclose(f32(logits), f32(jl), **TOL[dtype])


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_cached_decode_matches_full_forward(ar32, paged):
    """Raster-order cached decode, one token a step, against the full
    forward: the port's to 2e-5 (fp32), and its steps against JAX's."""
    jm, p, tm, cfg = ar32
    _, text, tmask, _ = data(11)
    idx = np.random.RandomState(12).randint(0, cfg.num_embeddings, (2, 4, 4))
    with torch.no_grad():
        full, _ = tm(t(idx), t(text), cross_padding_mask=t(tmask), return_logits=True)
    flat = idx.reshape(2, 16)
    if paged:
        tc, jc = tm.init_paged_cache(2, 17), jm.init_paged_cache(2, 17)
        kw = "paged_cache"
    else:
        tc, jc = tm.init_cache(2, 16), jm.init_cache(2, 16)
        kw = "cache"
    for i in range(16):
        with torch.no_grad():
            step, _ = tm(t(flat[:, i:i + 1]), t(text), cross_padding_mask=t(tmask),
                         grid_w=4, return_logits=True, **{kw: tc})
        jstep, jc = jm.apply(p, jnp.asarray(flat[:, i:i + 1]), jnp.asarray(text),
                             cross_padding_mask=jnp.asarray(tmask), grid_w=4,
                             return_logits=True, **{kw: jc})
        np.testing.assert_allclose(step[:, 0].numpy(), full[:, i].numpy(), **F32_TOL)
        np.testing.assert_allclose(step[:, 0].numpy(), np.asarray(jstep)[:, 0], **F32_TOL)


def greedy_agree(got, want, jlogit_gaps, tol):
    """Tokens equal up to the first near tie of JAX's top two logits
    (gap <= 2 * tol); returns the excused step or None."""
    got, want = got.reshape(got.shape[0], -1), want.reshape(want.shape[0], -1)
    for i in range(got.shape[1]):
        if (got[:, i] != want[:, i]).any():
            assert (jlogit_gaps[:, i] <= 2 * tol).any(), f"tokens differ at step {i}"
            return i
    return None


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_greedy_image_tokens_match_jax(dtype, paged):
    jcfg, cfg = cfgs(dtype)
    jm = jig.AutoregressiveImageTransformer(jcfg)
    p = jinit(jm, jnp.zeros((2, 4, 4), jnp.int32), jnp.zeros((2, 6, cfg.d_model)), seed=7)
    tm = port(tig.AutoregressiveImageTransformer(cfg, device="cpu"), p, cfg)
    _, text, tmask, _ = data(13)
    kw = dict(grid_h=4, grid_w=4, temperature=0.0, do_sample=False)
    jf, tf = (j_gen_paged, generate_image_tokens_paged) if paged else (j_gen,
                                                                        generate_image_tokens)
    want = np.asarray(jf(jm, p, jnp.asarray(text), jnp.asarray(tmask), jax.random.PRNGKey(0),
                         **kw))
    got = tf(tm, t(text), t(tmask), None, **kw).numpy()
    assert got.shape == (2, 4, 4) and got.dtype == np.int32
    if dtype == "float32":
        np.testing.assert_array_equal(got, want)
        return
    # JAX's top-two gaps along its own tokens (teacher forced)
    seq = np.concatenate([np.zeros((2, 1), np.int32), want.reshape(2, 16)[:, :15]], 1)
    jl, _ = jm.apply(p, jnp.asarray(seq), jnp.asarray(text), jnp.asarray(np.ones((2, 16), bool)),
                     jnp.asarray(tmask), grid_w=4, return_logits=True)
    top2 = np.sort(np.asarray(jl), -1)[..., -2:]
    excused = greedy_agree(got, want, top2[..., 1] - top2[..., 0], BF16_TOL["atol"])
    print("bf16 greedy tokens: near tie excused at step", excused)


def test_paged_decode_equals_dense_and_sampling_is_seeded(ar32):
    jm, p, tm, cfg = ar32
    _, text, _, _ = data(14)
    kw = dict(grid_h=4, grid_w=4, temperature=0.0, do_sample=False)
    assert torch.equal(generate_image_tokens(tm, t(text), None, None, **kw),
                       generate_image_tokens_paged(tm, t(text), None, None, **kw))
    kw = dict(grid_h=4, grid_w=4, temperature=0.9, top_k=8, top_p=0.9, do_sample=True)
    runs = [fn(tm, t(text), None, torch.Generator().manual_seed(s), **kw)
            for fn in (generate_image_tokens, generate_image_tokens_paged) for s in (3, 3, 4)]
    for r in runs:
        assert r.shape == (2, 4, 4) and 0 <= int(r.min()) and int(r.max()) < cfg.num_embeddings
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    assert torch.equal(runs[3], runs[4])


@pytest.mark.parametrize("dtype", DTYPES)
def test_vqvae_composite_with_masks_matches_jax(dtype):
    jcfg, cfg = cfgs(dtype)
    images, text, tmask, imask = data(15)
    jm = jig.VQVAE(jcfg)
    v = jinit(jm, jnp.asarray(images), jnp.asarray(text))
    want = jm.apply(v, jnp.asarray(images), jnp.asarray(text), jnp.asarray(imask),
                    jnp.asarray(tmask))
    tm = port(tig.VQVAE(cfg, device="cpu"), v, cfg)
    with torch.no_grad():
        got = tm(t(images), t(text), t(imask), t(tmask))
    recon, vq, idx, feats = got
    assert recon.shape == (2, 3, 32, 32) and idx.shape == (2, 8, 8)
    assert feats.shape == (2, 8, 8, cfg.d_model)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(float(vq), float(want[1]), rtol=1e-5)
    np.testing.assert_allclose(f32(recon), f32(want[0]),
                               **(F32_TOL if dtype == "float32" else dict(atol=1 / 128)))
    np.testing.assert_allclose(f32(feats), f32(want[3]), **TOL[dtype])


# --- training ------------------------------------------------------------------


def trainers(masks: bool, **cfg_kw):
    jcfg, cfg = cfgs(**cfg_kw)
    images, text, tmask, imask = data(16)
    batch = {"images": images, "text_embeddings": text}
    if masks:
        batch.update(image_attention_mask=imask, text_attention_mask=tmask)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jt = JTrainer(jcfg, JTrainingArgs(learning_rate=LR), num_training_steps=10,
                  sample_batch=jb)
    v = {"params": meta.unbox(jax.device_get(jt.params)),
         "batch_stats": jax.device_get(jt.batch_stats)}
    tt = ImageGenTrainer(cfg, ImageGenTrainingArgs(learning_rate=LR), num_training_steps=10,
                         variables=params_from_jax(v, cfg), device="cpu")
    return jt, tt, jb, batch, cfg


def jax_state(jt, cfg):
    return params_from_jax({"params": meta.unbox(jax.device_get(jt.params)),
                            "batch_stats": jax.device_get(jt.batch_stats)}, cfg)


def jax_loss(jt, jb):
    """vats_tpu's ImageGenTrainer loss (VQ + recon + token CE,
    train/image_gen.py:113-128) as a function of (params, batch_stats),
    with the new batch_stats as its aux."""

    def loss_fn(params, batch_stats):
        (recon, vq, idx, feats), mut = jt.model.apply(
            {"params": params, "batch_stats": batch_stats}, jb["images"],
            jb["text_embeddings"], jb.get("image_attention_mask"),
            jb.get("text_attention_mask"), deterministic=False,
            rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        b, h, w, d = feats.shape
        kern = meta.unbox(params["model"]["to_logits"]["kernel"])
        logp = jax.nn.log_softmax(
            (feats.reshape(b, h * w, d).astype(jnp.float32) @ kern)[:, :-1], axis=-1)
        ce = -jnp.take_along_axis(logp, idx.reshape(b, h * w)[:, 1:, None], axis=-1).mean()
        loss = vq + jnp.mean((recon.astype(jnp.float32) - jb["images"]) ** 2) + ce
        return loss, mut["batch_stats"]

    return loss_fn


@pytest.mark.parametrize("masks", [False, True], ids=["no_masks", "masks"])
def test_two_trainer_steps_and_evaluate_match_jax(masks):
    """Two steps against vats_tpu's trainer: metrics and BatchNorm
    statistics after each; each step's gradients against eager ``jax.grad``
    of the trainer's loss at the trainer's params; the params after step 1
    tightly, after step 2 within Adam's bound (see the module docstring)."""
    jt, tt, jb, batch, cfg = trainers(masks)
    grad_fn = jax.grad(jax_loss(jt, jb), has_aux=True)
    flat = {}  # per param: elements whose JAX gradient was ever below FLAT_GRAD
    for step in (1, 2):
        g, _ = grad_fn(jt.params, jt.batch_stats)
        jg = params_from_jax({"params": meta.unbox(jax.device_get(g))}, cfg)
        jm, tm = jt.train_step(jb), tt.train_step(batch)
        assert set(tm) == set(jm) == {"loss", "vq_loss", "recon_loss", "token_ce"}
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, err_msg=k)
        for name, p in tt.model.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), jg[name].numpy(), err_msg=name,
                                       **GRAD_TOL)
            flat[name] = flat.get(name, False) | (jg[name].abs() < FLAT_GRAD)
        want, got = jax_state(jt, cfg), tt.model.state_dict()
        assert set(got) == set(want) and any("running_var" in n for n in got)
        for name in got:
            err = (got[name] - want[name]).abs()
            bound = PARAM_TOL["atol"] + PARAM_TOL["rtol"] * want[name].abs()
            if name in flat:  # Adam's bound, 2 lr a step
                bound = torch.where(flat[name] | (step > 1), 2 * LR * step, bound)
            assert bool((err <= bound).all()), f"{name} at step {step}: {float(err.max())}"
    jev = jt.evaluate(iter([jb, jb]), max_batches=2)
    ev = tt.evaluate(iter([batch, batch]), max_batches=2)
    assert ev["batches"] == jev["batches"] == 2
    for k in ("loss", "vq_loss", "recon_loss"):  # on step 2's params
        np.testing.assert_allclose(ev[k], jev[k], atol=1e-5, rtol=1e-4, err_msg=k)


def test_trainer_remat_equals_no_remat_and_train_loop():
    """``use_checkpointing`` recomputes the transformer's blocks in the
    backward: the same step to 1e-6 as without; ``train`` averages."""
    out = []
    for remat in (False, True):
        cfg = tcfgmod.image_gen_tiny_test(dtype="float32", use_checkpointing=remat)
        tt = ImageGenTrainer(cfg, ImageGenTrainingArgs(learning_rate=1e-3, seed=3),
                             num_training_steps=10, device="cpu")
        images, text, _, _ = data(17)
        m = tt.train({"images": images, "text_embeddings": text} for _ in range(2))
        assert m["steps"] == 2 and np.isfinite(m["loss"])
        out.append({n: p.detach().clone() for n, p in tt.model.named_parameters()})
    for n in out[0]:
        np.testing.assert_allclose(out[1][n].numpy(), out[0][n].numpy(), atol=1e-6, err_msg=n)


def test_pipeline_greedy_matches_jax():
    jcfg, cfg = cfgs()
    ids = np.random.RandomState(18).randint(1, cfg.vocab_size, (1, 8)).astype(np.int32)
    je = jig.TransformerTextEncoder(jcfg)
    ve = jinit(je, jnp.asarray(ids), seed=23)
    ja = jig.AutoregressiveImageTransformer(jcfg)
    va = jinit(ja, jnp.zeros((1, 4, 4), jnp.int32), jnp.zeros((1, 8, cfg.d_model)), seed=24)
    jd = jig.VQVAEDecoder(jcfg)
    vd = jinit(jd, jnp.zeros((1, 4, 4, cfg.d_model)), seed=25)
    cb = np.asarray(jax.random.normal(jax.random.PRNGKey(26), (cfg.num_embeddings, cfg.d_model)))
    jp = JPipeline(jcfg, ve, va, vd, jnp.asarray(cb))
    sampler = dict(temperature=0.0, do_sample=False)
    jimg, jtok = jp.generate_images(jnp.asarray(ids), jax.random.PRNGKey(27), grid_h=4,
                                    grid_w=4, sampler=JSampler(**sampler))
    tp = ImageGenerationPipeline(cfg, params_from_jax(ve, cfg), params_from_jax(va, cfg),
                                 params_from_jax(vd, cfg), t(cb), device="cpu")
    img, tok = tp.generate_images(t(ids), None, grid_h=4, grid_w=4,
                                  sampler=ImageGenerationSampler(**sampler))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    assert img.shape == (1, 3, 16, 16) and 0 <= float(img.min()) and float(img.max()) <= 1
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), **F32_TOL)
    # random weights from a seed, sampled: shapes, range and the seed's draws
    rp = ImageGenerationPipeline(cfg, seed=1, device="cpu")
    kw = dict(grid_h=2, grid_w=3, sampler=ImageGenerationSampler(0.9, top_k=8, top_p=0.9))
    a = rp.generate_images(t(ids), torch.Generator().manual_seed(5), **kw)
    b = rp.generate_images(t(ids), torch.Generator().manual_seed(5), **kw)
    assert a[0].shape == (1, 3, 8, 12) and a[1].shape == (1, 2, 3)
    assert torch.equal(a[1], b[1]) and torch.equal(a[0], b[0])


# --- entry points -------------------------------------------------------------


def test_image_gen_script_trains_and_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = image_gen_script.main(["--device", "cpu", "--steps", "3", "--log-every", "1",
                                 "--batch-size", "2"])
    assert len(out["history"]) == 3 and len(out["step_s"]) == 3
    for m in out["history"]:
        assert set(m) == {"loss", "vq_loss", "recon_loss", "token_ce"}
        assert np.isfinite(m["loss"])
    assert int(out["trainer"].state.step) == 3
    assert os.listdir(tmp_path) == []
    out = image_gen_script.main(["--device", "cpu", "--steps", "1", "--log-dir",
                                 str(tmp_path / "logs")])
    assert os.listdir(tmp_path) == ["logs"]
    assert os.listdir(tmp_path / "logs") == ["training.log"]


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    cfg = tcfgmod.image_gen_tiny_test()
    for make in (lambda: tig.AutoregressiveImageTransformer(cfg),
                 lambda: tig.VQVAE(cfg), lambda: tig.TransformerTextEncoder(cfg),
                 lambda: ImageGenerationPipeline(cfg),
                 lambda: ImageGenTrainer(cfg, ImageGenTrainingArgs()),
                 lambda: image_gen_script.main(["--steps", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
