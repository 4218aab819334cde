"""The port's text->video stack against ``vats_tpu``, on the CPU.

Covers what tests/test_video_gen.py covers, each against the JAX package
with the same weights (``params_from_jax``; JAX runs XLA's attention, as its
video model always does), at ``video_gen_tiny_test`` (d48, 2 layers, 4 heads
in 2 groups of head dim 12, a 4 x 4 latent grid, patches (2, 4, 4), 2 latent
frames, a 32-entry codebook): the config, both factorized attentions, the
transformer's features and logits, cached frame-by-frame decode, the read
mode, greedy token generation, the 3-D VQ-VAE in train and eval mode with
its BatchNorm statistics, the pipeline, two steps of each trainer, the
script.  The 3-D traps have their own test: flax's ConvTranspose at 3x3x3
'SAME' and k=s=patch 'VALID' is ``conv_transpose3d`` with the kernel flipped
in all three spatial axes.

Tolerances, as tests/test_torch_image_gen.py states and argues them:
  * fp32: atol 2e-5, rtol 1e-5 on activations, logits and videos; losses
    rtol 1e-5; indices and greedy tokens exact;
  * bf16: atol 0.05, rtol 0.02 on activations and logits; videos atol
    1/128 (one bf16 ulp at 1); greedy tokens equal up to the first near tie
    of JAX's top two logits (gap <= 2 * atol), which the test names;
  * trainers (fp32, dropout 0), two steps against vats_tpu's trainers:
    losses rtol 1e-5, BatchNorm statistics atol 5e-6, rtol 1e-5 after each
    step; each step's gradients atol 1e-6, rtol 1e-5 against ``jax.grad``
    at the trainer's params (eager for the VQ-VAE, whose jitted gradient
    differs by XLA's fusion; jitted for the token trainer, where the two
    agree to 6e-8); params after step 1 atol 5e-6,
    rtol 1e-5 except elements whose JAX gradient was below 1e-5 (the conv
    biases in front of a BatchNorm have zero gradient in exact arithmetic),
    held to Adam's bound of 2 lr a step, as after step 2 every param is
    (the jitted step's gradient differs from eager ``jax.grad`` by XLA's
    fusion, and AdamW carries such differences into up to ~lr).
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

import vats_tpu.configs.video_gen as jcfgmod
from vats_tpu.configs.image_gen import image_gen_tiny_test as j_img_tiny
from vats_tpu.inference.video_generation import VideoGenerationPipeline as JPipeline
from vats_tpu.inference.video_generation import VideoGenerationSampler as JSampler
from vats_tpu.inference.video_generation import generate_video_tokens as j_gen
from vats_tpu.models import video_gen as jvg
from vats_tpu.models.image_gen import TransformerTextEncoder as JTextEncoder
from vats_tpu.nn.kv_cache import KVCache as JKVCache
from vats_tpu.train.video_gen import VideoGenTrainingArgs as JTrainingArgs
from vats_tpu.train.video_gen import VideoTokenTrainer as JTokenTrainer
from vats_tpu.train.video_gen import VQVAE3DTrainer as JVQTrainer
import vats_tpu_torch.configs.video_gen as tcfgmod
from vats_tpu_torch.configs import image_gen_tiny_test
from vats_tpu_torch.inference import (
    VideoGenerationPipeline,
    VideoGenerationSampler,
    generate_video_tokens,
)
from vats_tpu_torch.models import TransformerTextEncoder
from vats_tpu_torch.models import video_gen as tvg
from vats_tpu_torch.nn.kv_cache import KVCache
from vats_tpu_torch.scripts.video_gen import train as video_gen_script
from vats_tpu_torch.train import VideoGenTrainingArgs, VideoTokenTrainer, VQVAE3DTrainer
from vats_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

F32_TOL = dict(atol=2e-5, rtol=1e-5)
BF16_TOL = dict(atol=0.05, rtol=0.02)
PARAM_TOL = dict(atol=5e-6, rtol=1e-5)
GRAD_TOL = dict(atol=1e-6, rtol=1e-5)
LR = 1e-3
FLAT_GRAD = 1e-5
TOL = {"float32": F32_TOL, "bfloat16": BF16_TOL}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
DTYPES = ["float32", "bfloat16"]
GH = GW = 4
LAT_T = 2
D = 48


def cfgs(dtype="float32", **kw):
    return jcfgmod.video_gen_tiny_test(dtype=dtype, **kw), tcfgmod.video_gen_tiny_test(
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


def data(seed, b=2, txt=5):
    rs = np.random.RandomState(seed)
    idx = rs.randint(0, 32, (b, LAT_T, GH, GW)).astype(np.int32)
    text = rs.randn(b, txt, D).astype(np.float32)
    tmask = np.ones((b, txt), bool)
    tmask[-1, txt - 2:] = False
    return idx, text, tmask


def transformer(dtype="float32", seed=0):
    jcfg, cfg = cfgs(dtype)
    jm = jvg.AutoregressiveVideoTransformer(jcfg)
    p = jinit(jm, jnp.zeros((1, LAT_T, GH, GW), jnp.int32), jnp.zeros((1, 5, D)), seed=seed)
    return jm, p, port(tvg.AutoregressiveVideoTransformer(cfg, device="cpu"), p, cfg), cfg


@pytest.fixture(scope="module")
def ar32():
    return transformer()


# --- config and the 3-D traps -----------------------------------------------------


def test_config_copy_matches_jax():
    fields = lambda c: [(f.name, f.default) for f in dataclasses.fields(c)]  # noqa: E731
    assert fields(tcfgmod.VideoGenArgs) == fields(jcfgmod.VideoGenArgs)
    for tier in ("video_gen_xsmall", "video_gen_large", "video_gen_tiny_test"):
        j, p = getattr(jcfgmod, tier)(), getattr(tcfgmod, tier)()
        assert dataclasses.asdict(p) == dataclasses.asdict(j) and p.head_dim == j.head_dim
    x = tcfgmod.video_gen_large()
    assert (x.d_model, x.num_layers, x.num_heads, x.query_groups, x.head_dim,
            x.latent_height, x.max_frames // x.patch_size[0], x.num_embeddings) == (
                1728, 20, 12, 4, 144, 16, 15, 256)
    with pytest.raises(ValueError, match="divisible by 6"):
        tcfgmod.VideoGenArgs(d_model=64, num_heads=8, query_groups=4)


@pytest.mark.parametrize("k,s", [((3, 3, 3), (1, 1, 1)), ((2, 4, 4), (2, 4, 4))],
                         ids=["3x3x3_same", "patch_valid"])
def test_conv_transpose_3d_is_flipped_conv_transpose3d(k, s):
    pad = "SAME" if s == (1, 1, 1) else "VALID"
    x = np.random.RandomState(1).randn(2, 3, 4, 5, 6).astype(np.float32)  # NTHWC
    jm = fnn.ConvTranspose(features=4, kernel_size=k, strides=s, padding=pad)
    p = jinit(jm, jnp.asarray(x))["params"]
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(x)))
    kern = np.asarray(p["kernel"])
    w = t(np.ascontiguousarray(kern[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2)))
    padding = 1 if pad == "SAME" else 0
    conv = lambda w_: torch.nn.functional.conv_transpose3d(  # noqa: E731
        t(x).permute(0, 4, 1, 2, 3), w_, t(p["bias"]), s, padding).permute(0, 2, 3, 4, 1)
    got = conv(w)
    assert got.shape == want.shape == (2, 3 * s[0], 4 * s[1], 5 * s[2], 4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    unflipped = conv(t(np.ascontiguousarray(kern.transpose(3, 4, 0, 1, 2))))
    assert np.abs(unflipped.numpy() - want).max() > 1e-2  # the trap


# --- the two attentions -------------------------------------------------------------


def factorized_state(p):
    return {f"{n}.weight": t(np.asarray(p[n]["kernel"]).T.copy())
            for n in ("q_proj", "k_proj", "v_proj", "spatio_temporal_proj", "o_proj")}


@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_factorized_attention_matches_jax(dtype):
    """Both branches with a partly decoded frame's spatial mask, uncached
    over two frames; and one cached frame after one appended, in read mode."""
    jcfg, cfg = cfgs(dtype)
    rs = np.random.RandomState(2)
    x = rs.randn(2, LAT_T, GH * GW, D).astype(np.float32)
    valid = np.arange(GH * GW)[None, :] <= np.array([[9], [15]])
    jm = jvg.CausalFactorizedAttention(jcfg)
    p = jinit(jm, jnp.asarray(x))["params"]
    tm = tvg.CausalFactorizedAttention(cfg, device="cpu")
    tm.load_state_dict(factorized_state(p))
    xj = jnp.asarray(x).astype(JDT[dtype])
    xt = t(x).to(TDT[dtype])
    want, _ = jm.apply({"params": p}, xj, spatial_valid=jnp.asarray(valid))
    with torch.no_grad():
        got, cache = tm(xt, spatial_valid=t(valid))
    assert cache is None and got.dtype == TDT[dtype]
    np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])
    # the temporal cache: frame 0 appended, then frame 1 read
    shape = dict(num_layers=1, batch_size=2 * GH * GW, max_seq_len=LAT_T, kv_heads=2,
                 head_dim=12)
    jc = JKVCache.create(dtype=JDT[dtype], **shape)
    tc = KVCache.create(dtype=TDT[dtype], device="cpu", **shape)
    for f, mode in ((0, "append"), (1, "read")):
        want, jc = jm.apply({"params": p}, xj[:, f:f + 1], cache=jc, cache_mode=mode,
                            spatial_valid=jnp.asarray(valid))
        with torch.no_grad():
            got, tc = tm(xt[:, f:f + 1], cache=tc, cache_mode=mode, spatial_valid=t(valid))
        if mode == "append":
            jc, tc = jc.advance(1), tc.advance(1)
        np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_factorized_cross_attention_matches_jax(dtype):
    jcfg, cfg = cfgs(dtype)
    rs = np.random.RandomState(3)
    x = rs.randn(2, LAT_T, GH * GW, D).astype(np.float32)
    _, text, tmask = data(4)
    jm = jvg.FactorizedCrossAttention(jcfg)
    p = jinit(jm, jnp.asarray(x), jnp.asarray(text), jnp.asarray(tmask))["params"]
    tm = tvg.FactorizedCrossAttention(cfg, device="cpu")
    tm.load_state_dict(factorized_state(p))
    want = jm.apply({"params": p}, jnp.asarray(x).astype(JDT[dtype]), jnp.asarray(text),
                    jnp.asarray(tmask))
    with torch.no_grad():
        got = tm(t(x).to(TDT[dtype]), t(text), t(tmask))
        unmasked = tm(t(x).to(TDT[dtype]), t(text), None)
    np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])
    # the mask reaches the padded row (row 1) and only it
    assert torch.equal(got[0], unmasked[0]) and not torch.equal(got[1], unmasked[1])


# --- the transformer ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_transformer_features_and_logits_match_jax(dtype):
    jm, p, tm, cfg = transformer(dtype, seed=5)
    idx, text, tmask = data(6)
    jf = jm.apply(p, jnp.asarray(idx), jnp.asarray(text), jnp.asarray(tmask))
    jl, _ = jm.apply(p, jnp.asarray(idx), jnp.asarray(text), return_logits=True)
    with torch.no_grad():
        feats = tm(t(idx), t(text), t(tmask))
        logits, cache = tm(t(idx), t(text), return_logits=True)
    assert feats.shape == (2, LAT_T, GH, GW, D) and cache is None
    assert logits.shape == (2, LAT_T, GH * GW, cfg.num_embeddings)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(f32(feats), f32(jf), **TOL[dtype])
    np.testing.assert_allclose(f32(logits), f32(jl), **TOL[dtype])


def test_cached_frame_decode_matches_full_forward_and_jax(ar32):
    """Frame-by-frame ``append`` forwards against the full forward (the
    port's to 2e-5) and against JAX's cached steps."""
    jm, p, tm, cfg = ar32
    idx, text, tmask = data(7)
    with torch.no_grad():
        full, _ = tm(t(idx), t(text), t(tmask), return_logits=True)
    jc, tc = jm.init_cache(2), tm.init_cache(2)
    assert tuple(tc.k.shape) == (2, 2 * GH * GW, 2, 16, LAT_T)  # hd 12 stored as 16
    for f in range(LAT_T):
        with torch.no_grad():
            step, tc = tm(t(idx[:, f:f + 1]), t(text), t(tmask), cache=tc, return_logits=True)
        jstep, jc = jm.apply(p, jnp.asarray(idx[:, f:f + 1]), jnp.asarray(text),
                             jnp.asarray(tmask), cache=jc, return_logits=True)
        assert int(tc.length) == int(jc.length) == f + 1
        np.testing.assert_allclose(step[:, 0].numpy(), full[:, f].numpy(), **F32_TOL)
        np.testing.assert_allclose(step.numpy(), np.asarray(jstep), **F32_TOL)


def test_cache_read_mode_does_not_persist(ar32):
    """A read forward leaves the length and every slot below it as they
    were (it may write the slot at the length, which the frame's append
    overwrites); its logits equal JAX's read and the append that follows."""
    jm, p, tm, cfg = ar32
    idx, text, _ = data(8, b=1)
    jc, tc = jm.init_cache(1), tm.init_cache(1)
    with torch.no_grad():
        _, tc = tm(t(idx[:, :1]), t(text), cache=tc, return_logits=True)
    _, jc = jm.apply(p, jnp.asarray(idx[:, :1]), jnp.asarray(text), cache=jc,
                     return_logits=True)
    before = (tc.k[..., :1].clone(), tc.v[..., :1].clone())
    for mode in ("read", "read", "append"):
        with torch.no_grad():
            got, tc = tm(t(idx[:, 1:]), t(text), cache=tc, cache_mode=mode, return_logits=True)
        want, jc_new = jm.apply(p, jnp.asarray(idx[:, 1:]), jnp.asarray(text), cache=jc,
                                cache_mode=mode, return_logits=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
        if mode == "read":
            assert int(tc.length) == int(jc_new.length) == 1
            assert torch.equal(tc.k[..., :1], before[0]) and torch.equal(tc.v[..., :1], before[1])
    assert int(tc.length) == int(jc_new.length) == 2
    with pytest.raises(ValueError, match="cache_mode"):
        tm(t(idx[:, 1:]), t(text), cache=tc, cache_mode="peek")


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
def test_greedy_video_tokens_match_jax(dtype):
    jm, p, tm, cfg = transformer(dtype, seed=9)
    _, text, tmask = data(10)
    kw = dict(num_frames=LAT_T, temperature=0.0, do_sample=False)
    want = np.asarray(j_gen(jm, p, jnp.asarray(text), jnp.asarray(tmask),
                            jax.random.PRNGKey(0), **kw))
    got = generate_video_tokens(tm, t(text), t(tmask), None, **kw).numpy()
    assert got.shape == (2, LAT_T, GH, GW) and got.dtype == np.int32
    if dtype == "float32":
        np.testing.assert_array_equal(got, want)
        return
    # JAX's top-two gaps along its own tokens (teacher forced: the full
    # forward's logits at a position are the read step's there)
    flat = want.reshape(2, -1)
    seq = np.concatenate([np.zeros((2, 1), np.int32), flat[:, :-1]], 1).reshape(want.shape)
    jl, _ = jm.apply(p, jnp.asarray(seq), jnp.asarray(text), jnp.asarray(tmask),
                     return_logits=True)
    top2 = np.sort(np.asarray(jl).reshape(2, flat.shape[1], -1), -1)[..., -2:]
    excused = greedy_agree(got, want, top2[..., 1] - top2[..., 0], BF16_TOL["atol"])
    print("bf16 greedy video tokens: near tie excused at step", excused)


def test_sampled_video_tokens_are_seeded(ar32):
    _, _, tm, cfg = ar32
    _, text, _ = data(11, b=1)
    kw = dict(num_frames=LAT_T, temperature=0.9, top_k=8, top_p=0.9)
    runs = [generate_video_tokens(tm, t(text), None, torch.Generator().manual_seed(s), **kw)
            for s in (3, 3, 4)]
    for r in runs:
        assert r.shape == (1, LAT_T, GH, GW)
        assert 0 <= int(r.min()) and int(r.max()) < cfg.num_embeddings
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


# --- the 3-D VQ-VAE --------------------------------------------------------------------


def videos(seed, b=2):
    return np.random.RandomState(seed).rand(b, 3, 4, 16, 16).astype(np.float32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_vqvae3d_train_and_eval_mode_match_jax(dtype):
    """The training forward (batch statistics, which it folds into the
    running ones) and then the eval forward on the updated statistics."""
    jcfg, cfg = cfgs(dtype)
    x = videos(12)
    jm = jvg.VQVAE3D(jcfg)
    v = jinit(jm, jnp.asarray(x), seed=13)
    tm = tvg.VQVAE3D(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(v, cfg))
    img_tol = F32_TOL if dtype == "float32" else dict(atol=1 / 128)
    (jr, jloss, jidx), mut = jm.apply(v, jnp.asarray(x), deterministic=False,
                                      mutable=["batch_stats"])
    with torch.no_grad():
        r, loss, idx = tm(t(x), deterministic=False)
    assert r.shape == x.shape and idx.shape == (2, 2, 4, 4)
    assert 0 <= float(r.min()) and float(r.max()) <= 1
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5 if dtype == "float32"
                               else 2e-3)
    np.testing.assert_allclose(f32(r), f32(jr), **img_tol)
    stats = params_from_jax({"params": v["params"],
                             "batch_stats": jax.device_get(mut["batch_stats"])}, cfg)
    names = [n for n in stats if "running_" in n]
    assert len(names) == 10
    for n in names:
        np.testing.assert_allclose(tm.state_dict()[n].numpy(), stats[n].numpy(),
                                   atol=5e-6, rtol=1e-5, err_msg=n)
    v2 = {"params": v["params"], "batch_stats": jax.device_get(mut["batch_stats"])}
    jr, jloss, jidx = jm.apply(v2, jnp.asarray(x))
    with torch.no_grad():
        r, loss, idx = tm(t(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(f32(r), f32(jr), **img_tol)


# --- trainers ----------------------------------------------------------------------


def check_state(name, got, want, step, flat):
    err = (got - want).abs()
    bound = PARAM_TOL["atol"] + PARAM_TOL["rtol"] * want.abs()
    if flat is not None:  # Adam's bound, 2 lr a step
        bound = torch.where(flat | (step > 1), 2 * LR * step, bound)
    assert bool((err <= bound).all()), f"{name} at step {step}: {float(err.max())}"


def test_two_vqvae3d_trainer_steps_match_jax():
    jcfg, cfg = cfgs()
    x = videos(14)
    jt = JVQTrainer(jcfg, JTrainingArgs(learning_rate=LR), jnp.asarray(x),
                    num_training_steps=10)
    state = lambda: {"params": meta.unbox(jax.device_get(jt.params)),  # noqa: E731
                     "batch_stats": jax.device_get(jt.batch_stats)}
    tt = VQVAE3DTrainer(cfg, VideoGenTrainingArgs(learning_rate=LR), num_training_steps=10,
                        variables=params_from_jax(state(), cfg), device="cpu")

    def loss_fn(params, batch_stats):
        (_, loss, _), _ = jt.model.apply({"params": params, "batch_stats": batch_stats},
                                         jnp.asarray(x), deterministic=False,
                                         mutable=["batch_stats"])
        return loss

    flat = {}
    for step in (1, 2):
        jg = params_from_jax({"params": meta.unbox(jax.device_get(
            jax.grad(loss_fn)(jt.params, jt.batch_stats)))}, cfg)
        jl, tl = jt.train_step(jnp.asarray(x)), tt.train_step(t(x))
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        for name, prm in tt.model.named_parameters():
            np.testing.assert_allclose(prm.grad.numpy(), jg[name].numpy(), err_msg=name,
                                       **GRAD_TOL)
            flat[name] = flat.get(name, False) | (jg[name].abs() < FLAT_GRAD)
        want, got = params_from_jax(state(), cfg), tt.model.state_dict()
        assert set(got) == set(want) and any("running_var" in n for n in got)
        for name in got:
            check_state(name, got[name], want[name], step, flat.get(name))


def test_two_video_token_trainer_steps_match_jax():
    jcfg, cfg = cfgs()
    idx, text, tmask = data(15)
    jb = {"indices": jnp.asarray(idx), "text_embeddings": jnp.asarray(text),
          "text_mask": jnp.asarray(tmask)}
    jt = JTokenTrainer(jcfg, JTrainingArgs(learning_rate=LR), jb, num_training_steps=10)
    params = lambda: params_from_jax(meta.unbox(jax.device_get(jt.params)), cfg)  # noqa: E731
    tt = VideoTokenTrainer(cfg, VideoGenTrainingArgs(learning_rate=LR), num_training_steps=10,
                           params=params(), device="cpu")

    def loss_fn(prm):
        b = idx.shape[0]
        flat = jnp.asarray(idx).reshape(b, -1)
        inputs = jnp.concatenate([jnp.zeros((b, 1), jnp.int32), flat[:, :-1]], 1)
        logits, _ = jt.model.apply({"params": prm}, inputs.reshape(idx.shape),
                                   jb["text_embeddings"], text_mask=jb["text_mask"],
                                   return_logits=True, deterministic=False,
                                   rngs={"dropout": jax.random.PRNGKey(0)})
        logp = jax.nn.log_softmax(logits.reshape(b, flat.shape[1], -1), axis=-1)
        return -jnp.take_along_axis(logp, flat[..., None], axis=-1).mean()

    batch = {"indices": t(idx), "text_embeddings": t(text), "text_mask": t(tmask)}
    grad_fn = jax.jit(jax.grad(loss_fn))  # eager jax.grad agrees to 6e-8, 7x slower
    flat = {}
    for step in (1, 2):
        jg = params_from_jax(meta.unbox(jax.device_get(grad_fn(jt.params))), cfg)
        jl, tl = jt.train_step(jb), tt.train_step(batch)
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        for name, prm in tt.model.named_parameters():
            np.testing.assert_allclose(prm.grad.numpy(), jg[name].numpy(), err_msg=name,
                                       **GRAD_TOL)
            flat[name] = flat.get(name, False) | (jg[name].abs() < FLAT_GRAD)
        want, got = params(), tt.model.state_dict()
        for name in got:
            check_state(name, got[name], want[name], step, flat[name])


def test_token_trainer_remat_equals_no_remat():
    """``use_checkpointing`` recomputes the blocks in the backward: the same
    step to 1e-6 as without."""
    out = []
    idx, text, _ = data(16)
    for remat in (False, True):
        cfg = tcfgmod.video_gen_tiny_test(dtype="float32", use_checkpointing=remat)
        tt = VideoTokenTrainer(cfg, VideoGenTrainingArgs(learning_rate=1e-3, seed=3),
                               num_training_steps=10, device="cpu")
        for _ in range(2):
            assert np.isfinite(tt.train_step({"indices": t(idx), "text_embeddings": t(text)}))
        out.append({n: p.detach().clone() for n, p in tt.model.named_parameters()})
    for n in out[0]:
        np.testing.assert_allclose(out[1][n].numpy(), out[0][n].numpy(), atol=1e-6, err_msg=n)


# --- pipeline and entry points ------------------------------------------------------


def test_pipeline_greedy_matches_jax():
    """The JAX test's pairing: the image stack's text encoder at the video
    width, the AR transformer, the 3-D decoder and a codebook."""
    jcfg, cfg = cfgs()
    kw = dict(d_model=D, num_heads=4, query_groups=2, d_ffn=96, vocab_size=cfg.vocab_size,
              dtype="float32")
    jtxt, ttxt = j_img_tiny(**kw), image_gen_tiny_test(**kw)
    ids = np.random.RandomState(17).randint(1, cfg.vocab_size, (1, 5)).astype(np.int32)
    je = JTextEncoder(jtxt)
    ve = jinit(je, jnp.asarray(ids), seed=19)
    ja = jvg.AutoregressiveVideoTransformer(jcfg)
    va = jinit(ja, jnp.zeros((1, 1, GH, GW), jnp.int32), jnp.zeros((1, 5, D)), seed=20)
    jd = jvg.Decoder3D(jcfg)
    vd = jinit(jd, jnp.zeros((1, LAT_T, GH, GW, D)), seed=21)
    cb = np.asarray(jax.random.normal(jax.random.PRNGKey(22), (cfg.num_embeddings, D)))
    jp = JPipeline(jcfg, je, ve, va, vd, jnp.asarray(cb))
    sampler = dict(temperature=0.0, do_sample=False)
    jvid, jtok = jp.generate_videos(jnp.asarray(ids), jax.random.PRNGKey(23),
                                    num_frames=LAT_T, sampler=JSampler(**sampler))
    enc = port(TransformerTextEncoder(ttxt, device="cpu"), ve, ttxt)
    tp = VideoGenerationPipeline(cfg, enc, params_from_jax(va, cfg), params_from_jax(vd, cfg),
                                 t(cb), device="cpu")
    vid, tok = tp.generate_videos(t(ids), None, num_frames=LAT_T,
                                  sampler=VideoGenerationSampler(**sampler))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    assert vid.shape == (1, 3, 4, 16, 16) and 0 <= float(vid.min()) and float(vid.max()) <= 1
    np.testing.assert_allclose(vid.numpy(), np.asarray(jvid), **F32_TOL)
    # every part drawn from a seed, sampled: shapes, range and the seed's draws
    rp = VideoGenerationPipeline(cfg, seed=1, device="cpu")
    kw = dict(num_frames=1, sampler=VideoGenerationSampler(0.9, top_k=8))
    a = rp.generate_videos(t(ids), torch.Generator().manual_seed(5), **kw)
    b = rp.generate_videos(t(ids), torch.Generator().manual_seed(5), **kw)
    assert a[0].shape == (1, 3, 2, 16, 16) and a[1].shape == (1, 1, GH, GW)
    assert torch.equal(a[1], b[1]) and torch.equal(a[0], b[0])


def test_video_gen_script_trains_and_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = video_gen_script.main(["--device", "cpu", "--steps", "3"])
    for phase in ("vqvae", "transformer"):
        assert len(out[phase]["losses"]) == len(out[phase]["step_s"]) == 3
        assert all(np.isfinite(out[phase]["losses"]))
        assert int(out[phase]["trainer"].state.step) == 3
    assert os.listdir(tmp_path) == []
    out = video_gen_script.main(["--device", "cpu", "--steps", "1", "--phase", "transformer",
                                 "--log-dir", str(tmp_path / "logs")])
    assert set(out) == {"cfg", "transformer"}
    assert os.listdir(tmp_path) == ["logs"]
    assert os.listdir(tmp_path / "logs") == ["training.log"]


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    cfg = tcfgmod.video_gen_tiny_test()
    for make in (lambda: tvg.AutoregressiveVideoTransformer(cfg), lambda: tvg.VQVAE3D(cfg),
                 lambda: VideoGenerationPipeline(cfg),
                 lambda: VQVAE3DTrainer(cfg, VideoGenTrainingArgs()),
                 lambda: VideoTokenTrainer(cfg, VideoGenTrainingArgs()),
                 lambda: video_gen_script.main(["--steps", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
