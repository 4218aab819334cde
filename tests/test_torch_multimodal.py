"""The port's fused text+image+video stream against ``vats_tpu``, on the CPU.

Covers what tests/test_multimodal.py covers, each against the JAX package
with the same weights (``params_from_jax``), at that file's tiny config
(d48, 2 layers, 4 heads in 2 groups of head dim 12, vocabularies 64 + 16 +
32, a 2 x 2 image, a 2 x 2 x 2 video, prompts up to 8): the config, the 3-D
NTK RoPE and ``multimodal_rope_angles`` (bit for bit against each stack's
own table in the port, within an ulp of JAX's), the model's logits,
greedy ``generate_multimodal`` with ragged prompts, the dense cache against
the paged one; and the attention's '3d_ntk' and 'none' RoPE on the
uncached, dense and paged paths, against JAX's ``Attention``.

Tolerances: fp32 atol 2e-5, rtol 1e-5 on activations and logits (sums in
another order); bf16 atol 0.05, rtol 0.02 (the packages round bf16 at other
places, a few ulps over two layers), as tests/test_torch_image_gen.py
argues them; greedy tokens exact (in bf16 up to a near tie of JAX's top
two logits, which the test names).  Sampled draws are
not JAX's bits: sampled generation is checked for range and determinism
under a seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import meta

import vats_tpu.configs.multimodal as jcfgmod
from vats_tpu.inference.multimodal import generate_multimodal as j_gen
from vats_tpu.models import multimodal as jmm
from vats_tpu.nn.attention import Attention as JAttention
from vats_tpu.nn.kv_cache import KVCache as JKVCache
from vats_tpu.nn.rope import apply_rope_3d_ntk_positions as j_rope3
from vats_tpu.ops.decode_attention import PagedKVCache as JPaged
import vats_tpu_torch.configs.multimodal as tcfgmod
from vats_tpu_torch.inference import generate_multimodal
from vats_tpu_torch.models import multimodal as tmm
from vats_tpu_torch.nn import Attention
from vats_tpu_torch.nn.kv_cache import KVCache
from vats_tpu_torch.nn.rope import (
    apply_rope_3d_ntk_positions,
    rope_2d_ntk_cos_sin,
    rope_3d_ntk_cos_sin,
    rope_cos_sin,
)
from vats_tpu_torch.ops.decode_attention import PagedKVCache
from vats_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

F32_TOL = dict(atol=2e-5, rtol=1e-5)
BF16_TOL = dict(atol=0.05, rtol=0.02)
TOL = {"float32": F32_TOL, "bfloat16": BF16_TOL}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
DTYPES = ["float32", "bfloat16"]
TINY = dict(d_model=48, num_heads=4, query_groups=2, d_ffn=96, num_layers=2, dropout=0.0,
            text_vocab_size=64, image_vocab_size=16, video_vocab_size=32, image_grid_h=2,
            image_grid_w=2, video_grid_t=2, video_grid_h=2, video_grid_w=2, max_text_len=8,
            ntk_scale_factor=0.7)
IDS = np.array([[5, 9, 2, 7, 1, 3], [11, 4, 8, 0, 0, 0]], np.int32)
MASK = np.array([[1, 1, 1, 1, 1, 1], [1, 1, 1, 0, 0, 0]], bool)


def cfgs(dtype="float32", **kw):
    kw = {**TINY, "dtype": dtype, **kw}
    return jcfgmod.MultimodalStreamArgs(**kw), tcfgmod.MultimodalStreamArgs(**kw)


def t(x):
    return torch.from_numpy(np.array(x))


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def model(dtype="float32", seed=1, **kw):
    jcfg, cfg = cfgs(dtype, **kw)
    jm = jmm.MultimodalLM(jcfg)
    mod, loc = jmm.stream_layout(jcfg, 6)
    p = jax.device_get(meta.unbox(jm.init(jax.random.PRNGKey(seed),
                                          jnp.zeros((1, mod.shape[0]), jnp.int32),
                                          mod[None], loc[None])))["params"]
    tm = tmm.MultimodalLM(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(p, cfg))
    return jm, p, tm.eval(), cfg


@pytest.fixture(scope="module")
def mm32():
    return model()


# --- config and RoPE -------------------------------------------------------------


def test_config_copy_matches_jax():
    fields = lambda c: [(f.name, f.default) for f in dataclasses.fields(c)]  # noqa: E731
    assert fields(tcfgmod.MultimodalStreamArgs) == fields(jcfgmod.MultimodalStreamArgs)
    for tier in ("multimodal_xsmall", "multimodal_small"):
        j, p = getattr(jcfgmod, tier)(), getattr(tcfgmod, tier)()
        assert dataclasses.asdict(p) == dataclasses.asdict(j)
        assert (p.head_dim, p.vocab_size, p.max_seq_len) == (j.head_dim, j.vocab_size,
                                                              j.max_seq_len)
    s = tcfgmod.multimodal_small()
    assert (s.d_model, s.num_layers, s.num_heads, s.query_groups, s.head_dim, s.vocab_size,
            s.image_tokens, s.video_tokens) == (768, 12, 8, 4, 96, 4864, 256, 2048)
    with pytest.raises(ValueError, match="divisible by 12"):
        tcfgmod.MultimodalStreamArgs(d_model=64, num_heads=4, query_groups=2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ntk", [None, 0.7])
def test_rope_3d_ntk_positions_matches_jax(dtype, ntk):
    x = np.random.RandomState(1).randn(2, 7, 3, 24).astype(np.float32)
    pos = np.array([[0, 3, 5, 17, 40, 63, 100], [1, 2, 9, 30, 31, 32, 99]], np.int32)
    tol = dict(atol=1e-5) if dtype == "float32" else dict(atol=2**-7 * 4, rtol=2**-8)
    got = apply_rope_3d_ntk_positions(t(x).to(TDT[dtype]), t(pos), 3, 4, 10000.0, ntk)
    want = j_rope3(jnp.asarray(x).astype(JDT[dtype]), jnp.asarray(pos), 3, 4, 10000.0, ntk)
    assert got.dtype == TDT[dtype]
    np.testing.assert_allclose(f32(got), f32(want), **tol)
    cos, sin = rope_3d_ntk_cos_sin(t(pos), 24, 3, 4, 10000.0, ntk)
    assert cos.shape == (2, 7, 12) and cos.dtype == torch.float32
    with pytest.raises(ValueError, match="divisible by 6"):
        rope_3d_ntk_cos_sin(t(pos), 16, 3, 4, 10000.0, ntk)


@pytest.mark.parametrize("ntk", [None, 0.7])
def test_multimodal_rope_angles_match_jax_and_each_stacks_table(ntk):
    """Every modality at positions reaching past each grid, and a mixed
    stream: each row of the table bit-equal to its modality's standalone
    table in the port (1-D ``rope_cos_sin``, ``rope_2d_ntk_cos_sin``,
    ``rope_3d_ntk_cos_sin``: what K3's table mode and the plain rotation
    read alike), and within 1e-6 of JAX's (XLA's pow and cos differ from
    PyTorch's by an ulp now and then: 6e-8 seen)."""
    jcfg, cfg = cfgs(ntk_scale_factor=ntk, d_model=96, num_heads=4, query_groups=2)
    rs = np.random.RandomState(2)
    mod = rs.randint(0, 3, (3, 40)).astype(np.int32)
    mod[0], mod[1] = 0, 2
    loc = rs.randint(0, 300, (3, 40)).astype(np.int32)
    jc, js = jmm.multimodal_rope_angles(jcfg, jnp.asarray(mod), jnp.asarray(loc))
    tc, ts = tmm.multimodal_rope_angles(cfg, t(mod), t(loc))
    assert tc.shape == (3, 40, 12) and tc.dtype == torch.float32
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6, rtol=0)
    hd, pos = cfg.head_dim, t(loc)
    tables = {
        tmm.MODALITY_TEXT: rope_cos_sin(pos, hd, cfg.rope_theta),
        tmm.MODALITY_IMAGE: rope_2d_ntk_cos_sin(pos, hd, cfg.image_grid_w, cfg.rope_theta,
                                                ntk),
        tmm.MODALITY_VIDEO: rope_3d_ntk_cos_sin(pos, hd, cfg.video_grid_h,
                                                cfg.video_grid_w, cfg.rope_theta, ntk)}
    for m, (c, s_) in tables.items():
        sel = t(mod) == m
        assert bool(sel.any())
        assert torch.equal(tc[sel], c[sel]) and torch.equal(ts[sel], s_[sel]), m


def test_stream_layout_matches_jax():
    jcfg, cfg = cfgs()
    for a, b in zip(tmm.stream_layout(cfg, 5), jmm.stream_layout(jcfg, 5)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.dtype == torch.int32


# --- the model -------------------------------------------------------------------


def stream(cfg, b=2, seed=3):
    mod, loc = tmm.stream_layout(cfg, 6)
    n = mod.shape[0]
    toks = np.random.RandomState(seed).randint(0, cfg.vocab_size, (b, n)).astype(np.int32)
    return toks, mod[None].expand(b, n).numpy(), loc[None].expand(b, n).numpy()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tie", [True, False], ids=["tied", "lm_head"])
def test_multimodal_lm_logits_match_jax(dtype, tie):
    jm, p, tm, cfg = model(dtype, tie_weights=tie)
    toks, mod, loc = stream(cfg)
    pad = np.ones(toks.shape, bool)
    pad[1, 14:] = False
    readout = np.array([17, 9], np.int32)
    jl, _ = jm.apply({"params": p}, *map(jnp.asarray, (toks, mod, loc)),
                     padding_mask=jnp.asarray(pad))
    jr, _ = jm.apply({"params": p}, *map(jnp.asarray, (toks, mod, loc)),
                     readout_positions=jnp.asarray(readout))
    with torch.no_grad():
        tl, cache = tm(t(toks), t(mod), t(loc), padding_mask=t(pad))
        tr, _ = tm(t(toks), t(mod), t(loc), readout_positions=t(readout))
    assert tl.shape == (2, toks.shape[1], cfg.vocab_size) and cache is None
    assert tl.dtype == torch.float32 and tr.shape == (2, 1, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL[dtype])
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **TOL[dtype])


def teacher_forced_gaps(jm, p, cfg, img, vid):
    """JAX's top-two gaps of the masked logits along each row's own stream
    (the full uncached forward: [B, n_total])."""
    vt, vi = cfg.text_vocab_size, cfg.image_vocab_size
    n_img, n_vid = cfg.image_tokens, cfg.video_tokens
    vocab = np.arange(cfg.vocab_size)
    gaps = np.zeros((2, n_img + n_vid))
    for b, lb in enumerate(MASK.sum(1)):
        gen = np.concatenate([img[b].reshape(-1) + vt, vid[b].reshape(-1) + vt + vi])
        seq = np.concatenate([IDS[b, :lb], gen])
        mod = np.concatenate([np.zeros(lb), np.ones(n_img), np.full(n_vid, 2)]).astype(np.int32)
        loc = np.concatenate([np.arange(lb), np.arange(n_img), np.arange(n_vid)]).astype(np.int32)
        lg, _ = jm.apply({"params": p}, *(jnp.asarray(a)[None] for a in (seq, mod, loc)))
        lg = np.asarray(lg[0])
        for i in range(n_img + n_vid):
            lo, hi = (vt, vt + vi) if i < n_img else (vt + vi, cfg.vocab_size)
            top = np.sort(np.where((vocab >= lo) & (vocab < hi), lg[lb + i - 1], -np.inf))
            gaps[b, i] = top[-1] - top[-2]
    return gaps


@pytest.mark.parametrize("dtype", DTYPES)
def test_greedy_generate_multimodal_with_ragged_prompts_matches_jax(dtype):
    jm, p, tm, cfg = model(dtype)
    kw = dict(temperature=0.0, do_sample=False)
    jimg, jvid = j_gen(jm, {"params": p}, jnp.asarray(IDS), jnp.asarray(MASK),
                       jax.random.PRNGKey(2), **kw)
    img, vid = generate_multimodal(tm, t(IDS), t(MASK), None, **kw)
    assert img.shape == (2, 2, 2) and vid.shape == (2, 2, 2, 2) and img.dtype == torch.int32
    assert 0 <= int(img.min()) and int(img.max()) < cfg.image_vocab_size
    assert 0 <= int(vid.min()) and int(vid.max()) < cfg.video_vocab_size
    got = np.concatenate([img.reshape(2, -1).numpy(), vid.reshape(2, -1).numpy()], 1)
    want = np.concatenate([np.asarray(jimg).reshape(2, -1), np.asarray(jvid).reshape(2, -1)], 1)
    if dtype == "float32":
        np.testing.assert_array_equal(got, want)
        return
    gaps = teacher_forced_gaps(jm, p, cfg, np.asarray(jimg), np.asarray(jvid))
    for i in range(got.shape[1]):
        if (got[:, i] != want[:, i]).any():
            assert (gaps[:, i] <= 2 * BF16_TOL["atol"]).any(), f"tokens differ at step {i}"
            print("bf16 greedy multimodal tokens: near tie excused at step", i)
            break


def test_dense_cache_decode_matches_paged_and_jax(mm32):
    """Greedy decode step by step through the dense cache (K3's dense table
    mode on the card) gives the paged loop's tokens; each step's logits
    equal JAX's dense steps."""
    jm, p, tm, cfg = mm32
    ids = IDS[:1, :4]
    img, vid = generate_multimodal(tm, t(ids), None, None, temperature=0.0, do_sample=False)
    paged = np.concatenate([img.reshape(-1).numpy() + cfg.text_vocab_size,
                            vid.reshape(-1).numpy() + cfg.text_vocab_size
                            + cfg.image_vocab_size])
    n_total = cfg.image_tokens + cfg.video_tokens
    tc, jc = tm.init_cache(1, 4 + n_total), jm.init_cache(1, 4 + n_total)
    mod = np.zeros((1, 4), np.int32)
    loc = np.arange(4, dtype=np.int32)[None]
    with torch.no_grad():
        lg, tc = tm(t(ids), t(mod), t(loc), cache=tc)
    jl, jc = jm.apply({"params": p}, *map(jnp.asarray, (ids, mod, loc)), cache=jc)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **F32_TOL)
    vt, vi = cfg.text_vocab_size, cfg.image_vocab_size
    vocab = torch.arange(cfg.vocab_size)
    nxt, out = lg[:, -1], []
    for i in range(n_total):
        is_img = i < cfg.image_tokens
        lo, hi = (vt, vt + vi) if is_img else (vt + vi, cfg.vocab_size)
        tok = torch.where((vocab >= lo) & (vocab < hi), nxt, float("-inf")).argmax(-1)
        out.append(int(tok[0]))
        m = np.full((1, 1), 1 if is_img else 2, np.int32)
        lp = np.full((1, 1), i if is_img else i - cfg.image_tokens, np.int32)
        with torch.no_grad():
            lg, tc = tm(tok[:, None].int(), t(m), t(lp), cache=tc)
        jl, jc = jm.apply({"params": p}, jnp.asarray(tok[:, None].int().numpy()),
                          jnp.asarray(m), jnp.asarray(lp), cache=jc)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **F32_TOL)
        nxt = lg[:, 0]
    np.testing.assert_array_equal(np.asarray(out), paged)


def test_sampled_generation_is_seeded_and_in_range(mm32):
    _, _, tm, cfg = mm32
    kw = dict(temperature=0.9, top_k=8, top_p=0.9)
    runs = [generate_multimodal(tm, t(IDS), t(MASK), torch.Generator().manual_seed(s), **kw)
            for s in (3, 3, 4)]
    for img, vid in runs:
        assert 0 <= int(img.min()) and int(img.max()) < cfg.image_vocab_size
        assert 0 <= int(vid.min()) and int(vid.max()) < cfg.video_vocab_size
    assert torch.equal(runs[0][1], runs[1][1]) and torch.equal(runs[0][0], runs[1][0])
    assert not (torch.equal(runs[0][0], runs[2][0]) and torch.equal(runs[0][1], runs[2][1]))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmm.MultimodalLM(cfgs()[1])


# --- the attention's '3d_ntk' and 'none' on every path -------------------------------


def attention_pair(rope_type, dtype):
    d, h, g = 48, 4, 2
    kw = dict(rope_type=rope_type, rope_ntk_scale=0.7, impl="xla")
    jm = JAttention(d, h, g, dtype=JDT[dtype], **kw)
    x = np.random.RandomState(4).randn(2, 12, d).astype(np.float32)
    p = jax.device_get(meta.unbox(jm.init(jax.random.PRNGKey(5), jnp.asarray(x),
                                          grid_shape=(2, 2, 3))))
    tm = Attention(d, h, g, dtype=TDT[dtype], **kw)
    tm.load_state_dict({f"{n}.weight": t(np.array(p["params"][n]["kernel"]).T.copy())
                        for n in ("w_qkv", "w_o")})
    return jm, p, tm, x


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rope_type", ["3d_ntk", "none"])
@pytest.mark.parametrize("path", ["uncached", "dense", "paged"])
def test_attention_rope_on_every_path_matches_jax(path, rope_type, dtype):
    """A prefill of 8 tokens then 4 decode tokens (each a launch of K3's
    table mode on the card: the '3d_ntk' table, or the identity for
    'none'), grid (2, 2, 3) t-major; the paged rows at ragged lengths; the
    uncached forward over all 12."""
    jm, p, tm, x = attention_pair(rope_type, dtype)
    grid = (2, 2, 3)
    xt = t(x).to(TDT[dtype])
    if path == "uncached":
        want, _ = jm.apply(p, jnp.asarray(x).astype(JDT[dtype]), grid_shape=grid)
        with torch.no_grad():
            got, _ = tm(xt, grid_shape=grid)
        np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])
        return
    shape = dict(num_layers=1, batch_size=2, max_seq_len=16, kv_heads=2, head_dim=12)
    if path == "dense":
        jc = JKVCache.create(dtype=JDT[dtype], **shape)
        tc = KVCache.create(dtype=TDT[dtype], device="cpu", **shape)
        key = "cache"
    else:
        jc = JPaged.create(dtype=JDT[dtype], page_size=128, **shape)
        tc = PagedKVCache.create(dtype=TDT[dtype], page_size=128, device="cpu", **shape)
        key = "paged_cache"
    pad = np.ones((2, 8), bool)
    pad[1, 5:] = False  # the paged rows advance 8 and 5
    spans = [(0, 8)] + [(i, i + 1) for i in range(8, 12)]
    for lo, hi in spans:
        xs = x[:, lo:hi]
        mask = pad if hi - lo > 1 and path == "paged" else None
        want, jc = jm.apply(p, jnp.asarray(xs).astype(JDT[dtype]), grid_shape=grid,
                            padding_mask=None if mask is None else jnp.asarray(mask),
                            **{key: jc})
        with torch.no_grad():
            got, tc = tm(t(xs).to(TDT[dtype]), grid_shape=grid,
                         padding_mask=None if mask is None else t(mask), **{key: tc})
        if path == "dense":
            jc, tc = jc.advance(hi - lo), tc.advance(hi - lo)
        else:
            counts = mask.sum(1) if mask is not None else np.full(2, hi - lo)
            jc = jc.advance_by(jnp.asarray(counts, jnp.int32))
            tc = tc.advance_by(t(counts.astype(np.int32)))
        np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])


@pytest.mark.parametrize("rope_type", ["3d_spatial", "3d_temporal", "3d_all"])
def test_attention_axial_3d_rope_uncached_matches_jax(rope_type):
    """The axial 3-D modes over a (gt, gh, gw) grid on the uncached path
    (x laid out as each mode expects: [B*T, H*W], [B*H*W, T] or
    [B, T*H*W]); the cache paths refuse them, as JAX's do."""
    d, h, g = 48, 4, 2
    grid = {"3d_spatial": (1, 2, 3), "3d_temporal": (6, 1, 1), "3d_all": (2, 2, 3)}[rope_type]
    n = 6 if rope_type != "3d_all" else 12
    x = np.random.RandomState(6).randn(2, n, d).astype(np.float32)
    kw = dict(rope_type=rope_type, rope_ntk_scale=0.7, impl="xla")
    jm = JAttention(d, h, g, **kw)
    p = jax.device_get(meta.unbox(jm.init(jax.random.PRNGKey(7), jnp.asarray(x),
                                          causal=False, grid_shape=grid)))
    want, _ = jm.apply(p, jnp.asarray(x), causal=False, grid_shape=grid)
    tm = Attention(d, h, g, **kw)
    tm.load_state_dict({f"{k}.weight": t(np.array(p["params"][k]["kernel"]).T.copy())
                        for k in ("w_qkv", "w_o")})
    with torch.no_grad():
        got, _ = tm(t(x), causal=False, grid_shape=grid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    kv = KVCache.create(num_layers=1, batch_size=2, max_seq_len=16, kv_heads=g,
                        head_dim=d // h, dtype=torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match="rope_type"):
        tm(t(x), cache=kv, grid_shape=grid)
