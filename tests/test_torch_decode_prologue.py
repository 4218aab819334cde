"""K3's decode prologue (``ops/cache_append.py``: QK-norm, RoPE, head-dim pad
and the dense KV commit of one decode token) against vats_tpu, on the CPU.

The CPU runs the prologue's plain version, the unfused chain the card's
kernel replaces.  The JAX side is its own chain: ``l2_normalize``,
``apply_rope_1d``, the pad, and for the dense cache the Pallas append
kernel ``_append_kernel`` in interpret mode (S a multiple of 128, its TPU
rule).  Inputs come from numpy seeds, rounded to the model dtype the same
way on both sides; projections come fused ([B, 1, (Hq+2G) hd] split into
views, as ``use_qkv_proj`` gives them) or as three tensors.

Tolerance, stated per check:
  * v, the pad lanes and every cache element outside the written column:
    bit-equal;
  * q and k: fp32 1e-6 absolute (both sides compute x / sqrt(sum x^2) and
    the rotation in fp32; the sum of squares runs in another order, and
    XLA's cos/sin are not PyTorch's: a few fp32 ulps of a unit vector's
    elements, 2.4e-7 at most over 20 seeds); bf16: one bf16 ulp at the
    rotated pair's magnitude sqrt(r1^2 + r2^2) (such a difference can flip
    one bf16 rounding of n, which the rotation spreads over the pair; no
    element differed over 20 seeds);
  * a whole attention decode step: fp32 2e-5 (the attention's own sums).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vats_tpu.nn import apply_rope_1d as j_rope
from vats_tpu.nn import l2_normalize as j_l2
from vats_tpu.ops.cache_append import append_token_inplace as j_append
from vats_tpu_torch.nn.rope import rope_inv_freq
from vats_tpu_torch.ops import cache_append as ca

torch.set_num_threads(1)

B, HQ, G, HD, HDP, S, L, THETA = 3, 6, 2, 12, 16, 256, 2, 10000.0
POSITIONS = (0, 127, S - 1, S + 7)  # S + 7 clamps to S - 1 (a ring wraps to 7)
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def projections(rs, fused, tdt, jdt, b=B):
    """q, k, v [b, 1, H, hd] for both packages from one draw; the port's are
    views of one fused row when ``fused``."""
    width = (HQ + 2 * G) * HD
    x = rs.randn(b, 1, width).astype(np.float32)
    row = torch.from_numpy(x).to(tdt)
    if fused:
        tq, tk, tv = torch.split(row, [HQ * HD, G * HD, G * HD], dim=-1)
    else:
        tq, tk, tv = (row[..., :HQ * HD].clone(), row[..., HQ * HD:(HQ + G) * HD].clone(),
                      row[..., (HQ + G) * HD:].clone())
    tq, tk, tv = tq.reshape(b, 1, HQ, HD), tk.reshape(b, 1, G, HD), tv.reshape(b, 1, G, HD)
    jx = jnp.asarray(x).astype(jdt)
    jq = jx[..., :HQ * HD].reshape(b, 1, HQ, HD)
    jk = jx[..., HQ * HD:(HQ + G) * HD].reshape(b, 1, G, HD)
    jv = jx[..., (HQ + G) * HD:].reshape(b, 1, G, HD)
    return (tq, tk, tv), (jq, jk, jv)


def jax_rope_qk(jq, jk, positions, qk_norm):
    if qk_norm:
        jq, jk = j_l2(jq), j_l2(jk)
    return j_rope(jq, positions, THETA), j_rope(jk, positions, THETA)


def f32(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x.astype(jnp.float32)))


def pair_ulp(want, mantissa_bits):
    """Per element: one ulp at the magnitude of its rotated pair."""
    pm = np.sqrt(want[..., 0::2] ** 2 + want[..., 1::2] ** 2).repeat(2, axis=-1)
    return 2.0 ** (np.floor(np.log2(np.maximum(pm, 2.0 ** -126))) - mantissa_bits)


def assert_rotated_close(got, want, tdt, what):
    """q or k: fp32 to 1e-6; bf16 to one bf16 ulp at the pair's magnitude."""
    got, want = f32(got), f32(want)
    if tdt == torch.float32:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0, err_msg=what)
        return
    ulp = pair_ulp(want, 7)
    err = np.abs(got - want)
    assert (err <= ulp).all(), f"{what}: {(err / ulp).max():.2f} bf16 ulps"


@pytest.mark.parametrize("fused", [True, False], ids=["qkv_proj", "split_proj"])
@pytest.mark.parametrize("qk_norm", [True, False], ids=["qk_norm", "no_norm"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("ring", [False, True], ids=["dense", "ring"])
def test_dense_prologue_matches_jax_chain(ring, dtype, qk_norm, fused):
    """q (padded to hd_pad) and the committed cache column against JAX's
    l2_normalize -> apply_rope_1d -> pad -> _append_kernel (interpret), at
    positions 0, 127, S-1 and S+7."""
    tdt, jdt = DTYPES[dtype]
    rs = np.random.RandomState(3 + 2 * ring + qk_norm)
    cache = rs.randn(2, L, B, G, HDP, S).astype(np.float32)
    tk_cache, tv_cache = (torch.from_numpy(c).to(tdt) for c in cache)
    jk_cache, jv_cache = (jnp.asarray(c).astype(jdt) for c in cache)
    for step, pos in enumerate(POSITIONS):
        layer = step % L
        (tq, tk, tv), (jq, jk, jv) = projections(rs, fused, tdt, jdt)
        length = torch.tensor(pos, dtype=torch.int32)
        before_k, before_v = tk_cache.clone(), tv_cache.clone()
        q_pad = ca.dense_decode_prologue(
            tq, tk, tv, tk_cache, tv_cache, length, layer, rope_inv_freq(HD, THETA),
            theta=THETA, qk_norm=qk_norm, ring=ring)

        jpos = jnp.asarray(pos, jnp.int32)
        rq, rk = jax_rope_qk(jq, jk, jpos + jnp.arange(1), qk_norm)
        pad = ((0, 0), (0, 0), (0, 0), (0, HDP - HD))
        col = pos % S if ring else min(pos, S - 1)
        jk_cache, jv_cache = j_append(
            jk_cache, jv_cache, layer, jnp.pad(rk, pad)[:, 0], jnp.pad(jv, pad)[:, 0],
            jnp.asarray(col, jnp.int32), interpret=True)

        assert q_pad.shape == (B, 1, HQ, HDP) and q_pad.dtype == tdt
        assert_rotated_close(q_pad[..., :HD], rq, tdt, f"q at {pos}")
        assert not q_pad[..., HD:].any()
        assert_rotated_close(tk_cache[layer, ..., col], np.asarray(jk_cache)[layer, ..., col],
                             tdt, f"k at {pos}")
        np.testing.assert_array_equal(f32(tv_cache), f32(jv_cache))
        assert not tk_cache[layer, :, :, HD:, col].any()
        # only column `col` of layer `layer` moved
        kept = torch.ones(S, dtype=torch.bool)
        kept[col] = False
        for now, was in ((tk_cache, before_k), (tv_cache, before_v)):
            assert torch.equal(now[..., kept], was[..., kept])
            assert torch.equal(now[1 - layer], was[1 - layer])
        # the JAX cache otherwise holds the port's bits: carry them on
        jk_cache = jnp.asarray(f32(tk_cache)).astype(jdt)


@pytest.mark.parametrize("fused", [True, False], ids=["qkv_proj", "split_proj"])
@pytest.mark.parametrize("qk_norm", [True, False], ids=["qk_norm", "no_norm"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_paged_prologue_matches_jax_chain(dtype, qk_norm, fused):
    """Per-row positions of a ragged paged batch: q, k rotated at
    lengths[b]; v passed through bit for bit."""
    tdt, jdt = DTYPES[dtype]
    rs = np.random.RandomState(11 + qk_norm + 2 * fused)
    lengths = np.array([0, 127, 129, 4095, 300], np.int32)
    (tq, tk, tv), (jq, jk, jv) = projections(rs, fused, tdt, jdt, b=len(lengths))
    q, k, v = ca.paged_decode_prologue(tq, tk, tv, torch.from_numpy(lengths),
                                       rope_inv_freq(HD, THETA), theta=THETA, qk_norm=qk_norm)
    jl = jnp.asarray(lengths)
    rq, rk = jax_rope_qk(jq, jk, jl[:, None] + jnp.arange(1)[None, :], qk_norm)
    assert q.shape == (len(lengths), HQ, HD) and k.shape == v.shape == (len(lengths), G, HD)
    assert_rotated_close(q, rq[:, 0], tdt, "q")
    assert_rotated_close(k, rk[:, 0], tdt, "k")
    np.testing.assert_array_equal(f32(v), f32(jv[:, 0]))


def test_append_only_mode_is_todays_append():
    """The append-only mode's plain version is unchanged: the write of
    ``append_token_ref`` (the JAX kernel's, tests/test_torch_cache_append.py)."""
    rs = np.random.RandomState(2)
    k = torch.from_numpy(rs.randn(L, B, G, HDP, S).astype(np.float32))
    kn = torch.from_numpy(rs.randn(B, G, HDP).astype(np.float32))
    ka, kb = k.clone(), k.clone()
    ca.append_token_inplace(ka, ka.clone(), 1, kn, kn, torch.tensor(S + 3, dtype=torch.int32))
    kb[1, ..., S - 1] = kn
    assert torch.equal(ka, kb)


def _attention_pair(fused, seed):
    """vats_tpu's Attention and the port's with the same weights (fp32,
    QK-norm on), d_model 48: 4 query heads of 12 in 2 groups."""
    import jax
    from flax.linen import meta

    from vats_tpu.nn.attention import Attention as JAttention
    from vats_tpu_torch.nn.attention import Attention

    kw = dict(d_model=48, num_heads=HQ - 2, query_groups=G, use_qkv_proj=fused)
    jm = JAttention(**kw)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((2, 5, 48)))
    tree = jax.tree_util.tree_map(np.asarray, meta.unbox(params))["params"]
    tm = Attention(**kw, device="cpu")
    tm.load_state_dict({f"{name}.weight": torch.from_numpy(np.ascontiguousarray(p["kernel"].T))
                        for name, p in tree.items()})
    return jm, params, tm


@pytest.mark.parametrize("fused", [True, False], ids=["qkv_proj", "split_proj"])
@pytest.mark.parametrize("kind", ["dense", "ring", "paged"])
def test_attention_decode_steps_match_jax(kind, fused):
    """A prefill, then decode steps (T == 1, through the prologue) of one
    Attention module in both packages: outputs to 2e-5, dense and ring
    caches (the ring wraps past slot S-1) and the paged pool (the JAX pool
    swapped to the port's head-dim-minor layout) to 1e-6 + 1e-5 relative:
    the projections' products differ in the last fp32 bits between the
    two packages."""
    from vats_tpu.nn.kv_cache import KVCache as JKVCache
    from vats_tpu.ops import decode_attention as jda
    from vats_tpu_torch.nn.kv_cache import KVCache
    from vats_tpu_torch.ops import decode_attention as tda

    jm, params, tm = _attention_pair(fused, seed=4)
    rs = np.random.RandomState(5)
    b, s = 2, 128
    prefill = 126 if kind == "ring" else 20
    kw = dict(left_window=100) if kind == "ring" else {}
    if kind == "paged":
        jc = jda.PagedKVCache.create(2, b, 2 * s, G, HD, page_size=128, dtype=jnp.float32)
        tc = tda.PagedKVCache.create(2, b, 2 * s, G, HD, page_size=128,
                                     dtype=torch.float32, device="cpu")
        tc.page_table.copy_(torch.from_numpy(np.array(jc.page_table)))
    else:
        jc = JKVCache.create(2, b, s, G, HD, dtype=jnp.float32, ring=kind == "ring")
        tc = KVCache.create(2, b, s, G, HD, dtype=torch.float32, ring=kind == "ring",
                            device="cpu")
    for t in (prefill, 1, 1, 1):
        x = rs.randn(b, t, 48).astype(np.float32)
        cache_kw = (dict(paged_cache=jc) if kind == "paged" else dict(cache=jc))
        jout, jc = jm.apply(params, jnp.asarray(x), layer_idx=1, **cache_kw, **kw)
        with torch.no_grad():
            tout, _ = tm(torch.from_numpy(x), layer_idx=1,
                         **{k: tc for k in cache_kw}, **kw)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=2e-5, rtol=0)
        if kind == "paged":
            np.testing.assert_allclose(tc.kv_pages.numpy(), np.swapaxes(
                np.asarray(jc.kv_pages), -1, -2), atol=1e-6, rtol=1e-5)
        else:
            for got, want in ((tc.k, jc.k), (tc.v, jc.v)):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)
        jc, _ = jc.advance(t), tc.advance(t)


# --- table mode: the image-generation stack's '2d_ntk' RoPE -------------------

GRID_W, NTK = 5, 0.7


def jax_ntk_qk(jq, jk, positions, qk_norm):
    from vats_tpu.nn.rope import apply_rope_2d_ntk_positions as j_ntk

    if qk_norm:
        jq, jk = j_l2(jq), j_l2(jk)
    return (j_ntk(jq, positions, GRID_W, THETA, NTK), j_ntk(jk, positions, GRID_W, THETA, NTK))


@pytest.mark.parametrize("qk_norm", [True, False], ids=["qk_norm", "no_norm"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", ["dense", "ring", "paged"])
def test_table_mode_equals_2d_ntk_chain(kind, dtype, qk_norm):
    """Table mode's plain version (the kernel's oracle) given the table of
    ``rope_2d_ntk_cos_sin`` against the unfused '2d_ntk' chain: the port's
    own (l2_normalize -> apply_rope_2d_ntk_positions -> pad -> commit) bit
    for bit, and JAX's (l2_normalize -> apply_rope_2d_ntk_positions) to the
    rotation tolerance above; the cache elsewhere and v bit-equal."""
    from vats_tpu_torch.nn.norms import l2_normalize
    from vats_tpu_torch.nn.rope import apply_rope_2d_ntk_positions, rope_2d_ntk_cos_sin

    tdt, jdt = DTYPES[dtype]
    rs = np.random.RandomState(31 + qk_norm)
    if kind == "paged":
        lengths = np.array([0, 4, 5, 127, 4095], np.int32)
    else:
        lengths = np.array(POSITIONS[1 + qk_norm], np.int32)
    b = lengths.size if kind == "paged" else B
    (tq, tk, tv), (jq, jk, jv) = projections(rs, True, tdt, jdt, b=b)
    pos = torch.from_numpy(lengths)
    positions = pos[:, None] if kind == "paged" else pos.reshape(1)
    cos_sin = rope_2d_ntk_cos_sin(positions, HD, GRID_W, THETA, NTK)
    cq, ck = (l2_normalize(x) if qk_norm else x for x in (tq, tk))
    cq = apply_rope_2d_ntk_positions(cq, positions, GRID_W, THETA, NTK)
    ck = apply_rope_2d_ntk_positions(ck, positions, GRID_W, THETA, NTK)
    jpos = jnp.asarray(lengths)[:, None] if kind == "paged" else jnp.asarray(lengths)[None]
    rq, rk = jax_ntk_qk(jq, jk, jpos, qk_norm)
    if kind == "paged":
        q, k, v = ca.paged_decode_prologue(tq, tk, tv, pos, None, theta=THETA,
                                           qk_norm=qk_norm, cos_sin=cos_sin)
        assert torch.equal(q, cq[:, 0]) and torch.equal(k, ck[:, 0]) and torch.equal(v, tv[:, 0])
        assert_rotated_close(q, rq[:, 0], tdt, "q")
        assert_rotated_close(k, rk[:, 0], tdt, "k")
        return
    cache = torch.from_numpy(rs.randn(2, L, B, G, HDP, S).astype(np.float32)).to(tdt)
    tk_cache, tv_cache = cache[0].clone(), cache[1].clone()
    q_pad = ca.dense_decode_prologue(tq, tk, tv, tk_cache, tv_cache, pos, 1, None,
                                     theta=THETA, qk_norm=qk_norm, ring=kind == "ring",
                                     cos_sin=cos_sin)
    col = int(lengths) % S if kind == "ring" else min(int(lengths), S - 1)
    want_k, want_v = cache[0].clone(), cache[1].clone()
    want_k[1, ..., col] = ca._pad_to(ck, HDP)[:, 0]
    want_v[1, ..., col] = ca._pad_to(tv, HDP)[:, 0]
    assert torch.equal(q_pad, ca._pad_to(cq, HDP))
    assert torch.equal(tk_cache, want_k) and torch.equal(tv_cache, want_v)
    assert_rotated_close(q_pad[..., :HD], rq, tdt, "q")
    assert_rotated_close(tk_cache[1, ..., :HD, col], rk[:, 0], tdt, "k")


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_attention_2d_ntk_decode_steps_match_jax(kind):
    """'2d_ntk' Attention (fp32, QK-norm, NTK scale 0.7) over a raster grid
    five wide: a prefill of 7 tokens, then decode steps through the table
    mode, against vats_tpu: outputs to 2e-5, caches as in the 1-D test."""
    import jax
    from flax.linen import meta

    from vats_tpu.nn.attention import Attention as JAttention
    from vats_tpu.nn.kv_cache import KVCache as JKVCache
    from vats_tpu.ops import decode_attention as jda
    from vats_tpu_torch.nn.attention import Attention
    from vats_tpu_torch.nn.kv_cache import KVCache
    from vats_tpu_torch.ops import decode_attention as tda

    kw = dict(d_model=48, num_heads=HQ - 2, query_groups=G, rope_type="2d_ntk",
              rope_ntk_scale=NTK)
    jm = JAttention(**kw)
    params = jm.init(jax.random.PRNGKey(6), jnp.zeros((2, 5, 48)), grid_shape=(GRID_W,))
    tree = jax.tree_util.tree_map(np.asarray, meta.unbox(params))["params"]
    tm = Attention(**kw, device="cpu")
    tm.load_state_dict({f"{name}.weight": torch.from_numpy(np.ascontiguousarray(p["kernel"].T))
                        for name, p in tree.items()})
    rs = np.random.RandomState(8)
    b, s = 2, 128
    if kind == "paged":
        jc = jda.PagedKVCache.create(2, b, s, G, HD, page_size=128, dtype=jnp.float32)
        tc = tda.PagedKVCache.create(2, b, s, G, HD, page_size=128, dtype=torch.float32,
                                     device="cpu")
        tc.page_table.copy_(torch.from_numpy(np.array(jc.page_table)))
    else:
        jc = JKVCache.create(2, b, s, G, HD, dtype=jnp.float32)
        tc = KVCache.create(2, b, s, G, HD, dtype=torch.float32, device="cpu")
    for t in (7, 1, 1, 1):
        x = rs.randn(b, t, 48).astype(np.float32)
        cache_kw = dict(paged_cache=jc) if kind == "paged" else dict(cache=jc)
        jout, jc = jm.apply(params, jnp.asarray(x), layer_idx=1, grid_shape=(GRID_W,),
                            **cache_kw)
        with torch.no_grad():
            tout, _ = tm(torch.from_numpy(x), layer_idx=1, grid_shape=(GRID_W,),
                         **{k: tc for k in cache_kw})
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=2e-5, rtol=0)
        if kind == "paged":
            np.testing.assert_allclose(tc.kv_pages.numpy(), np.swapaxes(
                np.asarray(jc.kv_pages), -1, -2), atol=1e-6, rtol=1e-5)
        else:
            for got, want in ((tc.k, jc.k), (tc.v, jc.v)):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)
        jc, _ = jc.advance(t), tc.advance(t)
