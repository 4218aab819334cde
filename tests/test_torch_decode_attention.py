"""K1's plain version and the paged cache against vats_tpu.

The JAX pool is sequence-minor [L, P, 2, G, hd_pad, ps]; the port's is
head-dim minor [L, P, 2, G, ps, hd_pad].  Pools are compared after swapping
the last two axes, bit for bit.  Attention outputs are fp32 on both sides
(tolerance 2e-5 absolute: the same softmax with sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vats_tpu.ops import decode_attention as jda
from vats_tpu_torch.ops import decode_attention as tda

torch.set_num_threads(1)

PS = 128


def to_port(pool):
    return torch.from_numpy(np.array(np.swapaxes(np.asarray(pool), -1, -2)))


def to_jax_layout(pool):
    return np.swapaxes(pool.numpy(), -1, -2)


def filled_caches(b, g, hd, s, lengths, seed, page_size=PS):
    """Both packages' caches with every slot of layer 1 written, then the
    given lengths (slots past a length hold stale values the masks hide)."""
    rs = np.random.RandomState(seed)
    ks = rs.randn(b, s, g, hd).astype(np.float32)
    vs = rs.randn(b, s, g, hd).astype(np.float32)
    jc = jda.PagedKVCache.create(2, b, s, g, hd, page_size=page_size, dtype=jnp.float32)
    jc = jc.append_tokens(1, jnp.asarray(ks), jnp.asarray(vs))
    jc = jc.replace(lengths=jnp.asarray(lengths, jnp.int32))
    tc = tda.PagedKVCache(
        kv_pages=to_port(jc.kv_pages),
        page_table=torch.from_numpy(np.array(jc.page_table)),
        lengths=torch.tensor(lengths, dtype=torch.int32),
        head_dim=hd,
    )
    return jc, tc


@pytest.mark.parametrize(
    "lengths", [[0, 5], [127, 128], [129, 1], [256, 255], [256, 0]]
)
def test_plain_decode_commit_matches_jax_oracle_and_append(lengths):
    # 0: empty history; 127/128/129: page boundary; 256: at capacity (clamp)
    b, hq, g, hd, s = 2, 6, 2, 12, 2 * PS  # hd 12 pads to 16
    jc, tc = filled_caches(b, g, hd, s, lengths, seed=sum(lengths))
    rs = np.random.RandomState(1)
    q = rs.randn(b, hq, hd).astype(np.float32)
    kc = rs.randn(b, g, hd).astype(np.float32)
    vc = rs.randn(b, g, hd).astype(np.float32)
    ref = jda.paged_decode_attention_xla(
        jnp.asarray(q), jc.kv_pages[1], jc.page_table, jc.lengths, scale=0.3,
        k_cur=jnp.asarray(kc), v_cur=jnp.asarray(vc),
    )
    ref_pool = jc.append_token(1, jnp.asarray(kc), jnp.asarray(vc)).kv_pages
    out = tda.paged_decode_attention_commit(
        torch.from_numpy(q), tc.kv_pages, 1, tc.page_table, tc.lengths,
        scale=0.3, k_cur=torch.from_numpy(kc), v_cur=torch.from_numpy(vc),
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)
    np.testing.assert_array_equal(to_jax_layout(tc.kv_pages), np.asarray(ref_pool))


def test_plain_decode_matches_jax_pallas_kernel_interpret():
    """The JAX kernel itself (interpret mode) agrees with the port's plain
    version, committed pool included."""
    b, hq, g, hd, s = 2, 4, 2, 12, 2 * PS
    lengths = [130, 5]
    jc, tc = filled_caches(b, g, hd, s, lengths, seed=3)
    rs = np.random.RandomState(4)
    q = rs.randn(b, hq, hd).astype(np.float32)
    kc = rs.randn(b, g, hd).astype(np.float32)
    vc = rs.randn(b, g, hd).astype(np.float32)
    ref, ref_pool = jda.paged_decode_attention_commit(
        jnp.asarray(q), jc.kv_pages, 1, jc.page_table, jc.lengths, scale=0.25,
        k_cur=jnp.asarray(kc), v_cur=jnp.asarray(vc), interpret=True,
    )
    out = tda.paged_decode_attention_commit(
        torch.from_numpy(q), tc.kv_pages, 1, tc.page_table, tc.lengths,
        scale=0.25, k_cur=torch.from_numpy(kc), v_cur=torch.from_numpy(vc),
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)
    np.testing.assert_array_equal(to_jax_layout(tc.kv_pages), np.asarray(ref_pool))
    # K1' (no commit) leaves the pool alone
    before = tc.kv_pages.clone()
    out2 = tda.paged_decode_attention(
        torch.from_numpy(q), tc.kv_pages, 1, tc.page_table, tc.lengths,
        scale=0.25, k_cur=torch.from_numpy(kc), v_cur=torch.from_numpy(vc),
    )
    assert torch.equal(before, tc.kv_pages)
    np.testing.assert_allclose(out2.numpy(), out.numpy(), atol=1e-6)


@pytest.mark.parametrize("page_size,lengths", [
    (128, [0, 127, 128, 129, 1000]),  # up to 8 tiles, ragged last tiles
    (256, [0, 255, 256, 257, 1000]),  # two tiles a page
])
def test_tiled_plain_decode_fp32_matches_jax_oracle(page_size, lengths):
    """fp32 pools: the plain version's 128-token tiles, each against its own
    max and merged through the LSE, give the XLA oracle's one softmax to
    fp32 rounding (p stays fp32), and commit into the clamped slot."""
    b, hq, g, hd, s = len(lengths), 6, 2, 12, 1024
    jc, tc = filled_caches(b, g, hd, s, lengths, seed=7, page_size=page_size)
    rs = np.random.RandomState(8)
    q = rs.randn(b, hq, hd).astype(np.float32)
    kc = rs.randn(b, g, hd).astype(np.float32)
    vc = rs.randn(b, g, hd).astype(np.float32)
    ref = jda.paged_decode_attention_xla(
        jnp.asarray(q), jc.kv_pages[1], jc.page_table, jc.lengths, scale=0.3,
        k_cur=jnp.asarray(kc), v_cur=jnp.asarray(vc),
    )
    ref_pool = jc.append_token(1, jnp.asarray(kc), jnp.asarray(vc)).kv_pages
    out = tda.paged_decode_attention_commit(
        torch.from_numpy(q), tc.kv_pages, 1, tc.page_table, tc.lengths,
        scale=0.3, k_cur=torch.from_numpy(kc), v_cur=torch.from_numpy(vc),
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)
    np.testing.assert_array_equal(to_jax_layout(tc.kv_pages), np.asarray(ref_pool))


def test_plain_decode_bf16_pool_rounds_p_like_the_jax_kernel():
    """bf16 pools: the plain version rounds each tile's p to bf16 before p.v,
    as the JAX kernel (interpret mode) rounds p before its bf16 P.V product.
    fp32 q and current token, so the output stays fp32 and the rounding
    shows.  B=4 and an odd pages_per_seq make the JAX kernel stream one page
    (one 128-token tile) per chunk, so its p is rounded per tile too, but
    against its running max, not the tile's own: the two agree to the bf16
    rounding of p (measured max 4.3e-4, mean 3.8e-5), closer than with p
    kept in fp32 (max 7.9e-4, mean 8.4e-5).  The committed pool is
    bit-equal."""
    b, g, n, hd, s = 4, 8, 3, 60, 5 * PS
    lengths = [0, 129, 384, 600]
    rs = np.random.RandomState(21)
    ks = rs.randn(b, s, g, hd).astype(np.float32)
    vs = rs.randn(b, s, g, hd).astype(np.float32)
    jc = jda.PagedKVCache.create(2, b, s, g, hd, page_size=PS, dtype=jnp.bfloat16)
    jc = jc.append_tokens(1, jnp.asarray(ks), jnp.asarray(vs))
    jc = jc.replace(lengths=jnp.asarray(lengths, jnp.int32))
    pool = torch.from_numpy(np.swapaxes(np.asarray(jc.kv_pages, np.float32), -1, -2).copy())
    tc = tda.PagedKVCache(
        kv_pages=pool.to(torch.bfloat16),
        page_table=torch.from_numpy(np.array(jc.page_table)),
        lengths=torch.tensor(lengths, dtype=torch.int32), head_dim=hd,
    )
    q = rs.randn(b, g * n, hd).astype(np.float32)
    kc = rs.randn(b, g, hd).astype(np.float32)
    vc = rs.randn(b, g, hd).astype(np.float32)
    ref, ref_pool = jda.paged_decode_attention_commit(
        jnp.asarray(q), jc.kv_pages, 1, jc.page_table, jc.lengths, scale=hd**-0.5,
        k_cur=jnp.asarray(kc), v_cur=jnp.asarray(vc), interpret=True,
    )
    ref = np.asarray(ref)
    assert ref.dtype == np.float32
    # p kept in fp32: the same tiles over the bf16 values, read as fp32
    rounded = lambda x: torch.from_numpy(x).to(torch.bfloat16).float()  # noqa: E731
    fp32_p = tda.paged_decode_attention_ref(
        rounded(q), tc.kv_pages[1].float(), tc.page_table, tc.lengths, scale=hd**-0.5,
        k_cur=rounded(kc), v_cur=rounded(vc),
    ).numpy()
    out = tda.paged_decode_attention_commit(
        torch.from_numpy(q), tc.kv_pages, 1, tc.page_table, tc.lengths, scale=hd**-0.5,
        k_cur=torch.from_numpy(kc), v_cur=torch.from_numpy(vc),
    )
    assert out.dtype == torch.float32
    err = np.abs(out.numpy() - ref)
    assert err.max() <= 2e-3
    assert err.mean() < np.abs(fp32_p - ref).mean()
    np.testing.assert_array_equal(
        np.swapaxes(tc.kv_pages.float().numpy(), -1, -2), np.asarray(ref_pool, np.float32))


def test_paged_cache_appends_match_jax():
    b, g, hd, s = 2, 2, 12, 3 * PS
    rs = np.random.RandomState(5)
    jc = jda.PagedKVCache.create(2, b, s, g, hd, page_size=PS, dtype=jnp.float32)
    tc = tda.PagedKVCache.create(2, b, s, g, hd, page_size=PS, dtype=torch.float32,
                                 device="cpu")
    assert tc.fresh and jc.fresh
    assert tc.kv_pages.shape == (2, b * 3, 2, g, PS, 16)

    def both(fn_name, layer, *arrs):
        nonlocal jc
        jc = getattr(jc, fn_name)(layer, *map(jnp.asarray, arrs))
        getattr(tc, fn_name)(layer, *map(torch.from_numpy, arrs))

    # fresh prefill of 150 tokens (two pages, the second partly filled)
    t = 150
    both("append_window_pages", 0, rs.randn(b, t, g, hd).astype(np.float32),
         rs.randn(b, t, g, hd).astype(np.float32))
    assert not tc.fresh
    counts = np.array([150, 97], np.int32)
    jc = jc.advance_by(jnp.asarray(counts))
    tc.advance_by(torch.from_numpy(counts))
    both("append_tokens", 1, rs.randn(b, 20, g, hd).astype(np.float32),
         rs.randn(b, 20, g, hd).astype(np.float32))
    both("append_token", 1, rs.randn(b, g, hd).astype(np.float32),
         rs.randn(b, g, hd).astype(np.float32))
    jc, _ = jc.advance(), tc.advance()
    np.testing.assert_array_equal(to_jax_layout(tc.kv_pages), np.asarray(jc.kv_pages))
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    for layer in (0, 1):
        jk, jv = jc.gather_dense_t(layer)
        tk, tv = tc.gather_dense_t(layer)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_quantize_kv_matches_jax():
    x = np.random.RandomState(6).randn(3, 4, 60).astype(np.float32) * 3
    x[0, 0] = 0.0  # scale floor
    jq, js = jda.quantize_kv(jnp.asarray(x))
    tq, ts = tda.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7)


def test_page_size_rule_and_int8_not_ported():
    """Pages are whole 128-token tiles; int8 pools (K4, ported since) come
    with their scales pool and pad the head dim to 16 bytes of int8."""
    with pytest.raises(ValueError):
        tda.PagedKVCache.create(1, 1, 256, 2, 8, page_size=32, device="cpu")
    c = tda.PagedKVCache.create(1, 1, 256, 2, 8, dtype=torch.int8, device="cpu")
    assert c.kv_pages.shape == (1, 2, 2, 2, 128, 16) and c.kv_pages.dtype == torch.int8
    assert c.kv_scales.shape == (1, 2, 2, 2, 128) and c.kv_scales.dtype == torch.float32
