"""int8 paged KV (K4's plain version and the int8 pool) against vats_tpu.

Mirrors ``tests/test_kv_quant.py``.  The JAX pool is sequence-minor
[L, P, 2, G, hd_pad, ps] with scales [L, P, 2, G_pad8, ps]; the port's is
head-dim minor [L, P, 2, G, ps, hd_pad] with scales [L, P, 2, G, ps].  Pools
are compared after swapping the last two axes, byte for byte; scales after
dropping the JAX group pad, to rtol 1e-6.  Attention outputs are fp32 on
both sides: rtol 2e-4 / atol 2e-5, the bound the JAX tests hold their own
kernel to against their oracle (the same dequantized softmax with sums in
another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import meta

from vats_tpu.ops import decode_attention as jda
from vats_tpu_torch.ops import decode_attention as tda

torch.set_num_threads(1)

PS = 128
ATTN_TOL = dict(rtol=2e-4, atol=2e-5)


def to_port(pool):
    return torch.from_numpy(np.array(np.swapaxes(np.asarray(pool), -1, -2)))


def to_jax_layout(pool):
    return np.swapaxes(pool.numpy(), -1, -2)


def port_scales(jc):
    g = jc.kv_pages.shape[3]
    return torch.from_numpy(np.array(jc.kv_scales[:, :, :, :g]))


def assert_pools_equal(tc, jc):
    np.testing.assert_array_equal(to_jax_layout(tc.kv_pages), np.asarray(jc.kv_pages))
    g = tc.kv_pages.shape[3]
    np.testing.assert_allclose(tc.kv_scales.numpy(), np.asarray(jc.kv_scales)[:, :, :, :g],
                               rtol=1e-6)
    # the JAX pad groups hold scale 0
    assert not np.asarray(jc.kv_scales)[:, :, :, g:].any()


def filled_int8_caches(b, g, hd, s, lengths, seed, n_layers=1, layer=0):
    """Both packages' int8 caches with every slot of ``layer`` written by
    append_tokens, then the given lengths."""
    rs = np.random.RandomState(seed)
    ks = rs.randn(b, s, g, hd).astype(np.float32)
    vs = rs.randn(b, s, g, hd).astype(np.float32)
    jc = jda.PagedKVCache.create(n_layers, b, s, g, hd, page_size=PS, dtype=jnp.int8)
    tc = tda.PagedKVCache.create(n_layers, b, s, g, hd, page_size=PS, dtype=torch.int8,
                                 device="cpu")
    jc = jc.append_tokens(layer, jnp.asarray(ks), jnp.asarray(vs))
    tc.append_tokens(layer, torch.from_numpy(ks), torch.from_numpy(vs))
    jc = jc.replace(lengths=jnp.asarray(lengths, jnp.int32))
    tc.lengths = torch.tensor(lengths, dtype=torch.int32)
    assert_pools_equal(tc, jc)
    return jc, tc


def test_quantize_kv_byte_equal_to_jax():
    x = np.random.RandomState(0).randn(50, 8, 64).astype(np.float32) * 5.0
    x[0, 0] = 0.0  # the scale floor
    x[1, 1, 3] = 1e-9  # below the floor
    jq, js = jda.quantize_kv(jnp.asarray(x))
    tq, ts = tda.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == (50, 8)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    assert not tq[0, 0].any()


def test_int8_cache_create_and_appends_byte_equal_to_jax():
    b, g, hd, s = 2, 2, 12, 3 * PS
    rs = np.random.RandomState(5)
    jc = jda.PagedKVCache.create(2, b, s, g, hd, page_size=PS, dtype=jnp.int8)
    tc = tda.PagedKVCache.create(2, b, s, g, hd, page_size=PS, dtype=torch.int8,
                                 device="cpu")
    assert tc.quantized and tc.kv_pages.dtype == torch.int8
    assert tc.kv_pages.shape == (2, b * 3, 2, g, PS, 16)
    assert tc.kv_scales.shape == (2, b * 3, 2, g, PS) and tc.kv_scales.dtype == torch.float32
    assert not tda.PagedKVCache.create(1, 1, PS, g, hd, device="cpu").quantized

    def both(fn_name, layer, *arrs):
        nonlocal jc
        jc = getattr(jc, fn_name)(layer, *map(jnp.asarray, arrs))
        getattr(tc, fn_name)(layer, *map(torch.from_numpy, arrs))

    def kv(*shape):
        return (rs.randn(*shape) * 2).astype(np.float32)

    both("append_window_pages", 0, kv(b, 150, g, hd), kv(b, 150, g, hd))
    counts = np.array([150, 97], np.int32)
    jc = jc.advance_by(jnp.asarray(counts))
    tc.advance_by(torch.from_numpy(counts))
    both("append_tokens", 1, kv(b, 20, g, hd), kv(b, 20, g, hd))
    both("append_token", 1, kv(b, g, hd), kv(b, g, hd))
    jc, _ = jc.advance(), tc.advance()
    assert_pools_equal(tc, jc)
    for layer in (0, 1):  # dequantized into bf16 on both sides
        jk, jv = jc.gather_dense_t(layer)
        tk, tv = tc.gather_dense_t(layer)
        assert tk.dtype == torch.bfloat16
        np.testing.assert_array_equal(tk.float().numpy(), np.asarray(jk, np.float32))
        np.testing.assert_array_equal(tv.float().numpy(), np.asarray(jv, np.float32))


@pytest.mark.parametrize("lengths", [[256, 256], [130, 5], [1, 129]])
def test_plain_int8_attention_matches_jax_kernel_and_oracle(lengths):
    b, hq, g, hd, s = 2, 4, 2, 12, 2 * PS
    jc, tc = filled_int8_caches(b, g, hd, s, lengths, seed=4)
    rs = np.random.RandomState(sum(lengths))
    q = rs.randn(b, hq, hd).astype(np.float32)
    kc = rs.randn(b, g, hd).astype(np.float32)
    vc = 2.0 * kc
    jargs = (jnp.asarray(q), jc.kv_pages[0], jc.page_table, jc.lengths)
    jkw = dict(scale=0.25, k_cur=jnp.asarray(kc), v_cur=jnp.asarray(vc),
               kv_scales=jc.kv_scales[0])
    out_kernel = jda.paged_decode_attention(*jargs, **jkw, interpret=True)
    out_xla = jda.paged_decode_attention_xla(*jargs, **jkw)
    before = tc.kv_pages.clone()
    out = tda.paged_decode_attention(
        torch.from_numpy(q), tc.kv_pages, 0, tc.page_table, tc.lengths, scale=0.25,
        k_cur=torch.from_numpy(kc), v_cur=torch.from_numpy(vc), kv_scales=tc.kv_scales,
    )
    assert torch.equal(before, tc.kv_pages)  # no commit
    np.testing.assert_allclose(out.numpy(), np.asarray(out_kernel), **ATTN_TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_xla), **ATTN_TOL)


@pytest.mark.parametrize("lengths", [[130, 5], [0, 1], [255, 256], [0, 0]])
def test_plain_int8_commit_matches_jax_kernel(lengths):
    """Attend + commit on an int8 pool: the port's plain version against
    the JAX kernel (interpret mode): output close, the int8 pool byte-equal
    and the scales equal (in-kernel quantization == quantize_kv)."""
    b, hq, g, hd, s, layer = 2, 4, 2, 12, 2 * PS, 1
    rs = np.random.RandomState(7 + sum(lengths))
    q = rs.randn(b, hq, hd).astype(np.float32)
    kc = rs.randn(b, g, hd).astype(np.float32)
    vc = -3.0 * kc
    if max(lengths) > 0:
        jc, tc = filled_int8_caches(b, g, hd, s, lengths, seed=5, n_layers=2, layer=layer)
    else:
        jc = jda.PagedKVCache.create(2, b, s, g, hd, page_size=PS, dtype=jnp.int8)
        tc = tda.PagedKVCache.create(2, b, s, g, hd, page_size=PS, dtype=torch.int8,
                                     device="cpu")
        jc = jc.replace(lengths=jnp.asarray(lengths, jnp.int32))
        tc.lengths = torch.tensor(lengths, dtype=torch.int32)
    out_j, pool_j, scales_j = jda.paged_decode_attention_commit(
        jnp.asarray(q), jc.kv_pages, layer, jc.page_table, jc.lengths, scale=0.25,
        k_cur=jnp.asarray(kc), v_cur=jnp.asarray(vc), kv_scales=jc.kv_scales,
        interpret=True,
    )
    n0 = tda.paged_decode_attention_commit_int8.launches
    out = tda.paged_decode_attention_commit(
        torch.from_numpy(q), tc.kv_pages, layer, tc.page_table, tc.lengths,
        scale=0.25, k_cur=torch.from_numpy(kc), v_cur=torch.from_numpy(vc),
        kv_scales=tc.kv_scales,
    )
    assert tda.paged_decode_attention_commit_int8.launches == n0  # CPU: no kernel
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **ATTN_TOL)
    assert_pools_equal(tc, jc.replace(kv_pages=pool_j, kv_scales=scales_j))


def test_gather_dequantizes_into_bf16_in_an_fp32_model():
    """The tail prefill reads int8 history as bf16 whatever the compute
    dtype: an fp32 query attends bf16-rounded history, as in vats_tpu."""
    tc = tda.PagedKVCache.create(1, 1, PS, 1, 16, dtype=torch.int8, device="cpu")
    x = torch.linspace(-3, 3, 16)[None, None, None].expand(1, 5, 1, 16).contiguous()
    tc.append_tokens(0, x, x)
    k, _ = tc.gather_dense_t(0)
    q, sc = tda.quantize_kv(x[0, 0, 0])
    want = (q.float() * sc).to(torch.bfloat16)
    assert torch.equal(k[0, 0, :, 0], want)


def both_models(**kw):
    from vats_tpu.configs import nlp_xsmall as j_nlp_xsmall
    from vats_tpu.models import TextLM as JTextLM
    from vats_tpu_torch.configs import nlp_xsmall
    from vats_tpu_torch.models import TextLM
    from vats_tpu_torch.utils.convert import params_from_jax

    base = dict(d_model=64, num_heads=4, query_groups=2, d_ffn=128, num_layers=2,
                vocab_size=128, dropout=0.0, num_experts=1, top_k=1,
                max_seq_len=512, use_mqa=False, gradient_checkpointing=False,
                dtype="float32", param_dtype="float32")
    base.update(kw)
    jm = JTextLM(j_nlp_xsmall(**base))
    params = jm.init(jax.random.PRNGKey(7), jnp.ones((2, 8), jnp.int32))
    cfg = nlp_xsmall(**base)
    tm = TextLM(cfg, device="meta")
    tm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, meta.unbox(params)), cfg), assign=True)
    return jm, params, tm.eval()


@pytest.mark.parametrize("lens", [[8, 8], [8, 3]])
def test_generate_paged_int8_greedy_tokens_equal_jax(lens):
    from vats_tpu.inference.generate import generate_paged as j_generate_paged
    from vats_tpu_torch.inference import generate_paged

    jm, params, tm = both_models()
    rs = np.random.RandomState(6)
    ids = rs.randint(1, 128, (2, 8)).astype(np.int32)
    mask = np.arange(8)[None, :] < np.asarray(lens)[:, None]
    ids = np.where(mask, ids, 0)
    kw = dict(max_new_tokens=12, temperature=0.0, do_sample=False, pad_token_id=0,
              total_len=256, kv_quant="int8")
    jt, jl = j_generate_paged(jm, params, jnp.asarray(ids), jnp.asarray(mask),
                              jax.random.PRNGKey(8), **kw)
    tt, tl = generate_paged(tm, torch.from_numpy(ids), torch.from_numpy(mask), None, **kw)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
