"""K6's plain version and the rule that selects K6 (``ops/paged_prefill_attention.py``).

A prefill into a paged cache with history attends the row's cached tokens
and its window.  On the card K6 reads the pages through the table; here
(no card) its wrapper runs the plain version, which must be the gather path
the attention ran before K6 bit for bit, so every CPU output of the model
and the serving engine stays as it was.  The kernel itself is held against
the plain version in ``tests/test_torch_cuda_kernels.py`` (``-m cuda``).
"""

import pytest
import torch

from vats_tpu_torch.configs import nlp_xsmall
from vats_tpu_torch.inference import SamplingParams, ServingEngine
from vats_tpu_torch.models import TextLM
from vats_tpu_torch.ops import paged_prefill_attention as pp
from vats_tpu_torch.ops.attention_ref import cached_decode_attention
from vats_tpu_torch.ops.decode_attention import PagedKVCache, quantize_kv

torch.set_num_threads(1)


def _gather_path(q, cache, layer, window_mask, scale, left_window):
    """The attention's history branch as it was before K6: every page
    gathered, masks built over the whole table, plain cached attention."""
    lengths, t = cache.lengths, q.shape[1]
    k_buf, v_buf = cache.gather_dense_t(layer)
    s = k_buf.shape[-1]
    buf_pos = torch.arange(s)[None, :]
    kv_valid = buf_pos < (lengths + t)[:, None]
    if window_mask is not None:
        in_window = (buf_pos >= lengths[:, None]) & kv_valid
        rel = torch.clamp(buf_pos - lengths[:, None], 0, t - 1)
        window_valid = torch.gather(window_mask.bool(), 1, rel)
        kv_valid = kv_valid & torch.where(in_window, window_valid, True)
    return cached_decode_attention(
        q, k_buf, v_buf, scale=scale, causal=True, left_window=left_window,
        q_positions=lengths[:, None] + torch.arange(t)[None, :],
        kv_positions=torch.arange(s), kv_valid=kv_valid)


# (pool dtype, head dim, starts, tails, left window); a tail of None: no mask
CASES = {
    "bf16_fresh_and_prefix_hits": (torch.bfloat16, 60, [0, 128, 256, 0], [40, 64, 7, 1], -1),
    "bf16_no_mask": (torch.bfloat16, 60, [0, 384], None, -1),
    "bf16_left_window": (torch.bfloat16, 32, [0, 256, 128], [64, 50, 3], 40),
    "bf16_past_capacity": (torch.bfloat16, 60, [448, 0], [40, 64], -1),
    "fp32": (torch.float32, 12, [0, 128], [30, 64], -1),
    "int8": (torch.int8, 60, [0, 256], [64, 20], -1),
}


def _case(name, t=64, g=2, n=3, pps=4, ps=128, nl=2):
    dtype, hd, starts, tails, lw = CASES[name]
    gen = torch.Generator().manual_seed(7)
    b = len(starts)
    cache = PagedKVCache.create(nl, b, pps * ps, g, hd, page_size=ps, dtype=dtype)
    hist = torch.randn((nl, b * pps * ps, 2, g, hd), generator=gen)
    if dtype == torch.int8:
        q8, sc = quantize_kv(hist)
        cache.kv_pages[..., :hd] = q8.reshape(nl, b * pps, ps, 2, g, hd).permute(
            0, 1, 3, 4, 2, 5)
        cache.kv_scales[:] = sc.reshape(nl, b * pps, ps, 2, g).permute(0, 1, 3, 4, 2)
    else:
        cache.kv_pages[..., :hd] = hist.reshape(nl, b * pps, ps, 2, g, hd).permute(
            0, 1, 3, 4, 2, 5).to(dtype)
    cache.page_table = cache.page_table[torch.randperm(b, generator=gen)].contiguous()
    cache.lengths = torch.tensor(starts, dtype=torch.int32)
    cache.fresh = False
    mask = None
    if tails is not None:
        mask = torch.arange(t)[None, :] < torch.tensor(tails)[:, None]
    q_dtype = torch.bfloat16 if dtype == torch.int8 else dtype
    q = torch.randn((b, t, g * n, cache.kv_pages.shape[-1]), generator=gen)
    q[..., hd:] = 0
    return q.to(q_dtype), cache, mask, lw


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_is_the_gather_path_bit_for_bit(name):
    """The plain version, and on CPU tensors the K6 wrapper where the rule
    takes it, give the old gather path's bits."""
    q, cache, mask, lw = _case(name)
    want = _gather_path(q, cache, 1, mask, 0.2, lw)
    got = pp.paged_prefill_attention_ref(
        q, cache.kv_pages, 1, cache.page_table, cache.lengths, scale=0.2,
        window_mask=mask, left_window=lw, kv_scales=cache.kv_scales)
    assert got.dtype == q.dtype and torch.equal(got, want)
    if pp.kernel_fits(cache.kv_pages):
        n0 = pp.paged_prefill_attention.launches
        got = pp.paged_prefill_attention(q, cache.kv_pages, 1, cache.page_table,
                                         cache.lengths, scale=0.2, window_mask=mask,
                                         left_window=lw)
        assert torch.equal(got, want)
        assert pp.paged_prefill_attention.launches == n0  # counts launches, none here


@pytest.mark.parametrize("dtype,hd_pad,fits", [
    (torch.bfloat16, 16, True), (torch.bfloat16, 32, True), (torch.bfloat16, 48, True),
    (torch.bfloat16, 64, True),  # the LM's 60 -> 64
    (torch.bfloat16, 96, True),  # the multimodal model's 96
    (torch.bfloat16, 128, True),
    (torch.bfloat16, 8, False), (torch.bfloat16, 24, False),  # image generation's 24
    (torch.bfloat16, 72, False), (torch.bfloat16, 144, False), (torch.bfloat16, 192, False),
    (torch.float32, 64, False), (torch.float16, 64, False),
    (torch.int8, 64, False),  # K4's int8 pools
])
def test_selection_rule(dtype, hd_pad, fits):
    """K6 reads bf16 pools whose stored head dim is a multiple of 16, at most
    128; every other pool keeps the gather path."""
    pool = torch.zeros((1, 1, 2, 1, 128, hd_pad), dtype=dtype)
    assert pp.kernel_fits(pool) is fits


@pytest.mark.parametrize("dtype,hd", [(torch.int8, 64), (torch.bfloat16, 24),
                                      (torch.float32, 64)])
def test_wrapper_rejects_pools_it_cannot_read(dtype, hd):
    """The K6 wrapper raises on a pool the rule gives to the gather path, on
    every device: it has no fallback."""
    pool = torch.zeros((1, 2, 2, 2, 128, hd), dtype=dtype)
    q = torch.zeros((1, 8, 6, hd), dtype=torch.bfloat16)
    table = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="bf16 pools"):
        pp.paged_prefill_attention(q, pool, 0, table, torch.zeros(1, dtype=torch.int32),
                                   scale=0.1)


def _spy(monkeypatch):
    """Count the attention's calls of the K6 wrapper."""
    calls = []
    wrapper = pp.paged_prefill_attention

    def spy(*a, **kw):
        calls.append(a[2])
        return wrapper(*a, **kw)

    monkeypatch.setattr(pp, "paged_prefill_attention", spy)
    return calls


def _lm(hd, dtype="bfloat16", layers=2):
    cfg = nlp_xsmall(d_model=4 * hd, num_heads=4, query_groups=2, d_ffn=128,
                     num_layers=layers, vocab_size=128, dropout=0.0, max_seq_len=512,
                     use_mqa=False, gradient_checkpointing=False, left_window=100,
                     softmax_scale=None, dtype=dtype, param_dtype="float32")
    return TextLM(cfg, device="cpu", seed=3).eval()


@pytest.mark.parametrize("hd,kv_dtype,takes_k6", [
    (60, torch.bfloat16, True), (24, torch.bfloat16, False), (60, torch.int8, False),
])
def test_attention_takes_k6_where_the_rule_holds(monkeypatch, hd, kv_dtype, takes_k6):
    """A prefill into a cache with history goes through the K6 wrapper once a
    layer where the pool fits, and not at all elsewhere; a fresh prefill and
    decode never do.  Its output equals the gather path's."""
    model = _lm(hd)
    calls = _spy(monkeypatch)
    cache = PagedKVCache.create(2, 2, 512, 2, hd, page_size=128, dtype=kv_dtype)
    gen = torch.Generator().manual_seed(0)
    ids = torch.randint(1, 128, (2, 40), generator=gen)
    mask = torch.ones((2, 40), dtype=torch.bool)
    mask[1, 30:] = False
    with torch.no_grad():
        _, cache, _ = model(ids, padding_mask=mask, paged_cache=cache)
        assert calls == []  # fresh: K2 or the plain attention
        tail = torch.randint(1, 128, (2, 16), generator=gen)
        tmask = torch.ones((2, 16), dtype=torch.bool)
        tmask[0, 9:] = False
        state = (cache.kv_pages.clone(), cache.lengths.clone())
        logits, _, _ = model(tail, padding_mask=tmask, paged_cache=cache)
        assert calls == ([0, 1] if takes_k6 else [])
        # the same forward with the selection turned off: the gather path
        cache.kv_pages.copy_(state[0])
        cache.lengths.copy_(state[1])
        monkeypatch.setattr(pp, "kernel_fits", lambda pool: False)
        plain, _, _ = model(tail, padding_mask=tmask, paged_cache=cache)
    assert torch.equal(logits, plain)


def test_serving_engine_outputs_unchanged(monkeypatch):
    """A bf16 engine on the CPU (prefix hits, grouped prefills padded with
    scratch rows, a preemption, sampled and greedy rows) gives the same
    tokens with K6 selected as with the gather path forced, and calls the
    K6 wrapper once a layer a prefill forward; with speculative decoding,
    once a layer a prefill or verify forward."""
    model = _lm(60)
    system = [(13 * i) % 120 + 1 for i in range(250)]
    stream = [(system + [7, i + 1], 10) for i in range(5)] + [([5, 9, 17], 8),
                                                              ([i % 120 + 1 for i in range(139)], 6)]

    def serve(stream, **kw):
        eng = ServingEngine(model, max_batch=4, max_context=512, prefix_caching=True,
                            total_pages=1 + 7, **kw)
        sampled = kw.get("per_request_sampling", False)
        rids = [eng.submit(p, max_new_tokens=n, sampling=SamplingParams(
            temperature=0.8, top_k=20, seed=i) if sampled and i % 3 == 1 else None)
            for i, (p, n) in enumerate(stream)]
        out = eng.run()
        return [out[r] for r in rids], eng

    for kw in (dict(decode_block_steps=2, per_request_sampling=True), dict(spec_k=2)):
        calls = _spy(monkeypatch)
        got, eng = serve(stream, **kw)
        forwards = eng.forwards["prefill"] + eng.forwards.get("verify", 0)
        assert len(calls) == model.cfg.num_layers * forwards > 0
        assert eng.prefix_cache.hit_tokens > 0 and eng.preemptions >= 1
        with monkeypatch.context() as m:
            m.setattr(pp, "kernel_fits", lambda pool: False)
            want, _ = serve(stream, **kw)
        assert got == want
