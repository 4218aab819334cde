"""The port's continuous-batching engine: the contracts of
``tests/test_serving.py`` and equality with ``vats_tpu``'s engine.

Oracle, as in the JAX tests: a request served through ``ServingEngine``
(whatever rows, batchmates, preemptions or prefix hits it met) produces
exactly the greedy tokens the port's ``generate_paged`` gives it alone.
Cross-package: the JAX engine and the port's run one request stream on the
same weights (fp32 on the CPU, greedy), with a full-precision pool and an
int8 pool, prefix caching on and a pool that forces a preemption: every
request's tokens are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import meta

from vats_tpu.configs import nlp_xsmall as j_nlp_xsmall
from vats_tpu.inference.sampling import sample_logits_per_row as j_per_row
from vats_tpu.inference.serving import ServingEngine as JServingEngine
from vats_tpu.models import TextLM as JTextLM
from vats_tpu_torch.configs import nlp_xsmall
from vats_tpu_torch.inference import (
    PageAllocator,
    PrefixCache,
    QuantizedModel,
    SamplingParams,
    ServingEngine,
    generate_paged,
)
from vats_tpu_torch.inference.sampling import keyed_uniform, sample_logits_per_row
from vats_tpu_torch.models import TextLM
from vats_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

CFG = dict(
    d_model=64, num_heads=4, query_groups=2, d_ffn=128, num_layers=2,
    vocab_size=128, dropout=0.0, num_experts=1, top_k=1,
    max_seq_len=512, use_mqa=False, gradient_checkpointing=False,
    dtype="float32", param_dtype="float32",
)


@pytest.fixture(scope="module")
def models():
    """(JAX model, JAX params, port model) with the same weights."""
    jm = JTextLM(j_nlp_xsmall(**CFG))
    params = jm.init(jax.random.PRNGKey(0), jnp.ones((1, 8), jnp.int32))
    cfg = nlp_xsmall(**CFG)
    tm = TextLM(cfg, device="meta")
    pnp = jax.tree_util.tree_map(np.asarray, meta.unbox(params))
    tm.load_state_dict(params_from_jax(pnp, cfg), assign=True)
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def model(models):
    return models[2]


def oracle(model, prompt, max_new, total_len=256, kv_quant=None):
    ids = torch.tensor([prompt], dtype=torch.int32)
    toks, lengths = generate_paged(
        model, ids, torch.ones_like(ids, dtype=torch.bool), None,
        max_new_tokens=max_new, temperature=0.0, do_sample=False,
        pad_token_id=0, total_len=total_len, kv_quant=kv_quant,
    )
    return toks[0, len(prompt):int(lengths[0])].tolist()


PROMPTS = [
    [5, 9, 17, 3],
    [88, 11],
    [7, 7, 23, 45, 101, 2, 19],
    [64, 3, 12],
    [120, 5, 5, 5, 31, 8],
]
SYSTEM_PROMPT = [(13 * i) % 120 + 1 for i in range(300)]  # 2 full 128-pages


def test_page_allocator():
    a = PageAllocator(8)  # pages 1..7 usable
    assert a.capacity == 7
    p1 = a.alloc(3)
    assert len(set(p1)) == 3 and all(1 <= p < 8 for p in p1)
    with pytest.raises(MemoryError):
        a.alloc(5)
    a.free(p1[:2])
    assert a.num_free == 6
    assert a.high_water == 3


def test_engine_greedy_matches_generate_paged(model):
    eng = ServingEngine(model, max_batch=2, max_context=256)
    rid = eng.submit(PROMPTS[0], max_new_tokens=10)
    assert eng.run()[rid] == oracle(model, PROMPTS[0], 10)
    assert eng.device == model.device


def test_continuous_batching_parity_and_reuse(model):
    """5 requests through 2 rows: each matches its solo oracle, and retired
    rows' pages are reused."""
    eng = ServingEngine(model, max_batch=2, max_context=256)
    rids = {eng.submit(p, max_new_tokens=6 + i): (p, 6 + i)
            for i, p in enumerate(PROMPTS)}
    out = eng.run()
    assert set(out) == set(rids)
    for rid, (p, n) in rids.items():
        assert out[rid] == oracle(model, p, n), f"request {rid} diverged"
    assert eng.allocator.num_used == 0
    assert eng.allocator.high_water <= 2 * eng.pages_per_row


def test_pool_smaller_than_batch_queues_on_pages(model):
    eng = ServingEngine(model, max_batch=2, max_context=256, total_pages=1 + 2)
    rids = [eng.submit(p, max_new_tokens=5) for p in PROMPTS[:3]]
    out = eng.run()
    for rid, p in zip(rids, PROMPTS[:3]):
        assert out[rid] == oracle(model, p, 5)
    assert eng.allocator.high_water <= 2


@pytest.mark.parametrize("max_new", [8, 20])
def test_engine_int8_kv_matches_fp_pool(model, max_new):
    """int8 pages track the full-precision pool on this model, and equal the
    int8 ``generate_paged`` solo oracle exactly."""
    kw = dict(max_batch=2, max_context=256)
    e_fp, e_q = ServingEngine(model, **kw), ServingEngine(model, kv_quant="int8", **kw)
    assert e_q.pool.dtype == torch.int8 and e_q.scales.dtype == torch.float32
    r1 = e_fp.submit(PROMPTS[2], max_new_tokens=max_new)
    r2 = e_q.submit(PROMPTS[2], max_new_tokens=max_new)
    out_q = e_q.run()[r2]
    assert e_fp.run()[r1] == out_q
    assert out_q == oracle(model, PROMPTS[2], max_new, kv_quant="int8")


def test_engine_eos_frees_early(model):
    toks = oracle(model, PROMPTS[0], 8)
    eos = toks[2]
    eng = ServingEngine(model, max_batch=1, max_context=256, eos_token_id=eos)
    rid = eng.submit(PROMPTS[0], max_new_tokens=8)
    assert eng.run()[rid] == toks[: toks.index(eos) + 1]
    assert eng.allocator.num_used == 0


def test_preemption_requeues_and_reproduces(model):
    long_a = [(7 * i) % 120 + 1 for i in range(122)]
    long_b = [(5 * i) % 120 + 1 for i in range(122)]
    eng = ServingEngine(model, max_batch=2, max_context=256, total_pages=1 + 3)
    r1 = eng.submit(long_a, max_new_tokens=10)
    r2 = eng.submit(long_b, max_new_tokens=10)
    out = eng.run()
    assert eng.preemptions >= 1, "pool pressure never triggered preemption"
    assert out[r1] == oracle(model, long_a, 10)
    assert out[r2] == oracle(model, long_b, 10)
    assert eng.allocator.num_used == 0


def test_prefix_cache_unit():
    pc = PrefixCache()
    keys = PrefixCache.chain_keys(SYSTEM_PROMPT, 128, 2)
    assert pc.lookup(keys) == []
    assert pc.insert(keys[0], 7) and pc.insert(keys[1], 9)
    assert not pc.insert(keys[0], 11), "duplicate insert must be rejected"
    assert pc.lookup(keys) == [7, 9]
    other = PrefixCache.chain_keys([5] + SYSTEM_PROMPT[1:], 128, 2)
    assert pc.lookup(other) == []
    pc.acquire(keys[:1])
    pc.release(keys)
    assert pc.reclaim(4) == [9]
    pc.release(keys[:1])
    assert pc.reclaim(4) == [7]
    assert pc.num_cached == 0


def test_prefix_cache_sequential_hit_and_parity(model):
    eng = ServingEngine(model, max_batch=1, max_context=512, prefix_caching=True)
    tail_a, tail_b = [3, 1, 4, 1, 5], [2, 7, 1, 8, 2, 8]
    ra = eng.submit(SYSTEM_PROMPT + tail_a, max_new_tokens=6)
    out_a = eng.run()[ra]
    assert eng.prefix_cache.hit_tokens == 0
    assert eng.prefix_cache.num_cached == 2
    rb = eng.submit(SYSTEM_PROMPT + tail_b, max_new_tokens=6)
    out_b = eng.run()[rb]
    assert eng.prefix_cache.hit_tokens == 256
    assert out_a == oracle(model, SYSTEM_PROMPT + tail_a, 6, 512)
    assert out_b == oracle(model, SYSTEM_PROMPT + tail_b, 6, 512)
    assert eng.allocator.num_used == eng.prefix_cache.num_cached


def test_prefix_cache_concurrent_share_and_reclaim(model):
    eng = ServingEngine(model, max_batch=2, max_context=512, prefix_caching=True,
                        total_pages=1 + 5)
    tails = ([9, 9, 2], [4, 4, 4, 6])
    rids = [eng.submit(SYSTEM_PROMPT + t, max_new_tokens=5) for t in tails]
    out = eng.run()
    assert eng.prefix_cache.hit_tokens == 256, "row 2 missed the shared pages"
    for rid, t in zip(rids, tails):
        assert out[rid] == oracle(model, SYSTEM_PROMPT + t, 5, 512)
    assert eng.prefix_cache.num_cached >= 2
    orig_keys = PrefixCache.chain_keys(SYSTEM_PROMPT, 128, 2)
    fresh = [(11 * i) % 120 + 1 for i in range(400)]  # 4 pages, 3 free
    rc = eng.submit(fresh, max_new_tokens=5)
    assert eng.run()[rc] == oracle(model, fresh, 5, 512)
    assert len(eng.prefix_cache.lookup(orig_keys)) < 2, "no reclaim under pressure"
    assert eng.preemptions == 0


def test_decode_block_steps_matches_single_step(model):
    eos = oracle(model, PROMPTS[0], 9)[5]
    outs = {}
    for k in (1, 4):
        eng = ServingEngine(model, max_batch=2, max_context=256, eos_token_id=eos,
                            decode_block_steps=k)
        for i, p in enumerate(PROMPTS):
            eng.submit(p, max_new_tokens=7 + i)
        outs[k] = eng.run()
        assert eng.allocator.num_used == 0
    assert outs[1] == outs[4]


def test_decode_block_near_context_cap_falls_back(model):
    prompt = [(3 * i) % 120 + 1 for i in range(120)]
    eng = ServingEngine(model, max_batch=1, max_context=128, decode_block_steps=4)
    rid = eng.submit(prompt, max_new_tokens=64)
    out = eng.run()[rid]
    assert len(out) == 128 - 120  # stopped by max_context, not budget
    assert out == oracle(model, prompt, 64, 128)[: len(out)]


def test_decode_block_spanning_multiple_new_pages(model):
    eng = ServingEngine(model, max_batch=1, max_context=512, decode_block_steps=260)
    rid = eng.submit(PROMPTS[2], max_new_tokens=260)
    assert eng.run()[rid] == oracle(model, PROMPTS[2], 260, 512)
    assert eng.allocator.num_used == 0
    assert eng.forwards["decode"] == 260


def test_prefix_reclaim_never_evicts_matched_pages(model):
    eng = ServingEngine(model, max_batch=1, max_context=512, prefix_caching=True,
                        total_pages=1 + 4)
    ra = eng.submit(SYSTEM_PROMPT, max_new_tokens=5)
    assert eng.run()[ra] == oracle(model, SYSTEM_PROMPT, 5, 512)
    assert eng.prefix_cache.num_cached == 2
    decoy = [(7 * i) % 120 + 1 for i in range(130)]
    rd = eng.submit(decoy, max_new_tokens=4)
    assert eng.run()[rd] == oracle(model, decoy, 4, 512)
    assert eng.prefix_cache.num_cached == 3
    assert eng.allocator.num_free == 1
    pb = SYSTEM_PROMPT + [(5 * i) % 120 + 1 for i in range(90)]
    rb = eng.submit(pb, max_new_tokens=5)
    out_b = eng.run()[rb]
    assert eng.prefix_cache.hit_tokens == 256
    assert out_b == oracle(model, pb, 5, 512)
    assert eng.allocator.num_used == eng.prefix_cache.num_cached


def test_spec_decode_matches_greedy_exactly(model):
    outs = {}
    for spec in (0, 3):
        eng = ServingEngine(model, max_batch=2, max_context=256, spec_k=spec)
        for i, p in enumerate(PROMPTS):
            eng.submit(p, max_new_tokens=8 + i)
        outs[spec] = eng.run()
        assert eng.allocator.num_used == 0
    assert outs[0] == outs[3]


def test_spec_decode_accepts_on_repetitive_context(model):
    prompt = ([17, 42, 99, 5] * 12)[:45]
    eng = ServingEngine(model, max_batch=1, max_context=256, spec_k=4)
    rid = eng.submit(prompt, max_new_tokens=24)
    assert eng.run()[rid] == oracle(model, prompt, 24)
    assert eng.spec_proposed > 0 and eng.spec_accepted > 0
    assert eng.forwards["verify"] < 24  # more than one token per model call


def test_spec_decode_rejects_sampling(model):
    for kw in (dict(do_sample=True), dict(decode_block_steps=4),
               dict(per_request_sampling=True), dict(overlap_scheduling=True)):
        with pytest.raises(ValueError):
            ServingEngine(model, max_batch=1, max_context=256, spec_k=2, **kw)
    with pytest.raises(ValueError):
        ServingEngine(model, max_batch=1, max_context=256, kv_quant="int4")


def test_batched_admission_group_parity(model):
    """Six admissions prefill as one group padded to 8 (two scratch rows)."""
    eng = ServingEngine(model, max_batch=8, max_context=256)
    prompts = PROMPTS + [[42] * 19]
    rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
    out = eng.run()
    assert eng.prefill_shapes == {(32, 8)}
    assert eng.forwards["prefill"] == 1
    for rid, p in zip(rids, prompts):
        assert out[rid] == oracle(model, p, 6)
    assert eng.allocator.num_used == 0


def test_per_request_sampling_mixed_batch(model):
    greedy = SamplingParams(temperature=0.0)
    sampled = SamplingParams(temperature=1.0, top_k=8, seed=1234)
    eng = ServingEngine(model, max_batch=2, max_context=256, per_request_sampling=True)
    ra = eng.submit(PROMPTS[0], max_new_tokens=10, sampling=greedy)
    rb = eng.submit(PROMPTS[2], max_new_tokens=12, sampling=sampled)
    out = eng.run()
    assert out[ra] == oracle(model, PROMPTS[0], 10)
    assert len(out[rb]) == 12
    assert out[rb] != oracle(model, PROMPTS[2], 12), "the sampled row never sampled"
    solo = ServingEngine(model, max_batch=2, max_context=256, per_request_sampling=True)
    rs = solo.submit(PROMPTS[2], max_new_tokens=12, sampling=sampled)
    assert solo.run()[rs] == out[rb], "seeded stream must not depend on batchmates"


def test_per_request_sampling_defaults_and_validation(model):
    eng = ServingEngine(model, max_batch=2, max_context=256, per_request_sampling=True)
    rids = [eng.submit(p, max_new_tokens=6) for p in PROMPTS[:2]]
    out = eng.run()
    for rid, p in zip(rids, PROMPTS[:2]):
        assert out[rid] == oracle(model, p, 6)
    eng2 = ServingEngine(model, max_batch=1, max_context=256)
    with pytest.raises(ValueError):
        eng2.submit(PROMPTS[0], max_new_tokens=4, sampling=SamplingParams())
    with pytest.raises(ValueError):
        eng2.submit([], max_new_tokens=4)
    with pytest.raises(ValueError):
        eng2.submit([1] * 256, max_new_tokens=4)  # prompt >= max_context


def test_overlap_scheduling_bitexact_greedy(model):
    eos = oracle(model, PROMPTS[0], 9)[5]
    outs = {}
    for overlap in (False, True):
        eng = ServingEngine(model, max_batch=2, max_context=256, eos_token_id=eos,
                            decode_block_steps=4, overlap_scheduling=overlap)
        for i, p in enumerate(PROMPTS):
            eng.submit(p, max_new_tokens=7 + i)
        outs[overlap] = eng.run()
        assert eng.allocator.num_used == 0
        assert eng._inflight is None
    assert outs[False] == outs[True]
    for i, p in enumerate(PROMPTS):
        want = oracle(model, p, 7 + i)
        if eos in want:
            want = want[: want.index(eos) + 1]
        assert outs[True][i] == want


def test_overlap_scheduling_seeded_sampling_reproducible(model):
    outs = {}
    for overlap in (False, True):
        eng = ServingEngine(model, max_batch=2, max_context=256, decode_block_steps=4,
                            per_request_sampling=True, overlap_scheduling=overlap)
        for i, p in enumerate(PROMPTS):
            eng.submit(p, max_new_tokens=9,
                       sampling=SamplingParams(temperature=0.8, top_k=20, seed=100 + i))
        outs[overlap] = eng.run()
    assert outs[False] == outs[True]


def test_overlap_scheduling_preemption_parity(model):
    eng = ServingEngine(model, max_batch=3, max_context=256, total_pages=5,
                        decode_block_steps=2, overlap_scheduling=True)
    rids = {eng.submit(p, max_new_tokens=40): p for p in PROMPTS[:4]}
    outs = eng.run()
    assert eng.allocator.num_used == 0
    for rid, p in rids.items():
        assert outs[rid] == oracle(model, p, 40)


def test_quantized_model_engine_matches_its_solo_oracle(models):
    """int8 weights and int8 KV through the engine, with a preemption,
    reproduce the QuantizedModel's own solo generate_paged."""
    _, _, tm = models
    qm = QuantizedModel(TextLM(tm.cfg, device="cpu", seed=0).eval(), min_size=1)
    long_a = [(7 * i) % 120 + 1 for i in range(122)]
    long_b = [(5 * i) % 120 + 1 for i in range(122)]
    eng = ServingEngine(qm, max_batch=2, max_context=256, total_pages=1 + 3,
                        kv_quant="int8", decode_block_steps=3)
    rids = {eng.submit(p, max_new_tokens=10): p for p in (long_a, long_b)}
    out = eng.run()
    assert eng.preemptions >= 1
    for rid, p in rids.items():
        assert out[rid] == oracle(qm, p, 10, kv_quant="int8")


# ---------------- the JAX engine and the port's, one stream ----------------


def request_stream():
    """Row 0 gets a system-prompt request, row 1 a long prompt that grows
    into a second page; the pool (4 pages) then runs dry and the first row
    is preempted.  Its continuation, and the third request, hit the cached
    system-prompt pages."""
    long_b = [(5 * i) % 120 + 1 for i in range(122)]
    return [
        (SYSTEM_PROMPT + [3, 1, 4], 12),
        (long_b, 14),
        (SYSTEM_PROMPT + [2, 7, 1, 8], 6),
        (PROMPTS[2], 5),
    ]


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_engine_tokens_equal_jax_engine(models, kv_quant):
    jm, params, tm = models
    kw = dict(max_batch=2, max_context=512, prefix_caching=True, total_pages=1 + 4,
              kv_quant=kv_quant)
    je, te = JServingEngine(jm, params, **kw), ServingEngine(tm, **kw)
    j_rids = [je.submit(p, max_new_tokens=n) for p, n in request_stream()]
    t_rids = [te.submit(p, max_new_tokens=n) for p, n in request_stream()]
    j_out, t_out = je.run(), te.run()
    assert te.preemptions == je.preemptions >= 1
    assert te.prefix_cache.hit_tokens == je.prefix_cache.hit_tokens > 0
    for jr, tr in zip(j_rids, t_rids):
        assert t_out[tr] == [int(x) for x in j_out[jr]], f"request {tr} differs"
    assert te.allocator.num_used == te.prefix_cache.num_cached


# ---------------- per-row sampling ----------------


def test_sample_logits_per_row_filters_equal_jax():
    """The deterministic part against vats_tpu: greedy rows (temperature 0
    or top_k 1) pick the argmax; a row whose filters leave one candidate
    (top_p tiny) picks it, whatever the draw."""
    logits = np.random.RandomState(3).randn(6, 50).astype(np.float32) * 3
    temp = np.array([0.0, 1.0, 0.7, 1.3, 0.0, 2.0], np.float32)
    topk = np.array([5, 1, 0, 8, 0, 3], np.int32)
    topp = np.array([0.0, 0.0, 1e-6, 1e-6, 0.5, 1e-6], np.float32)
    want = np.asarray(j_per_row(None, jnp.asarray(logits), temperature=jnp.asarray(temp),
                                top_k=jnp.asarray(topk), top_p=jnp.asarray(topp),
                                row_seeds=jnp.arange(6, dtype=jnp.uint32),
                                positions=jnp.arange(6), kmax=16))
    got = sample_logits_per_row(None, torch.from_numpy(logits),
                                temperature=torch.from_numpy(temp),
                                top_k=torch.from_numpy(topk), top_p=torch.from_numpy(topp),
                                row_seeds=torch.arange(6), positions=torch.arange(6),
                                kmax=16)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), logits.argmax(-1))


def test_sample_logits_per_row_distribution_and_keys():
    """Seeded draws follow softmax(top-p(top-k(logits / T))) restricted to
    the kmax subspace (frequencies over 20000 seeds, ~4 sigma), and a
    row's draw depends only on its (seed, position)."""
    from vats_tpu.inference.sampling import apply_top_k, apply_top_p

    logits = np.random.RandomState(4).randn(40).astype(np.float32) * 2.0
    k, p, t = 8, 0.9, 0.7
    target = np.asarray(jax.nn.softmax(apply_top_p(apply_top_k(
        jnp.asarray(logits[None]) / t, k), p), axis=-1))[0]
    n = 20000
    rows = torch.from_numpy(logits).expand(n, 40)
    draws = sample_logits_per_row(
        None, rows, temperature=torch.full((n,), t), top_k=torch.full((n,), k),
        top_p=torch.full((n,), p), row_seeds=torch.arange(n) * 7 + 3,
        positions=torch.full((n,), 11), kmax=16)
    freq = np.bincount(draws.numpy(), minlength=40) / n
    assert np.all(freq[target == 0] == 0)
    np.testing.assert_allclose(freq, target, atol=0.015)
    u = keyed_uniform(torch.tensor([9, 9, 10]), torch.tensor([4, 4, 4]), 5)
    assert torch.equal(u[0], u[1]) and not torch.equal(u[0], u[2])
    assert bool(((u > 0) & (u < 1)).all())
