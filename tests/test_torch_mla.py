"""Multi-head latent attention in the port (``LatentModelArgs``, the
DeepSeek-V2-Lite configuration): MLA uncached, as a paged prefill and as an
absorbed decode over the latent pool (K9's plain version on the CPU);
shared experts, a leading dense layer and a router without renormalisation;
the engine's latent pool.

The port is held to the benchmark's plain reference
(``benchmark/reference/deepseek_v2.py``) at a tiny size in fp32: d_model 64,
4 heads, latent 32, rope 16, nope 16, v 16, 8 experts top-2 beside 1 shared,
layer 0 dense, 3 layers, YaRN over an original length of 32 and sequences
past it.  Tolerances: fp32 sums in another order move a logit by ~1e-6
(LOGIT_TOL); the absorbed decode reorders the products of q.k (through the
latent in place of the decompressed key), ~1e-6 in fp32 (ABSORB_TOL); a
reference left without the shared experts, the dense layer, YaRN or with
the router renormalised moves the logits by > 1e-2, so every comparison
here would catch each of them."""

import dataclasses

import pytest
import torch

from benchmark.reference.deepseek_v2 import DeepSeekV2Reference, make_params
from vats_tpu_torch.configs.nlp import (
    HybridModelArgs,
    LatentModelArgs,
    deepseek_v2_lite,
    layer_attention,
    mellum2_12b,
    nlp_medium,
)
from vats_tpu_torch.inference.serving import ServingEngine
from vats_tpu_torch.models.text_lm import TextLM
from vats_tpu_torch.nn import mla
from vats_tpu_torch.nn.mla import BLOCK, blocked_attention
from vats_tpu_torch.ops import mla_decode as md

torch.set_num_threads(1)

#: fp32 logits of port and reference: sums in another order
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
#: absorbed against decompressed attention in fp32: products reordered
ABSORB_TOL = dict(rtol=1e-5, atol=1e-5)
#: how far a served greedy token's logit may lie below the reference's best
#: (fp32; a near-tie decided by a last-bit difference costs ~1e-6)
GAP_TOL = 1e-4


def tiny(**kw) -> LatentModelArgs:
    base = dict(d_model=64, num_heads=4, kv_lora_rank=32, qk_rope_head_dim=16,
                qk_nope_head_dim=16, v_head_dim=16, d_ffn=32, dense_d_ffn=96, num_layers=3,
                num_experts=8, top_k=2, n_shared_experts=1, yarn_original_max_position=32,
                vocab_size=97, max_seq_len=512, dtype="float32", param_dtype="float32")
    base.update(kw)
    return deepseek_v2_lite(**base)


def _model_and_params(cfg, seed=123):
    m = dataclasses.asdict(cfg)
    p = make_params(m, seed, torch.float32, "cpu")
    model = TextLM(cfg, device="meta")
    model.load_state_dict(p, assign=True)
    return model.eval(), m, p


def _wrong_refs(m, p):
    """References that leave out one mechanism each."""
    return {"renormalised": DeepSeekV2Reference(dict(m, norm_topk_prob=True), p),
            "no shared experts": DeepSeekV2Reference(dict(m, n_shared_experts=0), p),
            "no YaRN": DeepSeekV2Reference(dict(m, yarn_factor=1.0), p),
            "scaled x2": DeepSeekV2Reference(dict(m, routed_scaling_factor=2.0), p)}


def test_softmax_scale_at_the_published_yarn_values():
    """192^-0.5 (0.1 x 0.707 x ln 40 + 1)^2 = 0.114721...; the cos/sin
    factor mscale / mscale_all_dim is 1."""
    cfg = deepseek_v2_lite()
    assert cfg.softmax_scale == pytest.approx(0.11472138679, abs=1e-10)
    assert cfg.rope_scale == 1.0 and cfg.latent_dim == 576 and cfg.query_groups == 16
    assert layer_attention(cfg, 5).span == "attn.mla"
    assert deepseek_v2_lite(yarn_mscale=1.0).rope_scale == pytest.approx(
        (0.1 * 1.0 * 3.6888794541 + 1) / (0.1 * 0.707 * 3.6888794541 + 1))


@pytest.mark.parametrize("bad,match", [
    (dict(qk_rope_head_dim=15), "even"),
    (dict(first_k_dense_replace=4), "first_k_dense_replace"),
    (dict(dense_d_ffn=0), "dense_d_ffn"),
    (dict(yarn_original_max_position=0), "YaRN"),
    (dict(routed_scaling_factor=16.0), "routed_scaling_factor"),
])
def test_latent_config_rejects(bad, match):
    with pytest.raises(ValueError, match=match):
        tiny(**bad)


def test_forward_logits_equal_the_reference():
    """Uncached forward (decompressed MLA, the dense layer, routed and
    shared experts) against the reference; each left-out mechanism moves
    the logits past the tolerance."""
    model, m, p = _model_and_params(tiny())
    ids = torch.randint(1, 97, (2, 70), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want, _, _ = model(ids)
    ref = DeepSeekV2Reference(m, p)
    wrong = _wrong_refs(m, p)
    for b in range(2):
        torch.testing.assert_close(ref.logits(ids[b]), want[b], **LOGIT_TOL)
        for name, r in wrong.items():
            assert float((r.logits(ids[b]) - want[b]).abs().max()) > 1e-2, name


def test_forward_with_and_without_renormalisation():
    """``norm_topk_prob`` True renormalises the top-k weights in the port as
    in the reference (the published rule, without, moves the logits), two
    leading dense layers in both."""
    model, m, p = _model_and_params(tiny(norm_topk_prob=True, first_k_dense_replace=2))
    assert hasattr(model.layers[1], "ffn_block") and not hasattr(model.layers[2], "ffn_block")
    ids = torch.randint(1, 97, (1, 40), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, _, _ = model(ids)
    torch.testing.assert_close(DeepSeekV2Reference(m, p).logits(ids[0]), want[0], **LOGIT_TOL)
    as_published = DeepSeekV2Reference(dict(m, norm_topk_prob=False), p)
    assert float((as_published.logits(ids[0]) - want[0]).abs().max()) > 1e-2


def _serve(model, prompts, new_tokens, **kw):
    eng = ServingEngine(model, max_batch=4, max_context=256, page_size=128, decode_block_steps=4,
                        prompt_buckets=(32, 64, 128, 256), **kw)
    rids = [eng.submit(pr, new_tokens) for pr in prompts]
    out = eng.run()
    return eng, [out[r] for r in rids]


def _gaps(ref, prompt, served):
    logits = ref.logits(torch.tensor(prompt + served[:-1]))[len(prompt) - 1:]
    return logits.max(-1).values - logits.gather(1, torch.tensor(served)[:, None])[:, 0]


def test_engine_prefill_then_decode_equal_the_reference():
    """Grouped prefills into the latent pool, then absorbed decode blocks
    (K9's plain version), past YaRN's original length: every served greedy
    token is the reference's best to GAP_TOL; references without the shared
    experts or YaRN are not."""
    model, m, p = _model_and_params(tiny())
    g = torch.Generator().manual_seed(1)
    prompts = [torch.randint(1, 97, (n,), generator=g).tolist() for n in (5, 20, 40, 150)]
    before = md.mla_decode_attention.plain.launches
    eng, served = _serve(model, prompts, 40)
    assert md.mla_decode_attention.plain.launches - before == 3 * eng.forwards["decode"]
    ref = DeepSeekV2Reference(m, p)
    for pr, out in zip(prompts, served):
        assert len(out) == 40
        assert float(_gaps(ref, pr, out).max()) < GAP_TOL
    wrong = _wrong_refs(m, p)
    for name in ("no shared experts", "no YaRN"):
        assert max(float(_gaps(wrong[name], pr, out).max())
                   for pr, out in zip(prompts, served)) > 1e-2, name


def test_engine_with_prefix_cache_and_preemption_keeps_the_tokens():
    """The allocator, preemption and the prefix cache run over the latent
    pool unchanged: shared prompt pages are hit, a pool too small for every
    row preempts, and the greedy tokens are an unconstrained engine's."""
    model, _, _ = _model_and_params(tiny())
    g = torch.Generator().manual_seed(4)
    system = torch.randint(1, 97, (130,), generator=g).tolist()
    prompts = [system + torch.randint(1, 97, (n,), generator=g).tolist() for n in (3, 9, 20)]
    _, want = _serve(model, prompts, 30)
    eng = ServingEngine(model, max_batch=4, max_context=256, decode_block_steps=4,
                        prompt_buckets=(32, 64, 128, 256), prefix_caching=True)
    first = eng.submit(prompts[0], 30)
    got = [eng.run()[first]]  # its prompt pages are cached for the others
    rids = [eng.submit(pr, 30) for pr in prompts[1:]]
    out = eng.run()
    assert got + [out[r] for r in rids] == want and eng.prefix_cache.hit_tokens == 2 * 128
    prompts = [torch.randint(1, 97, (n,), generator=g).tolist() for n in (90, 100, 110)]
    _, want = _serve(model, prompts, 60)
    eng, got = _serve(model, prompts, 60, total_pages=5)
    assert got == want and eng.preemptions > 0


def test_latent_kv_bytes_in_use():
    """A latent pool holds (r + rope) elements a token a layer: 48 fp32 = 192
    bytes at the tiny size, over 3 layers; at the published widths in bf16,
    31,104 bytes a token."""
    model, _, _ = _model_and_params(tiny())
    eng = ServingEngine(model, max_batch=4, max_context=256, page_size=128,
                        prompt_buckets=(32, 64))
    assert tuple(eng.pool.shape) == (3, 4 * 2 + 1, 128, 48)
    for n in (5, 30, 60):
        eng.submit(list(range(1, n + 1)), 20)
    eng.step()
    assert eng.kv_bytes_in_use() == 3 * 128 * 3 * 48 * 4
    assert eng.kv_window_dead_bytes() == 0
    with pytest.raises(ValueError, match="latent pool"):
        ServingEngine(model, max_batch=2, max_context=256, kv_quant="int8")
    cfg = deepseek_v2_lite()
    assert cfg.num_layers * cfg.latent_dim * 2 == 31104


def _mla_layer(seed=5):
    model, m, p = _model_and_params(tiny(), seed)
    return model.layers[1].attn_block.attn


def test_absorbed_decode_equals_decompressed_attention():
    """One layer's decode token through the latent pool, absorbed (W_UK
    folded into q, K9's plain version over the latents, W_UV after), equals
    the decompressed attention of the same token over the same history."""
    attn = _mla_layer()
    g = torch.Generator().manual_seed(6)
    b, hist = 3, [0, 37, 130]
    x_hist = torch.randn(b, 130, 64, generator=g)
    x_tok = torch.randn(b, 1, 64, generator=g)
    pool = md.LatentPagedCache.create_pool(1, 7, 128, 48, dtype=torch.float32)
    table = torch.tensor([[1, 2], [3, 4], [5, 6]], dtype=torch.int32)
    lengths = torch.zeros(b, dtype=torch.int32)
    cache = md.LatentPagedCache(pool, table, lengths)
    mask = torch.arange(130)[None, :] < torch.tensor(hist)[:, None]
    with torch.no_grad():
        attn(x_hist, paged_cache=cache, padding_mask=mask, layer_idx=0)
        cache.advance_by(torch.tensor(hist))
        got, _ = attn(x_tok, paged_cache=cache, layer_idx=0)
        for r in range(b):
            n = hist[r]
            seq = torch.cat([x_hist[r:r + 1, :n], x_tok[r:r + 1]], dim=1)
            want, _ = attn(seq)
            torch.testing.assert_close(got[r, 0], want[0, -1], **ABSORB_TOL)


def test_paged_prefill_equals_the_uncached_forward():
    """A prefill into the latent pool (appended, then attending its own
    window when the cache is fresh, or its pages gathered through the table
    and decompressed) gives the uncached forward's outputs at its valid
    positions; more than BLOCK queries and keys combine through the LSE."""
    attn = _mla_layer()
    g = torch.Generator().manual_seed(7)
    t = BLOCK + 200
    x = torch.randn(2, t, 64, generator=g) * 0.5
    mask = torch.arange(t)[None, :] < torch.tensor([[t], [300]])
    pages = -(-t // 128)
    with torch.no_grad():
        want, _ = attn(x, padding_mask=mask)
        for fresh in (True, False):
            pool = md.LatentPagedCache.create_pool(1, 2 * pages + 1, 128, 48,
                                                   dtype=torch.float32)
            table = (1 + torch.arange(2 * pages, dtype=torch.int32)).reshape(2, pages)
            cache = md.LatentPagedCache(pool, table, torch.zeros(2, dtype=torch.int32),
                                        fresh=fresh)
            got, _ = attn(x, paged_cache=cache, padding_mask=mask, layer_idx=0)
            torch.testing.assert_close(got[0], want[0], **ABSORB_TOL)
            torch.testing.assert_close(got[1, :300], want[1, :300], **ABSORB_TOL)
            # the window's latent vectors are in the pool either way
            assert bool((pool[0, 1:1 + pages].reshape(-1, 48)[:t] != 0).any(-1).all())


@pytest.mark.parametrize("own", [True, False])
@pytest.mark.parametrize("passes", ["one", "several"])
def test_blocked_attention_equals_one_softmax(own, passes, monkeypatch):
    """Query blocks, their keys in one pass or in several combined through
    the LSE (scores capped at one block of keys), give one causal softmax's
    attention: over a forward's own tokens (a query block reads the keys up
    to its end) and at given positions (a window after history), with key
    padding."""
    if passes == "several":
        monkeypatch.setattr(mla, "SCORES", 1)
    g = torch.Generator().manual_seed(8)
    s = 2 * BLOCK + 5
    t = s if own else 9
    q, k, v = (torch.randn(1, t, 2, 12, generator=g), torch.randn(1, s, 2, 12, generator=g),
               torch.randn(1, s, 2, 7, generator=g))
    valid = torch.arange(s)[None, :] != 3
    kw = dict(q_pos=torch.tensor([[0, 1, 500, 1023, 1024, 1025, 2000, 2048, 2052]]),
              k_pos=torch.arange(s)) if not own else {}
    q_pos = kw.get("q_pos", torch.arange(t)[None, :])
    got = blocked_attention(q, k, v, scale=0.3, k_valid=valid, **kw)
    sc = torch.einsum("bthd,bshd->bhts", q, k) * 0.3
    see = (torch.arange(s)[None, None, None] <= q_pos[:, None, :, None]) & valid[:, None, None]
    want = torch.einsum("bhts,bshd->bthd", torch.softmax(torch.where(see, sc, -torch.inf), -1),
                        v)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_k9_plain_version_equals_naive_latent_attention():
    """K9's plain version over a shuffled page table, rows of 0 to 3 pages,
    a bf16 pool too: softmax over each row's first n latent vectors, values
    their first v_dim elements (p rounded to bf16 for a bf16 pool)."""
    g = torch.Generator().manual_seed(9)
    b, h, w, v_dim, ps, pps = 4, 16, 40, 32, 128, 3
    pages = torch.randn(b * pps + 1, ps, w, generator=g)
    table = (1 + torch.randperm(b * pps, generator=g)).to(torch.int32).reshape(b, pps)
    lengths = torch.tensor([0, 1, 200, 384], dtype=torch.int32)
    q = torch.randn(b, h, w, generator=g)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        pg, qd = pages.to(dtype), q.to(dtype)
        got = md.mla_decode_attention_ref(qd, pg, table, lengths, scale=0.2, v_dim=v_dim)
        seq = pg[table.long()].reshape(b, pps * ps, w).float()
        for r in range(b):
            n = int(lengths[r])
            if n == 0:
                assert torch.equal(got[r], torch.zeros_like(got[r]))
                continue
            probs = torch.softmax(qd[r].float() @ seq[r, :n].T * 0.2, dim=-1)
            want = probs @ seq[r, :n, :v_dim]
            torch.testing.assert_close(got[r].float(), want, rtol=tol, atol=tol)
    out = md.mla_decode_attention(q, pages[None], 0, table, lengths, scale=0.2, v_dim=v_dim)
    assert torch.equal(out, md.mla_decode_attention_ref(q, pages, table, lengths, scale=0.2,
                                                        v_dim=v_dim))
    assert md.chunk_tiles(96) == 6 and md.chunk_tiles(8) == md.MIN_CHUNK_TILES


def test_latent_append_keeps_the_last_writer():
    """Rows that write one slot (scratch rows on page 0) leave the last
    writer's value in (row, position) order; positions past the table land
    on the row's last slot."""
    pool = md.LatentPagedCache.create_pool(1, 3, 128, 4, dtype=torch.float32)
    table = torch.tensor([[0], [0], [2]], dtype=torch.int32)
    cache = md.LatentPagedCache(pool, table, torch.tensor([0, 0, 127], dtype=torch.int32))
    lat = torch.arange(3 * 2 * 4, dtype=torch.float32).reshape(3, 2, 4)
    cache.append_tokens(0, lat)
    assert torch.equal(pool[0, 0, 0], lat[1, 0]) and torch.equal(pool[0, 0, 1], lat[1, 1])
    assert torch.equal(pool[0, 2, 127], lat[2, 1])


def test_attention_and_shared_experts_run_under_their_spans():
    """Under a profiler each layer's attention is one ``vats.attn.mla``
    span, and each expert layer's shared experts one ``vats.moe.shared``;
    a decode opens ``vats.mla.decode`` once a layer."""
    from torch.profiler import ProfilerActivity, profile

    model, _, _ = _model_and_params(tiny())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            model(torch.ones(1, 10, dtype=torch.long))
    names = [e.name for e in prof.events()]
    assert names.count("vats.attn.mla") == 3 and names.count("vats.moe.shared") == 2
    eng = ServingEngine(model, max_batch=2, max_context=256, prompt_buckets=(32,))
    eng.submit([1, 2, 3], 3)
    eng.step()  # the prefill and a first decode block
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.step()
    names = [e.name for e in prof.events()]
    assert names.count("vats.mla.decode") == names.count("vats.attn.mla") > 0


def test_defaults_leave_the_uniform_and_hybrid_models_as_they_were():
    """The router's new option defaults to the old rule (weights
    renormalised, bit for bit), and a ``ModelArgs`` (the
    vats_medium_e8 shape) or ``HybridModelArgs`` (the Mellum2 shape) model
    gets no shared experts, no dense layer and no new parameter: its state
    dict is the one the benchmark's weights name."""
    from benchmark.reference import mellum
    from benchmark.weights import param_specs

    e8 = nlp_medium(d_model=64, num_heads=4, query_groups=2, d_ffn=32, num_layers=2,
                    num_experts=8, top_k=2, vocab_size=97, dropout=0.0, capacity_factor=-1.0)
    hy = mellum2_12b(d_model=64, num_heads=4, query_groups=2, head_dim=24, d_ffn=32,
                     num_layers=4, num_experts=8, top_k=4, left_window=7,
                     layer_types=mellum2_12b().layer_types[:4], yarn_original_max_position=32,
                     vocab_size=97, max_seq_len=256, dtype="float32", param_dtype="float32")
    assert isinstance(hy, HybridModelArgs) and not isinstance(hy, LatentModelArgs)
    for cfg, specs in ((e8, param_specs), (hy, mellum.param_specs)):
        model = TextLM(cfg, device="cpu", seed=0).eval()
        want = {name: shape for name, shape, _, _ in specs(dataclasses.asdict(cfg))}
        assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
        for layer in model.layers:
            moe = layer.moe_block.moe
            assert moe.shared is None and not hasattr(layer, "ffn_block")
            router = moe.router
            assert router.norm_topk_prob
            x = torch.randn(20, cfg.d_model, generator=torch.Generator().manual_seed(3))
            weights, idx, _ = router(x)
            probs = torch.softmax(torch.nn.functional.linear(
                x.float(), router.router.weight.float(), router.router.bias.float()), -1)
            top = torch.gather(probs, 1, idx)
            assert torch.equal(weights.float(), (top / top.sum(-1, keepdim=True)).to(
                weights.dtype).float())
