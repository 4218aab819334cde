"""Per-layer attention kinds in the port (``HybridModelArgs``, the
Mellum2-12B-A2.5B configuration): sliding-window and full layers, a head
dim of its own, YaRN on the full layers; K1's window (its plain version on
the CPU), the engine's prefill budget and its windowed K/V counter.

The port is held to the benchmark's plain reference
(``benchmark/reference/mellum.py``) at a tiny size in fp32: head dim 24
over d_model 64 / 4 heads, the pattern [window, window, window, full] x 2
with a window of 8 tokens (``left_window`` 7), 8 experts top-4, YaRN over
an original length of 32, sequences past both.  Tolerances: fp32 sums in
another order move a logit by ~1e-6; the reference left without the window
or without YaRN moves them by > 1e-2, so every comparison here would catch
either."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from benchmark.reference.mellum import MellumReference, make_params
from vats_tpu_torch.configs.nlp import (
    FULL,
    SLIDING,
    HybridModelArgs,
    layer_attention,
    mellum2_12b,
    nlp_xsmall,
)
from vats_tpu_torch.inference.serving import ServingEngine
from vats_tpu_torch.models.text_lm import TextLM
from vats_tpu_torch.nn.rope import rope_inv_freq, yarn_inv_freq
from vats_tpu_torch.ops import decode_attention as da

torch.set_num_threads(1)

PATTERN = (SLIDING, SLIDING, SLIDING, FULL) * 2
#: fp32 logits of port and reference: sums in another order
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
#: how far a served greedy token's logit may lie below the reference's best
#: (fp32; a near-tie decided by a last-bit difference costs ~1e-6)
GAP_TOL = 1e-4


def tiny(**kw) -> HybridModelArgs:
    base = dict(d_model=64, num_heads=4, query_groups=2, head_dim=24, d_ffn=32, num_layers=8,
                num_experts=8, top_k=4, layer_types=PATTERN, left_window=7,
                yarn_original_max_position=32, vocab_size=97, max_seq_len=256,
                dtype="float32", param_dtype="float32")
    base.update(kw)
    return mellum2_12b(**base)


def _model_and_params(cfg, seed=123):
    m = dataclasses.asdict(cfg)
    p = make_params(m, seed, torch.float32, "cpu")
    model = TextLM(cfg, device="meta")
    model.load_state_dict(p, assign=True)
    return model.eval(), m, p


def _refs(m, p):
    """The reference, and two that leave out the window or YaRN."""
    return (MellumReference(m, p), MellumReference(dict(m, layer_types=[FULL] * len(PATTERN)), p),
            MellumReference(dict(m, yarn_factor=1.0), p))


def test_yarn_table_matches_the_formula_at_published_values():
    """HF's _compute_yarn_parameters at Mellum2's values: low 18, high 35;
    pairs up to 18 keep theta's frequency, pairs from 35 take it over 16,
    a linear ramp between; the attention factor 0.1 ln 16 + 1."""
    hd, theta, factor, orig = 128, 500000.0, 16.0, 8192

    def d(rot):
        return hd * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(theta))

    low, high = math.floor(d(32.0)), math.ceil(d(1.0))
    assert (low, high) == (18, 35)
    i = np.arange(hd // 2, dtype=np.float64)
    extra = theta ** (-2 * i / hd)
    ramp = np.clip((i - low) / (high - low), 0, 1)
    want = extra / factor * ramp + extra * (1 - ramp)
    got = yarn_inv_freq(hd, theta, factor, orig, 32.0, 1.0).double().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    plain = rope_inv_freq(hd, theta).double().numpy()
    np.testing.assert_allclose(got[:low + 1], plain[:low + 1], rtol=1e-6)
    np.testing.assert_allclose(got[high:], plain[high:] / factor, rtol=1e-6)
    cfg = mellum2_12b()
    assert cfg.yarn_attention_factor == pytest.approx(0.1 * math.log(16) + 1)
    assert cfg.head_dim == 128 and cfg.d_model // cfg.num_heads == 72
    assert cfg.softmax_scale == pytest.approx(128 ** -0.5)


def test_layer_kinds_of_the_published_pattern_and_of_a_plain_config():
    cfg = mellum2_12b()
    kinds = [layer_attention(cfg, i) for i in range(cfg.num_layers)]
    assert [i for i, k in enumerate(kinds) if k.span == "attn.full"] == list(range(3, 28, 4))
    assert {(k.left_window, k.decode_window, k.rope) for k in kinds} == {
        (1023, 1023, "1d"), (-1, -1, "yarn")}
    # a plain ModelArgs windows its prefill but not its paged decode, as the
    # JAX package's does
    plain = layer_attention(nlp_xsmall(), 0)
    assert (plain.left_window, plain.decode_window, plain.rope) == (128, -1, "1d")


@pytest.mark.parametrize("bad,match", [
    (dict(layer_types=PATTERN[:7]), "layer_types has 7"),
    (dict(layer_types=("linear",) * 8), "unknown layer types"),
    (dict(left_window=-1), "sliding layers need"),
    (dict(head_dim=25), "must be even"),
    (dict(yarn_original_max_position=0), "YaRN needs"),
])
def test_hybrid_config_rejects(bad, match):
    with pytest.raises(ValueError, match=match):
        tiny(**bad)


def test_forward_logits_equal_the_reference():
    model, m, p = _model_and_params(tiny())
    ids = torch.randint(1, 97, (2, 70), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want, _, _ = model(ids)
    ref, no_window, no_yarn = _refs(m, p)
    for b in range(2):
        got = ref.logits(ids[b])
        torch.testing.assert_close(got, want[b], **LOGIT_TOL)
        for wrong in (no_window, no_yarn):
            assert float((wrong.logits(ids[b]) - want[b]).abs().max()) > 1e-2


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
    """Grouped prefills, then decode blocks through the paged cache (K3's
    table mode for the full layers' YaRN, K1's window for the sliding ones,
    on the CPU their plain versions), past the window and past YaRN's
    original length: every served greedy token is the reference's best to
    GAP_TOL; the reference without the window or without YaRN is not."""
    model, m, p = _model_and_params(tiny())
    g = torch.Generator().manual_seed(1)
    prompts = [torch.randint(1, 97, (n,), generator=g).tolist() for n in (5, 20, 40, 150)]
    _, served = _serve(model, prompts, 40)
    ref, no_window, no_yarn = _refs(m, p)
    for pr, out in zip(prompts, served):
        assert len(out) == 40
        assert float(_gaps(ref, pr, out).max()) < GAP_TOL
    for wrong in (no_window, no_yarn):
        assert max(float(_gaps(wrong, pr, out).max()) for pr, out in zip(prompts, served)) > 1e-2


def test_prefill_budget_bounds_every_group_and_keeps_the_tokens():
    """With max_prefill_tokens 64 no prefill forward takes more padded
    tokens (a 128 bucket, above it, takes one row); the tokens equal an
    unbudgeted engine's."""
    model, _, _ = _model_and_params(tiny())
    g = torch.Generator().manual_seed(2)
    prompts = [torch.randint(1, 97, (n,), generator=g).tolist()
               for n in (3, 9, 12, 30, 31, 17, 100, 90)]
    free, want = _serve(model, prompts, 6)
    budget, got = _serve(model, prompts, 6, max_prefill_tokens=64)
    assert got == want
    assert max(r * b for b, r in free.prefill_shapes) > 64
    assert all(r * b <= 64 or r == 1 for b, r in budget.prefill_shapes)
    assert {b: budget.max_prefill_rows(b) for b in (32, 64, 128)} == {32: 2, 64: 1, 128: 1}
    assert free.max_prefill_rows(32) == ServingEngine.MAX_PREFILL_GROUP
    with pytest.raises(ValueError, match="max_prefill_tokens"):
        ServingEngine(model, max_batch=4, max_context=256, max_prefill_tokens=0)


def test_kv_window_dead_bytes_counts_the_positions_behind_each_window():
    """Each active row at length L holds L - 7 positions of each of the 6
    sliding layers that its decode no longer attends; the full layers hold
    none.  K/V of a token in one layer: 2 x 2 groups x 24 (padded to 24) x
    4 bytes."""
    model, _, _ = _model_and_params(tiny())
    eng = ServingEngine(model, max_batch=4, max_context=256, page_size=128,
                        prompt_buckets=(32, 64))
    for n in (5, 30, 60):
        eng.submit(list(range(1, n + 1)), 20)
    eng.step()  # admits all three, one decode block of one step
    per = 2 * 2 * 24 * 4
    lengths = [int(eng.lengths[r]) for r in range(3)]
    assert lengths == [6, 31, 61]
    assert eng.kv_window_dead_bytes() == sum(6 * max(0, n - 7) for n in lengths) * per
    assert eng.kv_bytes_in_use() == 3 * 128 * 8 * per
    plain = ServingEngine(TextLM(nlp_xsmall(num_layers=2, max_seq_len=256), device="cpu"),
                          max_batch=2, max_context=256)
    plain.submit(list(range(1, 200)), 4)
    plain.step()
    assert plain.kv_window_dead_bytes() == 0  # its paged decode attends every token


def test_windowed_paged_decode_plain_version_equals_dense_masked_attention():
    """K1's plain version with a left window: the softmax over keys at
    positions [L - lw, L) and the current token, taken densely."""
    gen = torch.Generator().manual_seed(3)
    b, g, n, hd, ps, pps, lw = 5, 2, 3, 24, 128, 3, 100
    lengths = torch.tensor([0, 50, 101, 200, 383], dtype=torch.int32)
    pool = torch.randn(b * pps, 2, g, ps, hd, generator=gen)
    table = torch.randperm(b * pps, generator=gen).to(torch.int32).reshape(b, pps)
    q = torch.randn(b, g * n, hd, generator=gen)
    kc, vc = torch.randn(b, g, hd, generator=gen), torch.randn(b, g, hd, generator=gen)
    got = da.paged_decode_attention_ref(q, pool, table, lengths, scale=0.3, k_cur=kc, v_cur=vc,
                                        left_window=lw)
    seq = pool[table.long()].permute(0, 2, 3, 1, 4, 5).reshape(b, 2, g, pps * ps, hd)
    for r in range(b):
        length = int(lengths[r])
        lo = max(0, length - lw)
        k = torch.cat([seq[r, 0, :, lo:length], kc[r, :, None]], dim=1)  # [G, keys, hd]
        v = torch.cat([seq[r, 1, :, lo:length], vc[r, :, None]], dim=1)
        qr = q[r].reshape(g, n, hd)
        want = torch.softmax(qr @ k.transpose(1, 2) * 0.3, dim=-1) @ v
        torch.testing.assert_close(got[r], want.reshape(g * n, hd), rtol=1e-5, atol=1e-5)
    full = da.paged_decode_attention_ref(q, pool, table, lengths, scale=0.3, k_cur=kc, v_cur=vc)
    assert torch.equal(got[:2], full[:2])  # inside the window: the same
    assert float((got[3:] - full[3:]).abs().max()) > 1e-2


def test_int8_kv_refuses_a_windowed_layer():
    """K4 has no window: a windowed layer over an int8 pool raises, in the
    wrapper and at the engine's first decode, rather than attend every
    token."""
    pool = torch.zeros(1, 4, 2, 2, 128, 32, dtype=torch.int8)
    scales = torch.ones(1, 4, 2, 2, 128)
    args = (torch.zeros(1, 4, 24), pool, 0, torch.zeros(1, 4, dtype=torch.int32),
            torch.tensor([5], dtype=torch.int32))
    kw = dict(scale=1.0, k_cur=torch.zeros(1, 2, 24), v_cur=torch.zeros(1, 2, 24),
              kv_scales=scales)
    with pytest.raises(NotImplementedError, match="no sliding window"):
        da.paged_decode_attention_commit(*args, left_window=7, **kw)
    with pytest.raises(NotImplementedError, match="no sliding window"):
        da.paged_decode_attention(*args, left_window=7, **kw)
    da.paged_decode_attention_commit(*args, **kw)  # no window: K4 as before
    model, _, _ = _model_and_params(tiny())
    eng = ServingEngine(model, max_batch=2, max_context=256, kv_quant="int8",
                        prompt_buckets=(32,))
    eng.submit([1, 2, 3], 4)
    with pytest.raises(NotImplementedError, match="no sliding window"):
        eng.run()


def test_attention_runs_under_its_kinds_span():
    """Under a profiler each layer's attention is one ``vats.attn.window``
    or ``vats.attn.full`` span, six and two a forward."""
    from torch.profiler import ProfilerActivity, profile

    model, _, _ = _model_and_params(tiny())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            model(torch.ones(1, 10, dtype=torch.long))
    names = [e.name for e in prof.events()]
    assert names.count("vats.attn.window") == 6 and names.count("vats.attn.full") == 2
