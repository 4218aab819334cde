"""The kernels' work counts reproduce the bounds PERF.md's kernel table
gives (H100 SXM peaks)."""

import pytest

from benchmark import work


def test_k1_bound_at_b32():
    # the K1 row: B=32, lengths <= 576 (7199 settled tokens), nlp_medium's
    # decode shape (8 KV groups of 3 queries, hd 60, 5 pages a row).  The
    # table's 0.00449 ms counted K and V at a page's stored head dim (60
    # padded to 64); the benchmark counts the 60 the attention needs
    lengths = [640] * 11 + [159] + [0] * 20  # the count is what matters, not the split
    nbytes, flops = work.decode_attn_cost(lengths, kv_heads=8, q_per_kv=3, hd=60,
                                          pages_per_row=5)
    assert work.least_s(nbytes, flops) * 1e3 == pytest.approx(0.004218, abs=5e-7)
    assert nbytes / work.PEAK_BYTES_PER_S > flops / work.PEAK_BF16_FLOPS  # bound by bytes


def test_k2_bound_at_b8_t512():
    b, t, hq, g, hd = 8, 512, 24, 8, 60
    nbytes, flops = work.flash_fwd_cost(b, t, hq, g, hd, pairs=b * work.causal_pairs([t]))
    assert work.least_s(nbytes, flops) * 1e3 == pytest.approx(0.00939, abs=5e-6)


def test_causal_pairs_within_segments():
    assert work.causal_pairs([4]) == 10
    assert work.causal_pairs([2, 2]) == 6


def test_model_counts_of_the_configurations():
    import json
    import os

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name, params in (("vats_medium_e8", 4.187e9), ("vats_medium_moe", 0.749e9)):
        with open(os.path.join(here, "configs", f"{name}.json")) as f:
            m = json.load(f)["model"]
        dense, expert, embed = work.text_lm_params(m)
        total = dense + m["num_layers"] * m["num_experts"] * expert + embed
        assert total == pytest.approx(params, rel=2e-3)
