"""The metric readers' arithmetic on synthetic records: the union of
intervals behind busy and idle, the roofline and utilisation shares, and
the due-time time to first token with requests still waiting."""

import math
import os

import numpy as np
import pytest

from benchmark import harness
from benchmark.drivers import serve

METRICS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "metrics")


def test_busy_is_the_union_of_intervals_clipped_to_the_window():
    ops = [("a", 0.0, 2.0), ("b", 1.0, 2.0), ("c", 5.0, 1.0), ("d", 9.5, 2.0)]
    host = [("engine.step", 2.5, 4.9), ("feed", 3.0, 3.5)]
    r = harness.reduce_trace(ops, (0.5, 10.0), host)
    assert r["busy_s"] == pytest.approx(2.5 + 1.0 + 0.5)
    assert r["window_s"] == pytest.approx(9.5)
    assert r["by_name"]["a"] == pytest.approx(1.5)
    gaps = r["breakdown"]["idle_gaps"]
    assert gaps[0] == ["untraced host", pytest.approx(3.5)]  # 6.0 .. 9.5
    assert gaps[1] == ["engine.step", pytest.approx(2.0)]  # 3.0 .. 5.0, middle at 4.0
    assert [n for n, _ in r["breakdown"]["device_ops"]] == ["b", "a", "c", "d"]
    assert harness.idle_percent({"trace": r}) == pytest.approx(100 * (1 - 4.0 / 9.5))


def _trace(**counters):
    return {"busy_s": 2.0, "window_s": 4.0, "counters": counters,
            "by_name": {"void paged_decode_kernel<bf16>": 0.5, "flash_fwd_wgmma_kernel<64>": 0.3,
                        "flash_bwd_dq_wgmma_kernel": 0.2, "nvjet": 1.0}}


@pytest.mark.parametrize("name,record,want", [
    ("batch_occupancy.decode", {"counters": {"decode_forwards": 4, "decode_rows": 250}}, 62.5),
    ("prefix_hit_share", {"counters": {"prefix_query_tokens": 1000, "prefix_hit_tokens": 800}}, 80.0),
    ("device_ms_per_token.decode", {"trace": _trace(output_tokens=1000)}, 2.0),
    ("device_ms_per_ktok.train", {"trace": _trace(tokens=4000)}, 500.0),
    ("decode_attn_roofline", {"trace": _trace(decode_attn_least_s=0.1)}, 20.0),
    ("flash_train_roofline", {"trace": _trace(flash_least_s=0.05)}, 10.0),
    ("mfu.decode", {"trace": _trace(forward_least_s=1.0)}, 25.0),
    ("mfu.train", {"trace": _trace(model_flops=989e12)}, 25.0),
    ("idle_share.decode", {"trace": _trace()}, 50.0),
    ("idle_share.prefill", {"trace": _trace()}, 50.0),
    ("idle_share.train", {"trace": _trace()}, 50.0),
])
def test_readers(name, record, want):
    assert harness.load_reader(name)(record) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(f[:-3] for f in os.listdir(METRICS) if f.endswith(".py")))
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    empty = {"counters": {}, "trace": None}
    assert harness.load_reader(name)(empty) is None


def _drive(kind, sent, first, last, count, done):
    d = serve.Drive.__new__(serve.Drive)
    d.t = type("T", (), {"kind": kind})()
    d.sent, d.first, d.last = (np.array(x, float) for x in (sent, first, last))
    d.count, d.done = np.array(count), np.array(done)
    return d


def test_ttft_runs_from_the_due_time_and_counts_waiting_requests():
    nan = math.nan
    # due at 1, 2, 3 (in the window 0..10), 11 (after); the third never gets a token
    d = _drive("open_loop", [1, 2, 3, 11], [1.5, 4.0, nan, nan], [3.0, 6.0, nan, nan],
               [5, 2, 0, 0], [True, True, False, False])
    e = serve.serve_e2e(d, 0.0, 10.0)
    assert e["_attempted"] == 3
    assert e["_ttft_n"] == 3
    assert e["ttft_p95_s"] == pytest.approx(harness.percentile([0.5, 2.0, 7.0], 95))
    assert e["tpot_p95_ms"] == pytest.approx(harness.percentile([375.0, 2000.0], 95))


def test_percentile_interpolates():
    assert harness.percentile([1, 2, 3, 4, 5], 50) == 3
    assert harness.percentile(list(range(101)), 95) == 95
    assert harness.percentile([], 95) is None


def test_checks_fail_on_a_missing_or_non_finite_number():
    assert harness.within({"a": {"value": 0.1, "limit": 0.2}})
    for bad in (0.3, None, math.nan, math.inf):
        assert not harness.within({"a": {"value": bad, "limit": 0.2}})
