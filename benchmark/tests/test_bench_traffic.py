"""Each traffic mix gives the same requests or batches for a seed and other
ones for another seed, with the same multiset of sizes."""

import copy
import itertools
import json
import os

import numpy as np
import pytest

from benchmark import traffic as tr
from benchmark.tests import tiny

TRAFFIC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "traffic")
MIXES = sorted(f[:-5] for f in os.listdir(TRAFFIC) if f.endswith(".json"))
SEED = 2**31 + 12345


def _mix(name):
    with open(os.path.join(TRAFFIC, f"{name}.json")) as f:
        return json.load(f)


def _draw(mix, seed, n=3):
    if mix["kind"] in ("closed_loop", "open_loop"):
        t = tr.serve_traffic(mix, seed, vocab=65536)
        return [(r.prompt, r.max_new_tokens, r.greedy, r.due) for r in t.requests[:64]]
    return list(itertools.islice(tr.lm_batches(mix, seed, vocab=65536), n))


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    return a == b


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_traffic_other_seed_other(name):
    mix = _mix(name)
    a, b, c = _draw(mix, SEED), _draw(mix, SEED), _draw(mix, SEED + 1)
    assert all(_same(x, y) for x, y in zip(a, b))
    assert not all(_same(x, y) for x, y in zip(a, c))


@pytest.mark.parametrize("name", [n for n in MIXES if _mix(n)["kind"].endswith("loop")])
def test_every_seed_draws_the_same_sizes(name):
    mix = _mix(name)
    sizes = []
    for seed in (SEED, 7):
        t = tr.serve_traffic(mix, seed, vocab=65536)
        sizes.append(sorted((len(r.prompt) - (len(t.prefixes[0]) if r.prefix >= 0 else 0))
                            for r in t.requests))
    assert sizes[0] == sizes[1]
    p = mix["prompt"]
    assert p["min"] <= sizes[0][0] and sizes[0][-1] <= p["max"]


def test_packed_rows_are_full_and_labels_stay_in_segments():
    mix = _mix("train_packed_2k")
    batch = next(tr.lm_batches(mix, SEED, vocab=65536))
    ids, labels, segs = batch["input_ids"], batch["labels"], batch["segment_ids"]
    assert ids.shape == (mix["batch"], mix["seq_len"]) and batch["padding_mask"].all()
    same = segs[:, 1:] == segs[:, :-1]
    assert (labels[:, :-1][same] == ids[:, 1:][same]).all()
    assert (labels[:, :-1][~same] == tr.IGNORE_INDEX).all() and (labels[:, -1] == -100).all()


@pytest.mark.parametrize("name", [n for n in MIXES if _mix(n)["kind"].endswith("loop")])
def test_every_block_holds_the_same_sizes(name):
    mix = _mix(name)
    t = tr.serve_traffic(mix, SEED, vocab=65536)
    k = mix.get("block", mix.get("clients"))
    outs = [r.max_new_tokens for r in t.requests]
    blocks = [sorted(outs[i:i + k]) for i in range(k, len(outs), k)]  # the first round staggers
    assert all(b == blocks[0] for b in blocks)


def _open_loop(rate=11.2, pool=8192):
    mix = copy.deepcopy(tiny.SERVE_MIXES["open_loop"])
    mix.update(rate=rate, pool=pool, block=64)
    return mix


def test_open_loop_arrivals_are_poisson_at_the_rate():
    mix = _open_loop()
    due = np.array([r.due for r in tr.serve_traffic(mix, SEED, vocab=512).requests])
    gaps = np.diff(due)
    assert (gaps > 0).all()
    assert abs(len(due) / due[-1] - mix["rate"]) / mix["rate"] < 0.05
    assert 0.95 < gaps.std() / gaps.mean() < 1.05  # exponential gaps: CV 1
    counts = np.bincount(due.astype(int))[:-1]  # arrivals a second: Poisson, variance = mean
    assert 0.8 < counts.var() / counts.mean() < 1.2


def test_open_loop_arrivals_differ_between_seeds():
    mix = _open_loop()
    a = [r.due for r in tr.serve_traffic(mix, SEED, vocab=512).requests]
    b = [r.due for r in tr.serve_traffic(mix, SEED, vocab=512).requests]
    c = [r.due for r in tr.serve_traffic(mix, 99, vocab=512).requests]
    assert a == b and a != c


@pytest.mark.parametrize("name", [n for n in MIXES if _mix(n)["kind"].endswith("loop")])
def test_draw_seeds_come_from_the_run_seed(name):
    mix = _mix(name)
    a, b, c = (tr.serve_traffic(mix, s, vocab=65536).requests for s in (SEED, SEED, SEED + 1))
    seeds = [r.draw_seed for r in a]
    assert seeds == [r.draw_seed for r in b] and seeds != [r.draw_seed for r in c]
    assert all(0 <= x < 1 << 32 for x in seeds) and len(set(seeds)) > len(seeds) // 2
