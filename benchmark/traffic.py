"""The one generator of the benchmark's traffic, driven by the mix files in
``benchmark/traffic/<mix>.json``.

A mix names its ``kind``; each kind is a function below that reads only the
mix's parameters and the run's seed, with numpy alone.  Every seed does the
same work: requests come in blocks of ``block`` (a closed loop's round of
one request a client), and every block holds the same sizes (quantiles of
the stated distributions), in an order of the seed's.  An open loop's
arrival gaps are drawn independently from Exp(rate) with a stream of the
seed: Poisson arrivals, whose bursts differ from seed to seed as they do
in the traffic a server sees.  Every sampled request carries a draw seed
of the run's seed, which keys the program's draws by (seed, position).

Kinds:
  * ``closed_loop``: ``clients`` callers, each sending its next request as
    soon as the previous one retires (serving);
  * ``open_loop``: Poisson arrivals at ``rate`` requests a second, each
    prompt one of ``prefixes.count`` shared system prompts (Zipf) followed
    by its own turn (serving);
  * ``lm_packed``: documents concatenated and cut into full rows of
    ``seq_len`` tokens, with ``segment_ids`` (training);
  * ``lm_rows``: one full unpacked row of ``seq_len`` tokens a sample
    (training).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from statistics import NormalDist
from typing import Dict, Iterator, List, Optional

import numpy as np

IGNORE_INDEX = -100
SEED_MOD = 1 << 63


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy stream of (seed, stream)."""
    return np.random.default_rng([int(seed) % SEED_MOD, stream])


def quantile_sizes(spec: dict, n: int) -> np.ndarray:
    """``n`` sizes at the mid-quantiles of a log-normal (``median``,
    ``sigma``) clipped to [``min``, ``max``], rounded to whole tokens."""
    if spec.get("dist", "lognormal") != "lognormal":
        raise ValueError(f"unknown size distribution {spec.get('dist')!r}")
    nd = NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    sizes = np.exp(math.log(spec["median"]) + spec["sigma"] * z)
    return np.clip(np.rint(sizes), spec["min"], spec["max"]).astype(np.int64)


def zipf_counts(count: int, s: float, n: int) -> np.ndarray:
    """How many of ``n`` draws go to each of ``count`` items under
    Zipf(s), by largest remainders (the multiset every seed shares)."""
    p = 1.0 / np.arange(1, count + 1) ** s
    p /= p.sum()
    raw = p * n
    out = np.floor(raw).astype(np.int64)
    out[np.argsort(-(raw - out), kind="stable")[: n - out.sum()]] += 1
    return out


# ---------------------------------------------------------------- serving


@dataclass
class ServeRequest:
    """One request of a serving mix: ``due`` is its send time in seconds
    from the start of the drive (open loop; None in a closed loop, where it
    is sent when its client's previous one retires); ``draw_seed`` keys a
    sampled request's draws."""

    index: int
    prompt: List[int]
    max_new_tokens: int
    greedy: bool
    client: int = 0
    due: Optional[float] = None
    prefix: int = -1
    draw_seed: int = 0


@dataclass
class ServeTraffic:
    kind: str
    requests: List[ServeRequest]
    sampling: Dict[str, float]
    clients: int = 0
    prefixes: List[List[int]] = field(default_factory=list)
    #: for a closed loop: each client's requests in order
    per_client: List[List[int]] = field(default_factory=list)


def _tokens(rng: np.random.Generator, n: int, vocab: int) -> List[int]:
    return rng.integers(1, vocab, size=n).tolist()


def blocked(base: np.ndarray, blocks: int, rng: np.random.Generator) -> np.ndarray:
    """``blocks`` copies of ``base``, each in an order drawn from ``rng``."""
    return np.concatenate([rng.permutation(base) for _ in range(blocks)])


def serve_traffic(mix: dict, seed: int, vocab: int, rate: Optional[float] = None) -> ServeTraffic:
    """The requests of a serving mix for ``seed`` (``rate`` overrides an
    open loop's rate, for the capacity sweep)."""
    kind = mix["kind"]
    k = int(mix["clients"]) if kind == "closed_loop" else int(mix["block"])
    blocks = int(mix["pool"]) // k
    pool = blocks * k
    order = rng_for(seed, 0)
    prompts = blocked(quantile_sizes(mix["prompt"], k), blocks, order)
    outputs = blocked(quantile_sizes(mix["output"], k), blocks, order)
    greedy_every = int(mix["greedy_every"])
    toks = rng_for(seed, 1)
    draw_seeds = rng_for(seed, 5).integers(0, 1 << 32, size=pool).tolist()
    sampling = dict(mix["sampling"])
    if kind == "closed_loop":
        clients = int(mix["clients"])
        reqs, per_client = [], [[] for _ in range(clients)]
        for i in range(pool):
            c = i % clients
            out = int(outputs[i])
            if i < clients:  # the first round is staggered, as if joined mid-answer
                out = max(1, out * (i + 1) // clients)
            reqs.append(ServeRequest(i, _tokens(toks, int(prompts[i]), vocab), out,
                                     greedy=i % greedy_every == greedy_every - 1, client=c,
                                     draw_seed=draw_seeds[i]))
            per_client[c].append(i)
        return ServeTraffic(kind, reqs, sampling, clients=clients, per_client=per_client)
    if kind == "open_loop":
        pre = mix["prefixes"]
        prefixes = [_tokens(toks, int(pre["length"]), vocab) for _ in range(int(pre["count"]))]
        count = int(pre["count"])
        which = blocked(np.repeat(np.arange(count), zipf_counts(count, float(pre["zipf_s"]), k)),
                        blocks, order)
        gaps = rng_for(seed, 4).exponential(1.0 / float(rate or mix["rate"]), pool)
        due = np.cumsum(gaps) - gaps[0]
        reqs = []
        for i in range(pool):
            p = int(which[i])
            reqs.append(ServeRequest(i, prefixes[p] + _tokens(toks, int(prompts[i]), vocab),
                                     int(outputs[i]), greedy=i % greedy_every == greedy_every - 1,
                                     due=float(due[i]), prefix=p, draw_seed=draw_seeds[i]))
        return ServeTraffic(kind, reqs, sampling, prefixes=prefixes)
    raise ValueError(f"unknown serving traffic kind {kind!r}")


# ---------------------------------------------------------------- training


def lm_batches(mix: dict, seed: int, vocab: int) -> Iterator[Dict[str, np.ndarray]]:
    """Endless numpy micro-batches of a training mix for ``seed``:
    ``input_ids``, ``labels`` (the next token, -100 where a segment or the
    row ends), ``padding_mask`` (all valid: rows are full) and, packed,
    ``segment_ids`` (1, 2, ... along a row)."""
    kind = mix["kind"]
    b, t = int(mix["batch"]), int(mix["seq_len"])
    toks = rng_for(seed, 1)
    if kind == "lm_rows":
        while True:
            ids = toks.integers(0, vocab, size=(b, t + 1), dtype=np.int64)
            labels = ids[:, 1:].copy()
            yield {"input_ids": ids[:, :t].astype(np.int32), "labels": labels.astype(np.int32),
                   "padding_mask": np.ones((b, t), bool)}
    if kind != "lm_packed":
        raise ValueError(f"unknown training traffic kind {kind!r}")
    docs = quantile_sizes(mix["doc"], int(mix["pool"]))
    order = rng_for(seed, 0)
    lengths: List[int] = []
    while True:
        ids = toks.integers(0, vocab, size=(b, t), dtype=np.int64)
        segs = np.empty((b, t), np.int64)
        for r in range(b):
            pos, seg = 0, 1
            while pos < t:
                if not lengths:
                    lengths = order.permutation(docs).tolist()
                n = lengths.pop()
                take = min(n, t - pos)
                if take < n:  # the rest of the document opens the next row
                    lengths.append(n - take)
                segs[r, pos:pos + take] = seg
                pos += take
                seg += 1
        labels = np.full((b, t), IGNORE_INDEX, np.int64)
        same = segs[:, 1:] == segs[:, :-1]
        labels[:, :-1] = np.where(same, ids[:, 1:], IGNORE_INDEX)
        yield {"input_ids": ids.astype(np.int32), "labels": labels.astype(np.int32),
               "segment_ids": segs.astype(np.int32), "padding_mask": np.ones((b, t), bool)}
