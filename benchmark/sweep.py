"""The capacity sweep of an open-loop serving cell: one run of the cell at
each offered rate (requests a second) and seed, in one process, printing
what shows whether the engine keeps up: the output tokens a second, the
p95 time to first token from the due time, and the requests still queued
when the window closed.  Arrivals are Poisson, so a rate is read on
several seeds.  The highest rate at which no seed leaves a queue and the
p95 stays at the lowest rates' level is the engine's capacity; a cell's
mix offers 0.8 of it.

    python benchmark/sweep.py --workload <open-loop cell> \
        --rates 10,20,30,40 --seeds 5,6,7 --seconds 30
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.run import drive, make_ctx  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True, help="comma-separated requests a second")
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args(argv)
    for r in args.rates.split(","):
        for seed in args.seeds.split(","):
            _, ctx = make_ctx(args.workload, int(seed), args.seconds, rate=float(r))
            row(float(r), int(seed), drive(ctx))
            gc.collect()
    return 0


def row(rate: float, seed: int, out: dict) -> None:
    c = out["record"]["counters"]
    print(json.dumps({"rate": rate, "seed": seed,
                      "serve_tokens_per_s": out["e2e"]["serve_tokens_per_s"],
                      "ttft_p95_s": out["e2e"].get("ttft_p95_s"),
                      "tpot_p95_ms": out["e2e"].get("tpot_p95_ms"),
                      "due_in_window": out["attempted"], "queued_at_end": c["queued_at_end"],
                      "preemptions": c["preemptions"],
                      "prefix_hit_share": c["prefix_hit_tokens"] / max(1, c["prefix_query_tokens"]),
                      "correct": out["checks"]}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
