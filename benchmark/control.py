"""Readings that set a cell's limits, on the chip at the cell's own size.

Serving cells: each seed is one run of the cell with a short window, whose
checked greedy and sampled requests are read twice: the program's served
tokens (the lower readings) and the control's, the reference held in fp8
where the program holds bf16, at each position of the same sequences: its
argmax where greedy, its own draw by the request's rule where sampled (the
upper readings).

Training cells: each seed runs the plain reference three optimizer steps
in fp32, and again as the control (held in fp8 where the program holds
bf16), with half of every batch left out (a fault the check must catch),
and in bf16 (the program's own rounding, for the record), and compares
each with the fp32 run as a run of the program is compared.

    python benchmark/control.py --workload medium_e8.decode_heavy \
        --seeds 11,12,13 --seconds 20

One JSON line a seed on standard output.  The benchmark's own runs never
run this.
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


def serve_readings(workload: str, seed: int, seconds: float) -> dict:
    _, ctx = make_ctx(workload, seed, seconds, control=True)
    out = drive(ctx)
    return dict(out["info"], seed=seed,
                **{f"program_{k}": v["value"] for k, v in out["checks"].items()})


def train_readings(workload: str, seed: int) -> dict:
    import torch

    from benchmark.drivers import train

    _, ctx = make_ctx(workload, seed, 0.0)
    accum = int(ctx.mix["grad_accum_steps"])
    total = int(ctx.config["trainer"]["num_training_steps"])
    ref = train.reference_run(ctx, accum, total)
    out = {"seed": seed}
    b = int(ctx.mix["batch"])
    for name, kw in (("fp8", dict(precision="fp8")),
                     ("half_batch", dict(batch_rows=slice(0, b // 2))),
                     ("bf16", dict(precision="bf16"))):
        gc.collect()
        torch.cuda.empty_cache()
        run = train.reference_run(ctx, accum, total, **kw)
        out[name] = train.compare(run, ref)
        out[name + "_leaves"] = train.leaf_stats(run, ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    _, probe = make_ctx(args.workload, 0, args.seconds)
    kind = probe.config["kind"]
    for s in args.seeds.split(","):
        seed = int(s)
        row = (serve_readings(args.workload, seed, args.seconds) if kind == "serve"
               else train_readings(args.workload, seed))
        print(json.dumps(row), flush=True)
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
