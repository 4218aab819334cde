"""Run one cell of the benchmark once on this machine's GPUs and print its
result as the last line of standard output.

    python benchmark/run.py --workload medium_e8.decode_heavy --seed 7 \
        --seconds 20 --trace 0

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; its
configuration file, its traffic mix (``benchmark/traffic/<traffic>.json``),
its limits (``benchmark/limits/<cell>.json``) and the driver of the
configuration's ``kind`` (``benchmark/drivers/<kind>.py``) are found by
name, and each per-layer metric by its reader
(``benchmark/metrics/<metric>.py``).  ``--trace 0`` prints the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics from a profiled
span of the window.  Exits non-zero, printing no result, without enough
CUDA devices, or when a JAX module was loaded.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache inside the checkout, at fixed paths
_CACHE = os.path.join(ROOT, ".bench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(_CACHE, "nv")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402


def fail(msg: str, code: int) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def cell_files(manifest: dict, workload: str):
    """(cell, config, mix, limits) of a workload name."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        fail(f"no workload {workload!r} in BENCHMARK.json", 2)
    cell = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    mix = harness.load_json("traffic", f"{cell['traffic']}.json")
    limits = harness.load_json("limits", f"{workload}.json")
    return cell, config, mix, limits


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def make_ctx(workload: str, seed: int, seconds: float, trace: bool = False,
             control=None, rate=None, process_start=None):
    """(manifest, the run's context) of one run of ``workload``; exits when
    this machine has fewer CUDA devices than the cell asks for."""
    manifest = harness.load_manifest()
    cell, config, mix, limits = cell_files(manifest, workload)
    import torch

    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(f"needs {chips} CUDA device(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", 2)
    ctx = types.SimpleNamespace(
        config=config, mix=mix, limits=limits, seed=seed, seconds=seconds, trace=trace,
        device=torch.device("cuda"), chips=chips, rec=harness.Recorder(),
        process_start=process_start if process_start is not None else harness.process_start_wall(),
        control=control, rate=rate)
    return manifest, ctx


def drive(ctx) -> dict:
    """One run of the cell by its configuration's driver."""
    return importlib.import_module(f"benchmark.drivers.{ctx.config['kind']}").run(ctx)


def main(argv=None) -> int:
    process_start = harness.process_start_wall()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    manifest, ctx = make_ctx(args.workload, args.seed, args.seconds, bool(args.trace),
                             process_start=process_start)
    out = drive(ctx)

    loaded = harness.forbidden_modules()
    if loaded:
        fail(f"JAX modules loaded in the run's process: {', '.join(loaded)}", 3)
    metrics = {}
    if not args.trace:
        values = dict(out["e2e"], setup_s=out["setup_s"])
        for metric in manifest["end_to_end"]:
            if not applies(metric, args.workload):
                continue
            v = values.get(metric["name"])
            if v is None:
                fail(f"end-to-end metric {metric['name']} was not measured", 4)
            metrics[metric["name"]] = {"value": v, "unit": metric["unit"]}
    else:
        for metric in manifest["per_layer"]:
            if applies(metric, args.workload):
                v = harness.load_reader(metric["name"])(out["record"])
                if v is not None:
                    metrics[metric["name"]] = {"value": v, "unit": metric["unit"]}
    device = out["device"]
    result = {"correct": harness.within(out["checks"]), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    trace = out["record"].get("trace")
    if args.trace and trace is not None:
        device["busy_s"] = trace["busy_s"]
        device["window_s"] = trace["window_s"]
        result["breakdown"] = trace["breakdown"]
    result["setup_parts"] = dict(ctx.rec.phases)
    result["info"] = out["info"]
    result["checks"] = out["checks"]
    print(json.dumps(out["info"]), file=sys.stderr)
    print(f"setup parts (s): {json.dumps(result['setup_parts'])}", file=sys.stderr)
    print(f"checks: {harness.checks_text(out['checks'])}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
