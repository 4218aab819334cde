"""Continuous-batching serving demo / load generator.

The port's counterpart of ``scripts/nlp/serve.py``, with the same flags:
feed a stream of requests through :class:`ServingEngine` (paged KV pool,
page allocator, admission and retirement mid-flight) and report latency and
throughput.  With ``--ckpt`` it serves a trained checkpoint (the model args
come from its metadata); without, random weights at ``--config`` (load
testing).  The prompt stream is drawn from ``np.random.default_rng(seed)``
exactly as the JAX script draws it, so both serve the same requests.

    python -m vats_tpu_torch.scripts.nlp.serve --cpu --config xsmall \\
        --requests 8 --max-batch 4

Runs on the card unless ``--cpu`` is given.  :func:`main` prints the summary
line and returns ``{"outputs": {rid: output_ids}, ...}`` with the summary's
numbers and the engine's forward counts.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional

import numpy as np


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", default=None, help="checkpoint file (optional)")
    p.add_argument("--config", default="xsmall",
                   choices=["xsmall", "small", "medium", "large", "xlarge"])
    p.add_argument("--max-batch", type=int, default=4)
    p.add_argument("--max-context", type=int, default=512)
    p.add_argument("--page-size", type=int, default=128)
    p.add_argument("--total-pages", type=int, default=None)
    p.add_argument("--kv-quant", choices=["int8"], default=None)
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the plain PyTorch versions of the kernels)")
    p.add_argument("--decode-block-steps", type=int, default=1,
                   help="decode steps per block (one captured graph on the card; "
                        "the scheduler acts every k tokens)")
    p.add_argument("--spec-k", type=int, default=0,
                   help="speculative decoding: propose this many tokens per "
                        "step via prompt-lookup drafts (greedy only)")
    p.add_argument("--prefix-caching", action="store_true",
                   help="share full prompt pages across requests "
                        "(content-addressed, refcounted)")
    p.add_argument("--shared-prefix-len", type=int, default=0,
                   help="prepend this many identical tokens to every "
                        "prompt (models a common system prompt)")
    p.add_argument("--overlap-scheduling", action="store_true",
                   help="pipeline host scheduling behind device decode "
                        "blocks (dispatch block N+1 before fetching N)")
    p.add_argument("--per-request-sampling", action="store_true",
                   help="each request carries its own SamplingParams "
                        "(demo: alternating greedy / temperature+top-k "
                        "rows sharing one batch)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    import torch

    from vats_tpu_torch import configs as cfgs
    from vats_tpu_torch.checkpoint import load_checkpoint
    from vats_tpu_torch.configs import ModelArgs
    from vats_tpu_torch.device import resolve_device
    from vats_tpu_torch.inference import SamplingParams, ServingEngine
    from vats_tpu_torch.models import TextLM

    device = resolve_device("cpu" if args.cpu else "cuda")
    if args.ckpt:
        restored, meta = load_checkpoint(args.ckpt)
        model_args = ModelArgs.from_dict(meta["model_args"])
        model = TextLM(model_args, device="meta")
        model.load_state_dict(restored["params"], assign=True)
        model = model.to(device).eval()
    else:
        model_args = getattr(cfgs, f"nlp_{args.config}")(
            dropout=0.0, max_seq_len=args.max_context
        )
        model = TextLM(model_args, device=device, seed=args.seed).eval()

    eng = ServingEngine(
        model,
        max_batch=args.max_batch,
        max_context=args.max_context,
        page_size=args.page_size,
        total_pages=args.total_pages,
        kv_quant=args.kv_quant,
        do_sample=args.temperature > 0,
        temperature=args.temperature,
        seed=args.seed,
        decode_block_steps=args.decode_block_steps,
        prefix_caching=args.prefix_caching,
        spec_k=args.spec_k,
        per_request_sampling=args.per_request_sampling,
        overlap_scheduling=args.overlap_scheduling,
    )

    rng = np.random.default_rng(args.seed)
    shared = rng.integers(
        1, model_args.vocab_size, size=args.shared_prefix_len
    ).astype(int).tolist()
    submit_t: dict = {}
    for i in range(args.requests):
        plen = max(1, args.prompt_len + int(rng.integers(-8, 9)))
        prompt = shared + rng.integers(
            1, model_args.vocab_size, size=plen
        ).astype(int).tolist()
        sampling = None
        if args.per_request_sampling:
            sampling = (
                SamplingParams(temperature=0.0) if i % 2 == 0
                else SamplingParams(
                    temperature=max(args.temperature, 0.8), top_k=50, seed=i
                )
            )
        rid = eng.submit(
            prompt, max_new_tokens=args.max_new_tokens, sampling=sampling
        )
        submit_t[rid] = time.perf_counter()

    t0 = time.perf_counter()
    done_t: dict = {}
    results: dict = {}
    while (eng.queue or any(r is not None for r in eng.row_request)
           or eng._inflight is not None):
        for req in eng.step():
            results[req.rid] = req.output_ids
            done_t[req.rid] = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0

    total_tokens = sum(len(v) for v in results.values())
    lat = [done_t[r] - submit_t[r] for r in results]
    p50, p99 = float(np.percentile(lat, 50)), float(np.percentile(lat, 99))
    print(
        f"served {len(results)} requests, {total_tokens} tokens in "
        f"{wall:.2f}s -> {total_tokens / wall:.1f} tok/s | "
        f"latency p50 {p50:.2f}s "
        f"p99 {p99:.2f}s | "
        f"page high-water {eng.allocator.high_water}/"
        f"{eng.allocator.capacity}, preemptions {eng.preemptions}"
        + (
            f" | prefix-cache hit {eng.prefix_cache.hit_tokens}/"
            f"{eng.prefix_cache.query_tokens} prompt tokens"
            if eng.prefix_cache is not None else ""
        )
        + (
            f" | spec accept {eng.spec_accepted}/{eng.spec_proposed}"
            if eng.spec_k else ""
        )
    )
    return {
        "outputs": results,
        "requests": len(results),
        "total_tokens": total_tokens,
        "wall_s": wall,
        "tokens_per_s": total_tokens / wall,
        "latency_p50_s": p50,
        "latency_p99_s": p99,
        "preemptions": eng.preemptions,
        "forwards": dict(eng.forwards),
        "num_layers": model_args.num_layers,
    }


if __name__ == "__main__":
    main()
