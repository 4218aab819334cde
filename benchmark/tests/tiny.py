"""Tiny cells for the CPU tests: the cells' own configurations and mixes,
shrunk to a size the CPU drives in seconds (fp32, two layers, four
experts), run by the same drivers with the harness's look for a chip
skipped."""

from __future__ import annotations

import copy
import json
import os
import time
import types

import torch

from benchmark import harness

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def tiny_model(base: dict, **kw) -> dict:
    m = dict(base, d_model=128, num_heads=4, query_groups=2, d_ffn=256, num_layers=2,
             num_experts=4, vocab_size=512, max_seq_len=512, dtype="float32",
             param_dtype="float32")
    m.update(kw)
    return m


SERVE_MIXES = {
    "closed_loop": {"kind": "closed_loop", "clients": 4,
                    "prompt": {"median": 40, "sigma": 0.8, "min": 8, "max": 100},
                    "output": {"median": 10, "sigma": 0.6, "min": 4, "max": 24},
                    "greedy_every": 2, "sampling": {"temperature": 0.7, "top_p": 0.95, "top_k": 50},
                    "pool": 256, "warmup_s": 0.5},
    "open_loop": {"kind": "open_loop", "rate": 6.0, "block": 16,
                  "prefixes": {"count": 3, "length": 256, "zipf_s": 1.0},
                  "prompt": {"median": 20, "sigma": 0.6, "min": 8, "max": 60},
                  "output": {"median": 8, "sigma": 0.6, "min": 4, "max": 16},
                  "greedy_every": 2, "sampling": {"temperature": 0.7, "top_p": 0.95, "top_k": 50},
                  "pool": 256, "warmup_s": 0.5},
}

TRAIN_MIXES = {
    "lm_packed": {"kind": "lm_packed", "batch": 4, "seq_len": 64, "grad_accum_steps": 2,
                  "doc": {"median": 20, "sigma": 1.0, "min": 4, "max": 64}, "pool": 64},
    "lm_rows": {"kind": "lm_rows", "batch": 4, "seq_len": 32, "grad_accum_steps": 1},
}


def serve_ctx(mix_kind: str, cell: str, seed: int = 987654321012, seconds: float = 1.5):
    cfg = _load("configs", "vats_medium_e8.json")
    cfg["model"] = tiny_model(cfg["model"])
    cfg["engine"] = dict(max_batch=4, max_context=512, page_size=128, total_pages=40,
                         prefix_caching=True, decode_block_steps=4, per_request_sampling=True,
                         sampling_kmax=64, prompt_buckets=[32, 128, 512])
    return _ctx(cfg, copy.deepcopy(SERVE_MIXES[mix_kind]), _load("limits", f"{cell}.json"),
                seed, seconds)


def train_ctx(mix_kind: str, cell: str, seed: int = 987654321012, seconds: float = 1.0):
    cfg = _load("configs", "vats_medium_moe.json")
    cfg["model"] = tiny_model(cfg["model"])
    return _ctx(cfg, copy.deepcopy(TRAIN_MIXES[mix_kind]), _load("limits", f"{cell}.json"),
                seed, seconds)


def _ctx(cfg, mix, limits, seed, seconds):
    return types.SimpleNamespace(
        config=cfg, mix=mix, limits=limits, seed=seed, seconds=seconds, trace=False,
        device=torch.device("cpu"), chips=1, rec=harness.Recorder(), process_start=time.time(),
        control=None, rate=None)
