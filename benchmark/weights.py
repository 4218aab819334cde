"""The benchmark's weights, made on the device from the run's seed.

Both the program and the reference take their weights from
:func:`make_params`: one flat buffer filled by one uniform draw of a
``torch.Generator`` on the device, in the dtype the configuration serves or
trains in, then scaled leaf by leaf to the spread of each leaf's
initializer (a uniform of the same standard deviation; the RMSNorm scales
are 1, the router's bias 0).  The names and shapes are those of the port's
``TextLM`` state dict, worked out here from the configuration so that the
reference needs nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

SEED_MOD = 1 << 63


def param_specs(m: dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, init, scale) of every parameter of a TextLM config
    ``m``: init 'uniform' takes values in [-scale, scale], 'ones' and
    'zeros' are constants."""
    d, h, g, f = m["d_model"], m["num_heads"], m["query_groups"], m["d_ffn"]
    hd, e, layers, v = d // h, m["num_experts"], m["num_layers"], m["vocab_size"]
    if e < 2:
        raise ValueError("the benchmark's weights cover the MoE TextLM (num_experts >= 2)")
    std_uniform = math.sqrt(3.0)  # a uniform in [-a, a] has std a / sqrt(3)
    depth = 1.0 / math.sqrt(layers / 6.0) if layers > 12 else 1.0

    def xavier(fan_in, fan_out):
        return math.sqrt(6.0 / (fan_in + fan_out)) * depth

    out_std = 0.02 / math.sqrt(2 * layers) * std_uniform
    specs = [("token_embed.weight", (v, d), "uniform", 0.02 * std_uniform)]
    for i in range(layers):
        p = f"layers.{i}."
        specs += [
            (p + "attn_block.norm.weight", (d,), "ones", 1.0),
            (p + "attn_block.attn.w_qkv.weight", ((h + 2 * g) * hd, d), "uniform",
             xavier(d, (h + 2 * g) * hd)),
            (p + "attn_block.attn.w_o.weight", (d, h * hd), "uniform", out_std),
            (p + "moe_block.norm.weight", (d,), "ones", 1.0),
        ]
        if m.get("moe_double_norm", True):
            specs.append((p + "moe_block.moe.norm.weight", (d,), "ones", 1.0))
        specs += [
            (p + "moe_block.moe.router.router.weight", (e, d), "uniform", xavier(d, e)),
            (p + "moe_block.moe.router.router.bias", (e,), "zeros", 0.0),
            (p + "moe_block.moe.experts.w_gate", (e, d, f), "uniform", xavier(d, f)),
            (p + "moe_block.moe.experts.w_up", (e, d, f), "uniform", xavier(d, f)),
            (p + "moe_block.moe.experts.w_down", (e, f, d), "uniform", out_std),
        ]
    specs.append(("norm.weight", (d,), "ones", 1.0))
    if not m.get("tie_weights", True):
        specs.append(("lm_head.weight", (v, d), "uniform", 0.02 * std_uniform))
    return specs


def make_params(m: dict, seed: int, dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """Every parameter of config ``m`` as a view of one flat buffer on
    ``device``, drawn from ``seed`` (the same seed, dtype and device give
    the same bits)."""
    specs = param_specs(m)
    total = sum(math.prod(shape) for _, shape, _, _ in specs)
    gen = torch.Generator(device=device).manual_seed(int(seed) % SEED_MOD)
    flat = torch.empty(total, dtype=dtype, device=device)
    with torch.no_grad():
        flat.uniform_(-1.0, 1.0, generator=gen)
        out, off = {}, 0
        for name, shape, init, scale in specs:
            n = math.prod(shape)
            view = flat[off:off + n].view(shape)
            if init == "ones":
                view.fill_(1.0)
            elif init == "zeros":
                view.zero_()
            else:
                view.mul_(scale)
            out[name] = view
            off += n
    return out
