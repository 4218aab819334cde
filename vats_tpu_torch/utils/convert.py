"""Carry ``vats_tpu`` TextLM weights across into the port.

:func:`params_from_jax` takes the JAX ``TextLM`` parameter tree as nested
dicts of numpy arrays (``{"params": ...}`` or the inner dict; flax's
partitioning boxes already unwrapped) and returns a ``state_dict`` for
:class:`vats_tpu_torch.models.TextLM`:

  * a flax ``Dense`` kernel is ``[in, out]``; a torch ``Linear`` weight is
    ``[out, in]``, so kernels are transposed;
  * the stacked expert weights ``[E, d, f]`` / ``[E, f, d]`` stay stacked;
  * a scan-mode tree (``layers/block`` stacked on axis 0) is first unstacked
    into ``layer_{i}`` subtrees, in numpy, as ``TextLM.unstack_scan_params``
    does.

A gradient tree has the params' structure, so the same function carries JAX
gradients across for a leaf-by-leaf comparison with the port's ``.grad``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from vats_tpu_torch.configs.nlp import ModelArgs
from vats_tpu_torch.device import resolve_dtype


def unstack_scan_params(params: Mapping, num_layers: int) -> dict:
    """Scan-mode params ('layers' stacked on axis 0) -> 'layer_{i}' subtrees."""
    p = dict(params)
    stacked = p.pop("layers")["block"]

    def take(tree, i):
        if isinstance(tree, Mapping):
            return {k: take(v, i) for k, v in tree.items()}
        return np.asarray(tree)[i]

    for i in range(num_layers):
        p[f"layer_{i}"] = take(stacked, i)
    return p


def params_from_jax(params_np: Mapping, cfg: ModelArgs) -> Dict[str, torch.Tensor]:
    """JAX TextLM params (numpy) -> port TextLM state_dict (cfg.param_dtype)."""
    p = params_np.get("params", params_np)
    if "layers" in p:
        p = unstack_scan_params(p, cfg.num_layers)
    dtype = resolve_dtype(cfg.param_dtype)
    sd: Dict[str, torch.Tensor] = {}

    def put(name, arr, transpose=False):
        a = np.array(arr, dtype=np.float32)  # an owned, writable copy
        if transpose:
            a = np.ascontiguousarray(a.T)
        sd[name] = torch.from_numpy(a).to(dtype)

    def put_dense(prefix, tree):
        put(f"{prefix}.weight", tree["kernel"], transpose=True)
        if "bias" in tree:
            put(f"{prefix}.bias", tree["bias"])

    put("token_embed.weight", p["token_embed"]["embedding"])
    for i in range(cfg.num_layers):
        lp = p[f"layer_{i}"]
        ab = lp["attn_block"]
        pre = f"layers.{i}.attn_block"
        put(f"{pre}.norm.weight", ab["RMSNorm_0"]["weight"])
        at = ab["Attention_0"]
        names = ("w_qkv", "w_o") if cfg.use_qkv_proj else ("w_q", "w_k", "w_v", "w_o")
        for name in names:
            put_dense(f"{pre}.attn.{name}", at[name])
        mb = lp["moe_block"]
        pre = f"layers.{i}.moe_block"
        put(f"{pre}.norm.weight", mb["RMSNorm_0"]["weight"])
        ml = mb["MoELayer_0"]
        if cfg.moe_double_norm:
            put(f"{pre}.moe.norm.weight", ml["RMSNorm_0"]["weight"])
        put(f"{pre}.moe.router.router.weight", ml["TopKRouter_0"]["router"],
            transpose=True)
        put(f"{pre}.moe.router.router.bias", ml["TopKRouter_0"]["router_bias"])
        ex = ml["ExpertSwiGLU_0"]
        for name in ("w_gate", "w_up", "w_down"):
            put(f"{pre}.moe.experts.{name}", ex[name])
    put("norm.weight", p["RMSNorm_0"]["weight"])
    if not cfg.tie_weights:
        put("lm_head.weight", p["lm_head"]["kernel"], transpose=True)
    return sd
