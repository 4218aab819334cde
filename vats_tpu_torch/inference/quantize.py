"""Weight-only int8 quantization for serving.

Counterpart of ``vats_tpu/inference/quantize.py``.  Decode at the medium
tier reads every weight once per step; storing the large matrices as int8
with per-output-channel scales halves those bytes and the resident weight
memory.  Numerics as in the JAX package: per-channel symmetric int8 (scale =
max|w| / 127 over every axis but the channel axis, IEEE division), every
float weight with ndim >= 2 and at least ``min_size`` elements; norm gains,
biases and small tensors stay as they are.  Dequantization is a product in
the compute dtype, ``qvalue.to(dtype) * scale.to(dtype)``.

The channel axis is the JAX one: the last axis of the JAX layout.  A flax
``Dense`` kernel is ``[in, out]`` and the port's ``nn.Linear`` weight its
transpose ``[out, in]``, so Linear weights quantize per row (axis 0); the
embedding ``[V, d]`` and the stacked experts ``[E, d, f]`` / ``[E, f, d]``
keep the JAX layout and quantize over their last axis.  The same weights
give the same int8 bytes and scales in both packages, transposed.

:class:`QuantizedModel` keeps the int8 tree resident and never builds the
whole bf16 tree: the wrapped model's quantized weights are released, each
layer's are dequantized as the layer starts and dropped when it ends (the
embedding and readout stay dequantized through one forward).  The matmuls
after dequantization are ``torch.matmul``, as the JAX package leaves its
fused dequant-matmul to XLA (there is no Pallas kernel there).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Union

import torch
from torch import nn

from vats_tpu_torch.nn.kv_cache import KVCache


@dataclass
class QTensor:
    """An int8 tensor with per-channel fp32 scales (broadcastable shape)."""

    qvalue: torch.Tensor  # int8, the original shape
    scale: torch.Tensor  # fp32, size 1 on every axis but the channel axis

    def numel(self) -> int:
        return self.qvalue.numel()


def quantize_tensor(w: torch.Tensor, channel_axis: int = -1) -> QTensor:
    """Symmetric per-channel int8: one scale per index of ``channel_axis``
    (the JAX package's last axis), the max reduced over every other axis."""
    channel_axis %= w.ndim
    reduce_axes = tuple(a for a in range(w.ndim) if a != channel_axis)
    wf = w.float()
    amax = wf.abs().amax(dim=reduce_axes, keepdim=True)
    # IEEE division: PyTorch's CUDA division by a Python scalar would
    # multiply by its reciprocal
    scale = torch.clamp(amax, min=1e-8) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QTensor(qvalue=q, scale=scale)


def dequantize_tensor(q: QTensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return q.qvalue.to(dtype) * q.scale.to(dtype)


Params = Dict[str, Union[torch.Tensor, QTensor]]


def quantize_params(model: nn.Module, *, min_size: int = 1 << 16) -> Params:
    """The model's parameters by name, every float one with ndim >= 2 and
    size >= ``min_size`` as a :class:`QTensor` (Linear weights per output
    row, the rest per last-axis channel), the others as they are."""
    linear = {f"{name}.weight" for name, mod in model.named_modules()
              if isinstance(mod, nn.Linear)}
    out: Params = {}
    for name, p in model.named_parameters():
        if p.ndim >= 2 and p.numel() >= min_size and p.is_floating_point():
            out[name] = quantize_tensor(p.detach(), 0 if name in linear else -1)
        else:
            out[name] = p.detach()
    return out


def dequantize_params(qparams: Params, dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Every weight dequantized (the whole float tree: for tests and
    inspection; :class:`QuantizedModel` dequantizes layer by layer)."""
    return {k: dequantize_tensor(v, dtype) if isinstance(v, QTensor) else v
            for k, v in qparams.items()}


def quantized_bytes(qparams: Params) -> int:
    """Resident weight bytes of a (partially) quantized tree."""
    total = 0
    for v in qparams.values():
        parts = (v.qvalue, v.scale) if isinstance(v, QTensor) else (v,)
        total += sum(t.numel() * t.element_size() for t in parts)
    return total


class QuantizedModel:
    """A model served from int8 weights; takes the place of ``TextLM``
    wherever the generation loops and the serving engine take a model.

    ``QuantizedModel(model)`` quantizes ``model``'s weights
    (:func:`quantize_params`) and releases the float copies of the quantized
    ones: the wrapped model then runs only through this wrapper.
    ``compute_dtype`` is the dtype weights are dequantized into (bf16, as in
    the JAX package)."""

    def __init__(self, model: nn.Module,
                 compute_dtype: torch.dtype = torch.bfloat16, *,
                 min_size: int = 1 << 16):
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.compute_dtype = compute_dtype
        self.qparams = quantize_params(model, min_size=min_size)
        self._slots = {}  # name -> (module, attribute) of each quantized weight
        per_layer = {i: [] for i in range(len(model.layers))}
        self._top = []
        for name, v in self.qparams.items():
            if not isinstance(v, QTensor):
                continue
            mod_name, attr = name.rsplit(".", 1)
            mod = model.get_submodule(mod_name)
            mod._parameters[attr] = None  # the int8 copy is the resident one
            self._slots[name] = (mod, attr)
            parts = name.split(".")
            if parts[0] == "layers":
                per_layer[int(parts[1])].append(name)
            else:
                self._top.append(name)
        for i, layer in enumerate(model.layers):
            names = per_layer[i]
            layer.register_forward_pre_hook(
                lambda mod, args, names=names: self._install(names))
            layer.register_forward_hook(
                lambda mod, args, out, names=names: self._release(names))

    def _install(self, names):
        for name in names:
            mod, attr = self._slots[name]
            mod._parameters[attr] = dequantize_tensor(self.qparams[name],
                                                      self.compute_dtype)

    def _release(self, names):
        for name in names:
            mod, attr = self._slots[name]
            mod._parameters[attr] = None

    @torch.no_grad()
    def __call__(self, *args, **kwargs):
        self._install(self._top)
        try:
            return self.model(*args, **kwargs)
        finally:
            self._release(self._top)

    def init_cache(self, batch_size: int, max_seq_len: Optional[int] = None,
                   ring: bool = False) -> KVCache:
        """``TextLM.init_cache`` on this wrapper's device (the wrapped
        model's embedding, which names its device there, is released)."""
        cfg = self.cfg
        return KVCache.create(num_layers=cfg.num_layers, batch_size=batch_size,
                              max_seq_len=max_seq_len or cfg.max_seq_len,
                              kv_heads=cfg.query_groups, head_dim=cfg.head_dim,
                              dtype=self.model.dtype, ring=ring, device=self.device)
