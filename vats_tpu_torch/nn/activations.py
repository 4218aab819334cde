"""SwiGLU gated FFN and the pre-norm FFN block.

Counterpart of ``vats_tpu/nn/activations.py``:

  * SwiGLU: ``w_down(silu(w_gate x) * w_up x)``, bias-free projections in
    the compute dtype, then dropout;
  * FFNBlock: ``x + dropout(swiglu(rms_norm(x)))`` (so the SwiGLU output
    meets two dropouts in training, as in JAX).

The stacked-expert form of the same product is ``nn/moe.ExpertSwiGLU``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vats_tpu_torch.nn.attention import dense
from vats_tpu_torch.nn.dropout import SITE_FFN_BLOCK, SITE_SWIGLU, Seed, dropout
from vats_tpu_torch.nn.initializers import input_proj_init_, output_proj_init_
from vats_tpu_torch.nn.norms import RMSNorm


class SwiGLU(nn.Module):
    def __init__(
        self,
        d_model: int,
        d_ffn: int,
        dropout: float = 0.0,
        num_layers: int = 1,
        dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        self.dropout = dropout
        self.num_layers = num_layers
        self.dtype = dtype
        lin = lambda i, o: nn.Linear(i, o, bias=False, dtype=param_dtype,  # noqa: E731
                                     device=device)
        self.w_gate = lin(d_model, d_ffn)
        self.w_up = lin(d_model, d_ffn)
        self.w_down = lin(d_ffn, d_model)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for lin in (self.w_gate, self.w_up):
            input_proj_init_(lin.weight, self.num_layers,
                             (lin.in_features, lin.out_features), generator)
        output_proj_init_(self.w_down.weight, self.num_layers, generator)

    def param_logical_axes(self):
        return {"w_gate.weight": ("mlp", "embed"), "w_up.weight": ("mlp", "embed"),
                "w_down.weight": ("embed", "mlp")}

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                dropout_seed: Optional[Seed] = None, layer_idx: int = 0) -> torch.Tensor:
        """Under tensor parallelism (``mlp`` over ``tensor``) w_gate and w_up
        are column-parallel and w_down row-parallel (``attention.dense``)."""
        dt = self.dtype
        hidden = F.silu(dense(self.w_gate, x, dt)) * dense(self.w_up, x, dt)
        return dropout(dense(self.w_down, hidden, dt), self.dropout,
                       deterministic=deterministic, seed=dropout_seed,
                       layer=layer_idx, site=SITE_SWIGLU)


class FFNBlock(nn.Module):
    """Pre-RMSNorm -> SwiGLU -> dropout -> residual."""

    def __init__(
        self,
        d_model: int,
        d_ffn: int,
        dropout: float = 0.0,
        eps: float = 1e-7,
        num_layers: int = 1,
        dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        self.dropout = dropout
        self.norm = RMSNorm(d_model, eps, dtype, param_dtype, device=device)
        self.swiglu = SwiGLU(d_model, d_ffn, dropout, num_layers, dtype, param_dtype,
                             device=device)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.norm.weight.fill_(1.0)
        self.swiglu.reset_parameters(generator)

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                dropout_seed: Optional[Seed] = None, layer_idx: int = 0) -> torch.Tensor:
        h = self.swiglu(self.norm(x), deterministic=deterministic,
                        dropout_seed=dropout_seed, layer_idx=layer_idx)
        h = dropout(h, self.dropout, deterministic=deterministic, seed=dropout_seed,
                    layer=layer_idx, site=SITE_FFN_BLOCK)
        return x + h
