"""Cross-attention (queries from one stream, K/V from another).

Counterpart of ``vats_tpu/nn/cross_attention.py`` (``CrossAttention``,
``CrossAttentionBlock``): full multi-head attention (no GQA), separate q / k
/ v / o projections, a key mask over the context stream, and the pre-RMSNorm
residual block.  It attends with the plain attention
(``ops/attention_ref.dot_product_attention``), as the JAX module attends
with XLA: no kernel is on this path.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vats_tpu_torch.nn.attention import dense
from vats_tpu_torch.nn.dropout import SITE_CROSS, Seed, dropout
from vats_tpu_torch.nn.initializers import input_proj_init_, output_proj_init_
from vats_tpu_torch.nn.norms import RMSNorm
from vats_tpu_torch.ops.attention_ref import dot_product_attention


class CrossAttention(nn.Module):
    def __init__(
        self,
        d_model: int,
        num_heads: int,
        softmax_scale: Optional[float] = None,
        use_proj_bias: bool = False,
        num_layers: int = 1,
        dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        if d_model % num_heads != 0:
            raise ValueError("d_model must be divisible by num_heads")
        self.d_model = d_model
        self.num_heads = num_heads
        self.softmax_scale = softmax_scale
        self.num_layers = num_layers
        self.dtype = dtype
        lin = lambda: nn.Linear(d_model, d_model, bias=use_proj_bias,  # noqa: E731
                                dtype=param_dtype, device=device)
        self.w_q, self.w_k, self.w_v, self.w_o = lin(), lin(), lin(), lin()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for lin in (self.w_q, self.w_k, self.w_v):
            input_proj_init_(lin.weight, self.num_layers,
                             (lin.in_features, lin.out_features), generator)
        output_proj_init_(self.w_o.weight, self.num_layers, generator)
        with torch.no_grad():
            for lin in (self.w_q, self.w_k, self.w_v, self.w_o):
                if lin.bias is not None:
                    lin.bias.zero_()

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                context_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, T_q, d]; context [B, T_k, d]; context_mask [B, T_k] bool."""
        h = self.num_heads
        hd = self.d_model // h
        b, t_q, _ = x.shape
        t_k = context.shape[1]
        scale = self.softmax_scale if self.softmax_scale is not None else 1.0 / float(hd) ** 0.5
        q = dense(self.w_q, x, self.dtype).reshape(b, t_q, h, hd)
        k = dense(self.w_k, context, self.dtype).reshape(b, t_k, h, hd)
        v = dense(self.w_v, context, self.dtype).reshape(b, t_k, h, hd)
        out = dot_product_attention(q, k, v, scale=scale, causal=False,
                                    kv_valid=context_mask)
        return dense(self.w_o, out.reshape(b, t_q, h * hd), self.dtype)


class CrossAttentionBlock(nn.Module):
    """x + dropout(cross_attn(norm(x), context))."""

    def __init__(
        self,
        d_model: int,
        num_heads: int,
        softmax_scale: Optional[float] = None,
        use_proj_bias: bool = False,
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
        self.attn = CrossAttention(d_model, num_heads, softmax_scale, use_proj_bias,
                                   num_layers, dtype, param_dtype, device=device)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.norm.weight.fill_(1.0)
        self.attn.reset_parameters(generator)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                context_mask: Optional[torch.Tensor] = None, *,
                deterministic: bool = True, dropout_seed: Optional[Seed] = None,
                layer_idx: int = 0) -> torch.Tensor:
        out = self.attn(self.norm(x), context, context_mask)
        out = dropout(out, self.dropout, deterministic=deterministic, seed=dropout_seed,
                      layer=layer_idx, site=SITE_CROSS)
        return x + out
