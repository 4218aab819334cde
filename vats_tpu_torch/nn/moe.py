"""Mixture-of-Experts: top-k router + expert dispatch.

Counterpart of ``vats_tpu/nn/moe.py``:
  * ``TopKRouter``: linear d_model -> E in fp32, softmax, top-k, weights
    renormalized by their sum; coefficient-of-variation aux loss in training.
  * ``ExpertSwiGLU``: one stacked parameter set ``[E, ...]``.
  * ``MoELayer``: optional RMSNorm (the reference's double pre-norm), route,
    dispatch, combine.  Three dispatch modes, chosen under 'auto' exactly as
    the JAX package chooses them: 'dense' (every expert on every token),
    'scatter' (one-hot capacity dispatch) and 'sort' (stable argsort by
    expert).  The capacity formula and the slot-major token priority are
    the JAX package's, so the same tokens are dropped; capacity depends on
    the token count of each call, so a row-chunked prefill drops what the
    JAX row-chunked prefill drops.
  * ``MoEBlock``: pre-RMSNorm -> MoELayer -> dropout -> residual.

Under a mesh whose ranks each hold a shard of the tokens
(``parallel.mesh.sharded_token_mesh``) the router's expert mass is summed
over the ranks before the aux loss, as the JAX step sums it over the global
tokens; a capacity-limited dispatch (``capacity_factor > 0``) raises there,
since its capacity is a global count too.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vats_tpu_torch.nn.dropout import SITE_MOE_BLOCK, SITE_MOE_LAYER, dropout
from vats_tpu_torch.nn.initializers import input_proj_init_, output_proj_init_
from vats_tpu_torch.nn.norms import RMSNorm
from vats_tpu_torch.parallel.collectives import global_sum
from vats_tpu_torch.parallel.mesh import TOKEN_AXES, sharded_token_mesh


class TopKRouter(nn.Module):
    def __init__(
        self,
        d_model: int,
        num_experts: int,
        top_k: int,
        use_aux_loss: bool = True,
        num_layers: int = 1,
        dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        self.num_experts = num_experts
        self.top_k = top_k
        self.use_aux_loss = use_aux_loss
        self.num_layers = num_layers
        self.dtype = dtype
        self.router = nn.Linear(
            d_model, num_experts, bias=True, dtype=param_dtype, device=device
        )

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        r = self.router
        input_proj_init_(
            r.weight, self.num_layers, (r.in_features, r.out_features), generator
        )
        with torch.no_grad():
            r.bias.zero_()

    def forward(self, x: torch.Tensor, deterministic: bool = True):
        """x: [N, d] -> (weights [N, k], indices [N, k], aux_loss [])."""
        logits = F.linear(
            x.float(), self.router.weight.float(), self.router.bias.float()
        )
        probs = torch.softmax(logits, dim=-1)
        top_vals, top_idx = torch.topk(probs, self.top_k, dim=-1)
        weights = top_vals / top_vals.sum(dim=-1, keepdim=True)
        aux_loss = torch.zeros((), dtype=torch.float32, device=x.device)
        if self.use_aux_loss and not deterministic and self.num_experts > 1:
            mass = probs.sum(dim=0)
            mesh = sharded_token_mesh()
            if mesh is not None:  # the JAX step's mass is over the global tokens
                mass = global_sum(mass, mesh, TOKEN_AXES)
            frac = mass / mass.sum()
            var = (frac - frac.mean()).square().mean()
            aux_loss = torch.sqrt(var + 1e-12) / frac.mean()
        return weights.to(self.dtype), top_idx, aux_loss


class ExpertSwiGLU(nn.Module):
    """Stacked SwiGLU experts: w_gate/w_up [E, d, f], w_down [E, f, d]."""

    def __init__(
        self,
        d_model: int,
        d_ffn: int,
        num_experts: int,
        num_layers: int = 1,
        dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        e, d, f = num_experts, d_model, d_ffn
        self.num_layers = num_layers
        self.dtype = dtype
        kw = dict(dtype=param_dtype, device=device)
        self.w_gate = nn.Parameter(torch.empty(e, d, f, **kw))
        self.w_up = nn.Parameter(torch.empty(e, d, f, **kw))
        self.w_down = nn.Parameter(torch.empty(e, f, d, **kw))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        _, d, f = self.w_gate.shape
        input_proj_init_(self.w_gate, self.num_layers, (d, f), generator)
        input_proj_init_(self.w_up, self.num_layers, (d, f), generator)
        output_proj_init_(self.w_down, self.num_layers, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [E, C, d] per-expert token buffers -> [E, C, d]."""
        dt = self.dtype
        x = x.to(dt)
        gate = torch.bmm(x, self.w_gate.to(dt))
        up = torch.bmm(x, self.w_up.to(dt))
        return torch.bmm(F.silu(gate) * up, self.w_down.to(dt))


class MoELayer(nn.Module):
    def __init__(
        self,
        d_model: int,
        d_ffn: int,
        num_experts: int,
        top_k: int,
        dropout: float = 0.0,
        eps: float = 1e-7,
        double_norm: bool = True,
        dispatch: str = "auto",
        capacity_factor: float = -1.0,
        num_layers: int = 1,
        dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        if dispatch not in ("auto", "dense", "scatter", "sort"):
            raise ValueError(f"unknown moe dispatch {dispatch!r}")
        self.num_experts = num_experts
        self.top_k = top_k
        self.dropout = dropout
        self.dispatch = dispatch
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.norm = (
            RMSNorm(d_model, eps, dtype, param_dtype, device=device)
            if double_norm
            else None
        )
        self.router = TopKRouter(
            d_model, num_experts, top_k, num_layers=num_layers, dtype=dtype,
            param_dtype=param_dtype, device=device,
        )
        self.experts = ExpertSwiGLU(
            d_model, d_ffn, num_experts, num_layers=num_layers, dtype=dtype,
            param_dtype=param_dtype, device=device,
        )

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        if self.norm is not None:
            with torch.no_grad():
                self.norm.weight.fill_(1.0)
        self.router.reset_parameters(generator)
        self.experts.reset_parameters(generator)

    def _capacity(self, n: int) -> int:
        e, k = self.num_experts, self.top_k
        if self.capacity_factor <= 0:
            return n
        capacity = min(n, int(math.ceil(n * k / e * self.capacity_factor)))
        capacity = max(8, -(-capacity // 8) * 8)  # the JAX package's rounding
        return min(capacity, n * k)

    def dispatch_mode(self, n: int) -> str:
        """The mode 'auto' resolves to for a call over ``n`` tokens."""
        if self.dispatch != "auto":
            return self.dispatch
        if self.num_experts <= 2:
            return "dense"
        onehot_elems = n * self.top_k * self.num_experts * self._capacity(n)
        return "scatter" if onehot_elems <= (1 << 24) else "sort"

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                dropout_seed: Optional[int] = None, layer_idx: int = 0):
        b, t, d = x.shape
        if (self.capacity_factor > 0 and self.num_experts > 1
                and sharded_token_mesh() is not None):
            raise NotImplementedError(
                "MoE capacity under a mesh with data x seq > 1: the capacity is a "
                "count over the global tokens (expert-parallel dispatch, ROADMAP item "
                "19's remainder, is not ported yet); use capacity_factor <= 0")
        if self.norm is not None:
            x = self.norm(x)
        n = b * t
        flat = x.reshape(n, d)
        weights, indices, aux_loss = self.router(flat, deterministic=deterministic)
        capacity = self._capacity(n)
        mode = self.dispatch_mode(n)
        if mode == "dense":
            combine = torch.zeros(n, self.num_experts, dtype=weights.dtype,
                                  device=x.device)
            combine.scatter_add_(1, indices, weights)
            all_out = self.experts(flat.expand(self.num_experts, n, d))
            out = torch.einsum("ne,end->nd", combine.to(all_out.dtype), all_out)
        elif mode == "sort":
            out = self._sort_dispatch(flat, weights, indices, capacity)
        else:
            out = self._scatter_dispatch(flat, weights, indices, capacity)
        out = out.reshape(b, t, d)
        out = dropout(out, self.dropout, deterministic=deterministic,
                      seed=dropout_seed, layer=layer_idx, site=SITE_MOE_LAYER)
        return out.to(self.dtype), aux_loss

    def _sort_dispatch(self, flat, weights, indices, capacity):
        """Stable sort by expert; rank within an expert is the slot-major
        one-hot cumsum position, so both capacity paths drop the same
        assignments."""
        n, d = flat.shape
        e, k = self.num_experts, self.top_k
        nk = n * k
        dev = flat.device
        expert_ids = indices.transpose(0, 1).reshape(nk)  # slot-major
        w_flat = weights.transpose(0, 1).reshape(nk).to(self.dtype)
        token_ids = torch.arange(n, device=dev).repeat(k)
        sort_idx = torch.argsort(expert_ids, stable=True)
        sorted_experts = expert_ids[sort_idx]
        # per-expert counts without a host sync (bincount reads the largest id
        # back to size its output), so a captured decode step may sort
        counts = torch.zeros(e, dtype=torch.int64, device=dev).scatter_add_(
            0, expert_ids, torch.ones_like(expert_ids))
        starts = torch.cumsum(counts, 0) - counts
        pos = torch.arange(nk, device=dev) - starts[sorted_experts]
        keep = pos < capacity
        dest = torch.where(keep, sorted_experts * capacity + pos, e * capacity)
        gathered_in = flat[token_ids[sort_idx]].to(self.dtype)
        buf = torch.zeros(e * capacity + 1, d, dtype=self.dtype, device=dev)
        buf[dest] = gathered_in  # overflow rows all land in the trash row
        expert_out = self.experts(buf[: e * capacity].reshape(e, capacity, d))
        flat_out = torch.cat(
            [expert_out.reshape(e * capacity, d),
             torch.zeros(1, d, dtype=expert_out.dtype, device=dev)]
        )
        out_sorted = flat_out[dest] * w_flat[sort_idx][:, None]
        out = torch.zeros(n, d, dtype=self.dtype, device=dev)
        return out.index_add_(0, token_ids[sort_idx], out_sorted.to(self.dtype))

    def _scatter_dispatch(self, flat, weights, indices, capacity):
        """GShard-style static capacity dispatch via one-hot einsums."""
        n, d = flat.shape
        e, k = self.num_experts, self.top_k
        assign = F.one_hot(indices, e)  # [N, k, E] int64
        flat_assign = assign.transpose(0, 1).reshape(n * k, e)  # slot-major
        pos_in_expert = torch.cumsum(flat_assign, 0) - flat_assign
        pos = (pos_in_expert * flat_assign).sum(dim=-1)  # [N*k]
        keep = pos < capacity
        pos_oh = F.one_hot(torch.clamp(pos, max=capacity - 1), capacity)
        dispatch = (
            flat_assign[:, :, None] * pos_oh[:, None, :] * keep[:, None, None]
        ).to(self.dtype)  # [N*k, E, C]
        w_flat = weights.transpose(0, 1).reshape(n * k)
        combine = dispatch * w_flat[:, None, None].to(self.dtype)
        x_rep = flat.repeat(k, 1).to(self.dtype)
        expert_in = torch.einsum("sec,sd->ecd", dispatch, x_rep)
        expert_out = self.experts(expert_in)
        out = torch.einsum("sec,ecd->sd", combine, expert_out.to(self.dtype))
        return out.reshape(k, n, d).sum(dim=0)


class MoEBlock(nn.Module):
    """Pre-RMSNorm -> MoELayer -> dropout -> residual; returns (out, aux)."""

    def __init__(
        self,
        d_model: int,
        d_ffn: int,
        num_experts: int,
        top_k: int,
        dropout: float = 0.0,
        eps: float = 1e-7,
        double_norm: bool = True,
        dispatch: str = "auto",
        capacity_factor: float = -1.0,
        num_layers: int = 1,
        dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype = torch.float32,
        device=None,
    ):
        super().__init__()
        self.dropout = dropout
        self.norm = RMSNorm(d_model, eps, dtype, param_dtype, device=device)
        self.moe = MoELayer(
            d_model, d_ffn, num_experts, top_k, dropout=dropout, eps=eps,
            double_norm=double_norm, dispatch=dispatch,
            capacity_factor=capacity_factor, num_layers=num_layers, dtype=dtype,
            param_dtype=param_dtype, device=device,
        )

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.norm.weight.fill_(1.0)
        self.moe.reset_parameters(generator)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                dropout_seed: Optional[int] = None, layer_idx: int = 0) -> Tuple:
        out, aux = self.moe(self.norm(x), deterministic=deterministic,
                            dropout_seed=dropout_seed, layer_idx=layer_idx)
        out = dropout(out, self.dropout, deterministic=deterministic,
                      seed=dropout_seed, layer=layer_idx, site=SITE_MOE_BLOCK)
        return x + out, aux
