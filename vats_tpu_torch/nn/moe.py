"""Mixture-of-Experts: top-k router + expert dispatch.

Counterpart of ``vats_tpu/nn/moe.py``:
  * ``TopKRouter``: linear d_model -> E in fp32, softmax, top-k, weights
    renormalized by their sum; coefficient-of-variation aux loss in training.
    (Port-only option for DeepSeek-style routers: ``norm_topk_prob=False``
    keeps the top-k probabilities as they are; the default is the JAX
    package's rule.)
  * ``ExpertSwiGLU``: one stacked parameter set ``[E, ...]``.
  * ``MoELayer``: optional RMSNorm (the reference's double pre-norm), route,
    dispatch, combine.  Three dispatch modes, chosen under 'auto' exactly as
    the JAX package chooses them: 'dense' (every expert on every token),
    'scatter' (one-hot capacity dispatch) and 'sort' (stable argsort by
    expert).  The capacity formula and the slot-major token priority are
    the JAX package's, so the same tokens are dropped; capacity depends on
    the token count of each call, so a row-chunked prefill drops what the
    JAX row-chunked prefill drops.
  * A fourth mode, 'routed', which 'auto' resolves to for a call that keeps
    every assignment and needs no gradient: a lossless layer
    (``capacity_factor <= 0``) on one rank (experts unsharded, tokens not
    split over ranks) with autograd off, on CPU tensors or where K7 takes
    the layer (``ops/moe_grouped.kernel_fits``).  The experts then run over
    the n·k routed rows alone (``ops/moe_grouped.routed_experts``: a stable
    sort by expert with the counts on the device, K7's grouped products,
    each token's k rows summed in fp32), not over ``[E, n, d]`` buffers
    that hold every token for every expert.  Router, kept assignments and
    weights are the other modes'; the sums run in another order and round
    once (fp32 SwiGLU and combine).  ``mode_calls`` counts the resolved mode
    of each eager forward or capture.
  * Shared experts (port-only, ``shared_d_ffn`` > 0): one SwiGLU
    (``nn/activations.SwiGLU``) of that width over every token of the
    layer's input, added to the routed experts' output (DeepSeek's
    ``n_shared_experts`` x ``moe_intermediate_size``); span ``moe.shared``.
  * ``MoEBlock``: pre-RMSNorm -> MoELayer -> dropout -> residual.

Sharded (``parallel/layout.py``, under ``parallel/sharded.py``'s step), the
layer computes what the JAX layer computes over the global batch:

  * capacity and 'auto' are resolved from the global token count (the
    local count times the ranks over data x fsdp x seq when each rank holds
    its shard of the batch), and the router's expert mass for the aux loss
    is summed over every rank that routed a share of the tokens;
  * an assignment is kept where its position in the global slot-major
    order (slot, batch row, sequence position) is below the capacity: the
    ranks all-gather their expert ids (a few bytes a token), so each rank
    reads the same global positions and keeps its own assignments (both
    dispatch paths drop the same ones);
  * with the experts sharded over ``expert`` (E/ep a rank) the ranks along
    ``expert``, which hold the same tokens, each route 1/ep of them; the
    kept rows travel to their expert's rank and back by a fixed-size
    all_to_all of ``[E, S, d]`` buffers (S = min(capacity, tokens a rank),
    the same on every rank; expert weights never travel), and the outputs
    are all-gathered over ``expert``.  'dense' runs the rank's own experts
    on every token and all-reduces their weighted sum over ``expert``;
  * ``expert_mlp`` over ``tensor`` makes the experts column-parallel in and
    row-parallel out, and ``embed`` over ``fsdp`` is gathered on use.

Spans (``utils/profiling.annotate``) of the single-rank paths:
``moe.route`` (the router), and in every dispatch ``moe.dispatch``
(positions, the one-hots or the sort, the gather into the experts'
buffers or rows), ``moe.experts`` and ``moe.combine`` (the weighted combine
and the sum over slots).  Autograd launches the backward outside them; a remat
recompute opens them again inside it.

``record_routing = True`` keeps, after each forward, the global expert ids,
the keep mask and the router's probabilities (``routing``), for tests and
the card's checks.  The record is a Python attribute, which a CUDA graph's
replay cannot update: a train step captured from such a model refuses
(``train/step_graphs.TrainGraphs``) unless it runs eagerly.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vats_tpu_torch.nn.activations import SwiGLU
from vats_tpu_torch.nn.dropout import SITE_MOE_BLOCK, SITE_MOE_LAYER, Seed, dropout
from vats_tpu_torch.nn.initializers import input_proj_init_, output_proj_init_
from vats_tpu_torch.nn.norms import RMSNorm
from vats_tpu_torch.ops import moe_grouped
from vats_tpu_torch.parallel.collectives import (
    all_gather,
    all_to_all,
    copy_to,
    gather,
    global_sum,
    split,
)
from vats_tpu_torch.parallel.layout import TENSOR_LOCAL, gathered, split_over
from vats_tpu_torch.parallel.mesh import MESH_AXES, TOKEN_AXES, sharded_token_mesh
from vats_tpu_torch.utils.profiling import annotate


def _mesh_order(axes):
    return tuple(a for a in MESH_AXES if a in axes)


def _sorted_positions(expert_ids: torch.Tensor, n_experts: int):
    """(order, sorted ids, each sorted assignment's position among its
    expert's): the sort is stable, so positions follow the slot-major
    order.  The per-expert counts need no host sync (bincount reads the
    largest id back to size its output), so a captured decode step may
    sort."""
    order = torch.argsort(expert_ids, stable=True)
    sorted_ids = expert_ids[order]
    counts = torch.zeros(n_experts, dtype=torch.int64, device=expert_ids.device)
    counts.scatter_add_(0, expert_ids, torch.ones_like(expert_ids))
    starts = torch.cumsum(counts, 0) - counts
    return order, sorted_ids, torch.arange(len(expert_ids), device=expert_ids.device) \
        - starts[sorted_ids]


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
        norm_topk_prob: bool = True,
    ):
        super().__init__()
        self.num_experts = num_experts
        self.top_k = top_k
        self.use_aux_loss = use_aux_loss
        self.num_layers = num_layers
        self.dtype = dtype
        self.norm_topk_prob = norm_topk_prob
        self.router = nn.Linear(
            d_model, num_experts, bias=True, dtype=param_dtype, device=device
        )
        self.record = False  # keep the last probabilities (MoELayer.record_routing)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        r = self.router
        input_proj_init_(
            r.weight, self.num_layers, (r.in_features, r.out_features), generator
        )
        with torch.no_grad():
            r.bias.zero_()

    def param_logical_axes(self):
        return {"router.weight": ("experts", "embed")}

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                token_split: bool = False):
        """x: [N, d] -> (weights [N, k], indices [N, k], aux_loss []).

        ``token_split``: the ranks along ``expert`` each route their own
        share of tokens that they all hold (``MoELayer``), so the weight's
        and the bias's gradients are summed over them."""
        emesh, _ = split_over(self.router.weight, "expert")
        weight = gathered(self.router.weight, reduce=("expert",) if token_split else ())
        bias = self.router.bias
        if token_split:
            bias = copy_to(bias, emesh, ("expert",))
        logits = F.linear(x.float(), weight.float(), bias.float())
        probs = torch.softmax(logits, dim=-1)
        if self.record:
            self.last_probs = probs.detach()
        # lax.top_k's choice and order: of equal probabilities the lower
        # expert first (torch.topk's among ties is unspecified, and differs)
        top_vals, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        top_vals, top_idx = top_vals[:, :self.top_k], top_idx[:, :self.top_k]
        weights = top_vals
        if self.norm_topk_prob:
            weights = top_vals / top_vals.sum(dim=-1, keepdim=True)
        aux_loss = torch.zeros((), dtype=torch.float32, device=x.device)
        if self.use_aux_loss and not deterministic and self.num_experts > 1:
            mass = probs.sum(dim=0)
            # the JAX step's mass is over the global tokens
            mesh, axes = sharded_token_mesh(), ()
            if mesh is not None:
                axes = TOKEN_AXES
            if token_split:
                mesh, axes = emesh, axes + ("expert",)
            if axes:
                mass = global_sum(mass, mesh, _mesh_order(axes))
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

    def param_logical_axes(self):
        return {"w_gate": ("experts", "embed", "expert_mlp"),
                "w_up": ("experts", "embed", "expert_mlp"),
                "w_down": ("experts", "expert_mlp", "embed")}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [E, C, d] per-expert token buffers -> [E, C, d] (E: this
        rank's experts when they are sharded over ``expert``)."""
        dt = self.dtype
        keep = ("experts",) + TENSOR_LOCAL
        w_gate, w_up, w_down = (gathered(w, keep) for w in (self.w_gate, self.w_up,
                                                             self.w_down))
        mesh, tp = split_over(self.w_gate, "tensor")
        x = x.to(dt)
        if tp > 1:  # column-parallel in, row-parallel out
            x = copy_to(x, mesh, ("tensor",))
        gate = torch.bmm(x, w_gate.to(dt))
        up = torch.bmm(x, w_up.to(dt))
        out = torch.bmm(F.silu(gate) * up, w_down.to(dt))
        if tp > 1:  # the partial products summed in fp32
            out = global_sum(out.float(), mesh, ("tensor",)).to(dt)
        return out


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
        shared_d_ffn: int = 0,
        norm_topk_prob: bool = True,
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
            param_dtype=param_dtype, device=device, norm_topk_prob=norm_topk_prob,
        )
        self.experts = ExpertSwiGLU(
            d_model, d_ffn, num_experts, num_layers=num_layers, dtype=dtype,
            param_dtype=param_dtype, device=device,
        )
        self.shared = (SwiGLU(d_model, shared_d_ffn, num_layers=num_layers, dtype=dtype,
                              param_dtype=param_dtype, device=device)
                       if shared_d_ffn > 0 else None)
        self.routing = None  # see record_routing
        self.mode_calls = {}  # resolved mode -> eager forwards and captures

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        if self.norm is not None:
            with torch.no_grad():
                self.norm.weight.fill_(1.0)
        self.router.reset_parameters(generator)
        self.experts.reset_parameters(generator)
        if self.shared is not None:
            self.shared.reset_parameters(generator)

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

    def resolve_mode(self, n: int, x: torch.Tensor, ep: int = 1, tok=None) -> str:
        """The mode a call over ``n`` (global) tokens ``x`` [n_local, d] runs:
        'routed' where 'auto' may route rows (lossless, one rank, no
        autograd, and CPU tensors or a layer K7 takes), else
        :meth:`dispatch_mode`."""
        w = self.experts
        if (self.dispatch == "auto" and self.capacity_factor <= 0 and ep == 1
                and tok is None and not torch.is_grad_enabled()
                and all(getattr(p, "shard_info", None) is None
                        for p in (w.w_gate, w.w_up, w.w_down))
                and (not x.is_cuda or moe_grouped.kernel_fits(
                    self.dtype, w.w_gate, w.w_up, w.w_down, x.shape[0] * self.top_k))):
            return "routed"
        return self.dispatch_mode(n)

    @property
    def record_routing(self) -> bool:
        return self.router.record

    @record_routing.setter
    def record_routing(self, on: bool) -> None:
        self.router.record = bool(on)
        self.routing = None

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                dropout_seed: Optional[Seed] = None, layer_idx: int = 0):
        b, t, d = x.shape
        if self.norm is not None:
            x = self.norm(x)
        n = b * t
        flat = x.reshape(n, d)
        tok = sharded_token_mesh()
        n_global = n * (tok.axis_size(TOKEN_AXES) if tok is not None else 1)
        capacity = self._capacity(n_global)
        emesh, ep = split_over(self.experts.w_gate, "expert")
        mode = self.resolve_mode(n_global, flat, ep, tok)
        self.mode_calls[mode] = self.mode_calls.get(mode, 0) + 1
        lossless = self.capacity_factor <= 0
        if mode == "routed":
            with annotate("moe.route"):
                weights, indices, aux_loss = self.router(flat, deterministic=deterministic)
            dt = self.dtype
            out = moe_grouped.routed_experts(
                flat.to(dt), weights, indices,
                *(w.to(dt) for w in (self.experts.w_gate, self.experts.w_up,
                                     self.experts.w_down)))
            if self.record_routing:
                self.routing = dict(experts=indices,
                                    keep=torch.ones((self.top_k, n), dtype=torch.bool,
                                                    device=flat.device),
                                    probs=self.router.last_probs)
        elif mode == "dense":
            out, aux_loss = self._dense(flat, deterministic, emesh, ep)
        elif ep == 1 and (tok is None or lossless):
            # every kept assignment is decided by this rank's tokens alone
            with annotate("moe.route"):
                weights, indices, aux_loss = self.router(flat, deterministic=deterministic)
            dispatch = self._sort_dispatch if mode == "sort" else self._scatter_dispatch
            out, keep = dispatch(flat, weights, indices, self._capacity(n), self.experts)
            if self.record_routing:
                self.routing = dict(experts=indices, keep=keep.reshape(self.top_k, n),
                                    probs=self.router.last_probs)
        else:
            out, aux_loss = self._parallel_dispatch(mode, flat, deterministic, capacity,
                                                    tok, emesh, ep, b, t)
        if self.shared is not None:
            with annotate("moe.shared"):
                out = out.to(self.dtype) + self.shared(flat)
        out = out.reshape(b, t, d)
        out = dropout(out, self.dropout, deterministic=deterministic,
                      seed=dropout_seed, layer=layer_idx, site=SITE_MOE_LAYER)
        return out.to(self.dtype), aux_loss

    def _dense(self, flat, deterministic, emesh, ep):
        """Every (local) expert on every token, combined by the router's
        weights; with the experts over ``expert`` each rank runs its own and
        the weighted sums are all-reduced."""
        n, d = flat.shape
        weights, indices, aux_loss = self.router(flat, deterministic=deterministic)
        combine = torch.zeros(n, self.num_experts, dtype=weights.dtype, device=flat.device)
        combine.scatter_add_(1, indices, weights)
        e_local = self.num_experts // ep
        if ep > 1:
            first = emesh.axis_index("expert") * e_local
            combine = copy_to(combine, emesh, ("expert",))[:, first:first + e_local]
            flat = copy_to(flat, emesh, ("expert",))
        all_out = self.experts(flat.expand(e_local, n, d))
        out = torch.einsum("ne,end->nd", combine.to(all_out.dtype), all_out)
        if ep > 1:
            out = global_sum(out, emesh, ("expert",))
        return out, aux_loss

    def _parallel_dispatch(self, mode, flat, deterministic, capacity, tok, emesh, ep, b, t):
        """Capacity from the global tokens, and (ep > 1) the expert
        exchange: this rank's 1/ep of the tokens routed, its kept rows sent
        to their experts' ranks in ``[E, S, d]`` buffers and back, the
        outputs all-gathered over ``expert``."""
        x = split(flat, emesh, "expert", 0) if ep > 1 else flat
        ns = x.shape[0]
        weights, indices, aux_loss = self.router(x, deterministic=deterministic,
                                                 token_split=ep > 1)
        keep = None
        if self.capacity_factor > 0 or self.record_routing:
            ids = self._to_global(indices, tok, emesh, ep, b, t)  # [N, k]
            keep_g = self._global_keep(ids, capacity)  # [k, N] slot-major
            if self.capacity_factor > 0:
                mine = self._global_index(tok, emesh, ep, b, t, ns, x.device)
                keep = keep_g[:, mine].transpose(0, 1)  # [ns, k]
            if self.record_routing:
                self.routing = dict(experts=ids, keep=keep_g, probs=self._to_global(
                    self.router.last_probs, tok, emesh, ep, b, t))

        def exchange(buf):  # [E, S, d] -> [E, S, d]
            if ep > 1:
                buf = all_to_all(buf, emesh, "expert", 0, 1)  # [E/ep, ep * S, d]
            out = self.experts(buf)
            return all_to_all(out, emesh, "expert", 1, 0) if ep > 1 else out

        dispatch = self._sort_dispatch if mode == "sort" else self._scatter_dispatch
        out, _ = dispatch(x, weights, indices, min(capacity, ns), exchange, keep)
        if ep > 1:
            out = gather(out, emesh, "expert", 0, reduce=False)
        return out, aux_loss

    @staticmethod
    def _token_axes(tok, ep):
        return _mesh_order((TOKEN_AXES if tok is not None else ()) + (("expert",) if ep > 1
                                                                       else ()))

    def _to_global(self, x, tok, emesh, ep, b, t):
        """A per-token tensor of this rank's tokens ([ns, ...]) as the
        global batch's ([N, ...], rows then positions), on every rank:
        all-gathered over the axes that split the tokens."""
        mesh = tok if tok is not None else emesh
        axes = self._token_axes(tok, ep)
        if not axes:
            return x
        g = all_gather(x.contiguous(), mesh, axes, 0)
        size = lambda a: mesh.shape[a] if a in axes else 1  # noqa: E731
        rows, seq = size("data") * size("fsdp"), size("seq")
        # gathered in mesh order: [data x fsdp, expert, seq, ns, ...]; a rank's
        # expert shares cut its [b, t] block row-major
        g = g.reshape(rows, size("expert"), seq, -1, *x.shape[1:]).transpose(1, 2)
        g = g.reshape(rows, seq, b, t, *x.shape[1:]).transpose(1, 2)
        return g.reshape(rows * b * seq * t, *x.shape[1:])

    def _global_index(self, tok, emesh, ep, b, t, ns, device):
        """The global token index of each of this rank's ``ns`` tokens."""
        mesh = tok if tok is not None else emesh
        c = mesh.coords()
        shard = lambda a, on: c[a] if on else 0  # noqa: E731
        on = tok is not None
        row0 = (shard("data", on) * mesh.shape["fsdp"] + shard("fsdp", on)) * b
        seq = mesh.shape["seq"] if on else 1
        i = shard("expert", ep > 1) * ns + torch.arange(ns, device=device)
        return (row0 + i // t) * (seq * t) + shard("seq", on) * t + i % t

    def _global_keep(self, ids, capacity):
        """[k, N] bool: an assignment of the global slot-major order kept
        where fewer than ``capacity`` earlier ones went to its expert."""
        n, k = ids.shape
        order, _, sorted_pos = _sorted_positions(ids.transpose(0, 1).reshape(n * k),
                                                 self.num_experts)
        pos = torch.empty_like(sorted_pos).scatter_(0, order, sorted_pos)
        return (pos < capacity).reshape(k, n)

    def _sort_dispatch(self, flat, weights, indices, capacity, experts, keep=None):
        """Stable sort by expert; rank within an expert is the slot-major
        one-hot cumsum position, so both capacity paths drop the same
        assignments.  ``keep`` [N, k]: the assignments kept (the rest are
        dropped before positions are counted).  Returns (out, kept [N*k],
        slot-major)."""
        n, d = flat.shape
        e, k = self.num_experts, self.top_k
        nk = n * k
        dev = flat.device
        with annotate("moe.dispatch"):
            expert_ids = indices.transpose(0, 1).reshape(nk)  # slot-major
            if keep is not None:  # dropped assignments sort last, as expert e
                expert_ids = torch.where(keep.transpose(0, 1).reshape(nk), expert_ids, e)
            token_ids = torch.arange(n, device=dev).repeat(k)
            sort_idx, sorted_experts, pos = _sorted_positions(expert_ids, e + 1)
            kept = (pos < capacity) & (sorted_experts < e)
            dest = torch.where(kept, sorted_experts * capacity + pos, e * capacity)
            gathered_in = flat[token_ids[sort_idx]].to(self.dtype)
            buf = torch.zeros(e * capacity + 1, d, dtype=self.dtype, device=dev)
            buf[dest] = gathered_in  # overflow rows all land in the trash row
        with annotate("moe.experts"):
            expert_out = experts(buf[: e * capacity].reshape(e, capacity, d))
        with annotate("moe.combine"):
            w_flat = weights.transpose(0, 1).reshape(nk).to(self.dtype)
            flat_out = torch.cat(
                [expert_out.reshape(e * capacity, d),
                 torch.zeros(1, d, dtype=expert_out.dtype, device=dev)]
            )
            out_sorted = flat_out[dest] * w_flat[sort_idx][:, None]
            out = torch.zeros(n, d, dtype=self.dtype, device=dev)
            out = out.index_add_(0, token_ids[sort_idx], out_sorted.to(self.dtype))
        if not self.record_routing:
            return out, None
        return out, torch.zeros_like(kept).scatter_(0, sort_idx, kept)

    def _scatter_dispatch(self, flat, weights, indices, capacity, experts, keep=None):
        """GShard-style static capacity dispatch via one-hot einsums
        (``keep`` and the result as in :meth:`_sort_dispatch`)."""
        n, d = flat.shape
        e, k = self.num_experts, self.top_k
        with annotate("moe.dispatch"):
            assign = F.one_hot(indices, e)  # [N, k, E] int64
            flat_assign = assign.transpose(0, 1).reshape(n * k, e)  # slot-major
            if keep is not None:
                kept_in = keep.transpose(0, 1).reshape(n * k)
                flat_assign = flat_assign * kept_in[:, None]
            pos_in_expert = torch.cumsum(flat_assign, 0) - flat_assign
            pos = (pos_in_expert * flat_assign).sum(dim=-1)  # [N*k]
            kept = pos < capacity
            if keep is not None:
                kept = kept & kept_in
            pos_oh = F.one_hot(torch.clamp(pos, max=capacity - 1), capacity)
            dispatch = (
                flat_assign[:, :, None] * pos_oh[:, None, :] * kept[:, None, None]
            ).to(self.dtype)  # [N*k, E, C]
            x_rep = flat.repeat(k, 1).to(self.dtype)
            expert_in = torch.einsum("sec,sd->ecd", dispatch, x_rep)
        with annotate("moe.experts"):
            expert_out = experts(expert_in)
        with annotate("moe.combine"):
            w_flat = weights.transpose(0, 1).reshape(n * k)
            combine = dispatch * w_flat[:, None, None].to(self.dtype)
            out = torch.einsum("sec,ecd->sd", combine, expert_out.to(self.dtype))
            return out.reshape(k, n, d).sum(dim=0), kept


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
        **router_and_shared,
    ):
        super().__init__()
        self.dropout = dropout
        self.norm = RMSNorm(d_model, eps, dtype, param_dtype, device=device)
        self.moe = MoELayer(
            d_model, d_ffn, num_experts, top_k, dropout=dropout, eps=eps,
            double_norm=double_norm, dispatch=dispatch,
            capacity_factor=capacity_factor, num_layers=num_layers, dtype=dtype,
            param_dtype=param_dtype, device=device, **router_and_shared,
        )

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.norm.weight.fill_(1.0)
        self.moe.reset_parameters(generator)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                dropout_seed: Optional[Seed] = None, layer_idx: int = 0) -> Tuple:
        out, aux = self.moe(self.norm(x), deterministic=deterministic,
                            dropout_seed=dropout_seed, layer_idx=layer_idx)
        out = dropout(out, self.dropout, deterministic=deterministic,
                      seed=dropout_seed, layer=layer_idx, site=SITE_MOE_BLOCK)
        return x + out, aux
