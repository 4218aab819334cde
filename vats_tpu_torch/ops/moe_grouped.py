"""K7: routed-row MoE experts (``csrc/moe_grouped_gemm.cu``).

A lossless MoE layer (every assignment kept) runs its experts over the n·k
routed rows alone, in place of ``[E, n, d]`` buffers that hold every token
for every expert.  The JAX package has no kernel here (its dispatch and
batched matmuls are XLA's); the port's plain version of that dispatch is
``nn/moe.py``'s scatter and sort paths.

  * :func:`route_plan`: a stable sort of the slot-major assignments
    (``s = j * n + t``: slot j of token t) by expert.  Returns counts [E]
    int32, and for each sorted row its token (int32) and routing weight
    (fp32), and ``inv`` [n·k] int32, the row of each assignment.  Rows lie
    expert by expert, each expert's in slot-major order.
  * :func:`gather_rows`: ``x[row_tok]``, the experts' input rows.
  * :func:`moe_grouped_gemm`: K7 over the rows of each expert, as ``counts``
    lays them out.  With ``w_up`` (K7a): ``silu(x W_gate[e]) * (x W_up[e])``
    from the fp32 products, rounded once to x's dtype; with ``row_w`` (K7b):
    ``row_w * (x W_down[e])``, the weight on the fp32 product, rounded once.
  * :func:`combine_rows`: each token's k rows summed in fp32, slot by slot,
    rounded once to y's dtype.
  * :func:`routed_experts`: the four in order (the layer's forward).

Each function launches its kernel on CUDA tensors and runs its plain
version on CPU tensors.  The plain versions hold the kernels' arithmetic
(fp32 products and epilogues, one rounding a stage); the plain grouped GEMM
reads the counts on the host, one product an expert.  :func:`kernel_fits`
says whether the kernels take a layer; ``nn/moe.py`` routes rows on CUDA
only where it does.  ``moe_grouped_gemm.launches`` counts K7's launches (two
a layer forward).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from vats_tpu_torch.ops import kernels
from vats_tpu_torch.utils.profiling import annotate

MAX_EXPERTS = 256
PLAN_MAX_ASSIGNMENTS = 192 * 1024  # the plan's expert ids in one CTA's shared memory


class RoutePlan(NamedTuple):
    counts: torch.Tensor  # [E] int32
    row_tok: torch.Tensor  # [n·k] int32: each row's token
    row_w: torch.Tensor  # [n·k] fp32: each row's routing weight
    inv: torch.Tensor  # [n·k] int32: each slot-major assignment's row


def kernel_fits(dtype: torch.dtype, w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor, assignments: int) -> bool:
    """K7 and its launches take a layer that computes in ``dtype`` over
    these stacked expert weights: bf16, contiguous weights whose widths
    TMA can address (multiples of 8), at most 256 experts, and at most
    ``PLAN_MAX_ASSIGNMENTS`` routed rows (n·k) a call."""
    e, d, f = w_gate.shape
    return (dtype == torch.bfloat16
            and all(w.is_contiguous() for w in (w_gate, w_up, w_down))
            and tuple(w_up.shape) == (e, d, f) and tuple(w_down.shape) == (e, f, d)
            and d % 8 == 0 and f % 8 == 0 and e <= MAX_EXPERTS
            and assignments <= PLAN_MAX_ASSIGNMENTS)


# --- plain versions ---------------------------------------------------------

def route_plan_ref(indices: torch.Tensor, weights: torch.Tensor, n_experts: int) -> RoutePlan:
    n, k = indices.shape
    dev = indices.device
    expert_ids = indices.transpose(0, 1).reshape(n * k)  # slot-major
    order = torch.argsort(expert_ids, stable=True)
    counts = torch.zeros(n_experts, dtype=torch.int64, device=dev)
    counts.scatter_add_(0, expert_ids, torch.ones_like(expert_ids))
    inv = torch.empty_like(order).scatter_(0, order, torch.arange(n * k, device=dev))
    row_w = weights.transpose(0, 1).reshape(n * k).float()[order]
    return RoutePlan(counts.to(torch.int32), (order % n).to(torch.int32), row_w,
                     inv.to(torch.int32))


def moe_grouped_gemm_ref(x: torch.Tensor, counts: torch.Tensor, w: torch.Tensor,
                         w_up: Optional[torch.Tensor] = None,
                         row_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    out = torch.empty((x.shape[0], w.shape[-1]), dtype=x.dtype, device=x.device)
    start = 0
    for e, c in enumerate(counts.tolist()):
        xe = x[start:start + c].float()
        y = xe @ w[e].float()
        if w_up is not None:
            y = F.silu(y) * (xe @ w_up[e].float())
        else:
            y = y * row_w[start:start + c, None]
        out[start:start + c] = y.to(x.dtype)
        start += c
    return out


def combine_rows_ref(y: torch.Tensor, inv: torch.Tensor, n: int, k: int) -> torch.Tensor:
    rows = y[inv.long()].view(k, n, -1)
    acc = rows[0].float()
    for j in range(1, k):
        acc = acc + rows[j].float()
    return acc.to(y.dtype)


# --- kernels ----------------------------------------------------------------

def route_plan(indices: torch.Tensor, weights: torch.Tensor, n_experts: int) -> RoutePlan:
    """``indices`` [n, k] int64 (the router's top-k, rows of any stride),
    ``weights`` [n, k] bf16 or fp32."""
    if not indices.is_cuda:
        return route_plan_ref(indices, weights, n_experts)
    n, k = indices.shape
    kernels.require(indices.dtype == torch.int64 and indices.stride(1) == 1,
                    "indices must be int64 with a unit last stride")
    kernels.require(weights.dtype in (torch.bfloat16, torch.float32)
                    and weights.stride(1) == 1 and tuple(weights.shape) == (n, k),
                    "weights must be [n, k] bf16 or fp32 with a unit last stride")
    kernels.require(0 < n_experts <= MAX_EXPERTS and n * k <= PLAN_MAX_ASSIGNMENTS,
                    f"{n_experts} experts or {n * k} assignments beyond the plan")
    dev = indices.device
    counts = torch.empty(n_experts, dtype=torch.int32, device=dev)
    row_tok = torch.empty(n * k, dtype=torch.int32, device=dev)
    row_w = torch.empty(n * k, dtype=torch.float32, device=dev)
    inv = torch.empty(n * k, dtype=torch.int32, device=dev)
    lib = _lib()
    rc = lib.vats_moe_route_plan(
        kernels.ptr(indices), indices.stride(0), kernels.ptr(weights), weights.stride(0),
        int(weights.dtype == torch.bfloat16), n, k, n_experts, kernels.ptr(counts),
        kernels.ptr(row_tok), kernels.ptr(row_w), kernels.ptr(inv), kernels.stream_ptr(indices))
    kernels.check(lib, rc, "route_plan")
    return RoutePlan(counts, row_tok, row_w, inv)


def gather_rows(x: torch.Tensor, row_tok: torch.Tensor) -> torch.Tensor:
    """``x[row_tok]`` for x [n, d] bf16."""
    if not x.is_cuda:
        return x[row_tok.long()]
    kernels.check_cuda_tensor(x, "x", dtype=torch.bfloat16)
    kernels.check_cuda_tensor(row_tok, "row_tok", dtype=torch.int32)
    r, d = row_tok.shape[0], x.shape[1]
    out = torch.empty((r, d), dtype=x.dtype, device=x.device)
    lib = _lib()
    rc = lib.vats_moe_gather_rows(kernels.ptr(x), kernels.ptr(row_tok), kernels.ptr(out), r, d,
                                  kernels.stream_ptr(x))
    kernels.check(lib, rc, "gather_rows")
    return out


def moe_grouped_gemm(x: torch.Tensor, counts: torch.Tensor, w: torch.Tensor,
                     w_up: Optional[torch.Tensor] = None,
                     row_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K7 over x [R, K], its rows expert by expert as ``counts`` [E] says:
    with ``w_up`` (K7a) ``w`` is W_gate [E, K, N] and the result
    ``silu(x W_gate) * (x W_up)``; with ``row_w`` [R] fp32 (K7b) ``w`` is
    W_down and the result ``row_w * (x W_down)``.  [R, N] in x's dtype.
    The kernel takes its tile shape from the rows an expert, R / E."""
    kernels.require((w_up is None) != (row_w is None), "give w_up (K7a) or row_w (K7b)")
    if not x.is_cuda:
        return moe_grouped_gemm_ref(x, counts, w, w_up, row_w)
    r, kd = x.shape
    e, kw, n = w.shape
    kernels.require(kw == kd, f"x's width {kd} is not the weight's {kw}")
    kernels.check_cuda_tensor(x, "x", dtype=torch.bfloat16)
    kernels.check_cuda_tensor(w, "w", dtype=torch.bfloat16)
    kernels.check_cuda_tensor(counts, "counts", dtype=torch.int32, shape=(e,))
    kernels.require(kd % 8 == 0 and n % 8 == 0 and e <= MAX_EXPERTS,
                    f"widths {kd}, {n} not multiples of 8, or {e} experts beyond {MAX_EXPERTS}")
    second = w
    if w_up is not None:
        kernels.check_cuda_tensor(w_up, "w_up", dtype=torch.bfloat16, shape=w.shape)
        second = w_up
    else:
        kernels.check_cuda_tensor(row_w, "row_w", dtype=torch.float32, shape=(r,))
    out = torch.empty((r, n), dtype=x.dtype, device=x.device)
    lib = _lib()
    rc = lib.vats_moe_grouped_gemm(
        kernels.ptr(x), kernels.ptr(w), kernels.ptr(second), kernels.ptr(counts),
        ctypes.c_void_p(None if row_w is None else row_w.data_ptr()), kernels.ptr(out),
        r, kd, n, e, int(w_up is not None), kernels.stream_ptr(x))
    kernels.check(lib, rc, "moe_grouped_gemm")
    kernels.count_launch(moe_grouped_gemm)
    return out


moe_grouped_gemm.launches = 0


def combine_rows(y: torch.Tensor, inv: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """out[t] = sum over j of y[inv[j * n + t]] (fp32, j in order), [n, d]."""
    if not y.is_cuda:
        return combine_rows_ref(y, inv, n, k)
    kernels.check_cuda_tensor(y, "y", dtype=torch.bfloat16)
    kernels.check_cuda_tensor(inv, "inv", dtype=torch.int32, shape=(n * k,))
    d = y.shape[1]
    out = torch.empty((n, d), dtype=y.dtype, device=y.device)
    lib = _lib()
    rc = lib.vats_moe_combine(kernels.ptr(y), kernels.ptr(inv), kernels.ptr(out), n, k, d,
                              kernels.stream_ptr(y))
    kernels.check(lib, rc, "combine_rows")
    return out


def routed_experts(x: torch.Tensor, weights: torch.Tensor, indices: torch.Tensor,
                   w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """The experts of a lossless layer over x [n, d]: ``weights`` and
    ``indices`` [n, k] from the router, stacked weights [E, d, f] and
    [E, f, d].  Spans: ``moe.dispatch`` (plan and gather), ``moe.experts``
    (K7a, K7b), ``moe.combine``."""
    n, k = indices.shape
    with annotate("moe.dispatch"):
        plan = route_plan(indices, weights, w_gate.shape[0])
        rows = gather_rows(x, plan.row_tok)
    with annotate("moe.experts"):
        h = moe_grouped_gemm(rows, plan.counts, w_gate, w_up=w_up)
        y = moe_grouped_gemm(h, plan.counts, w_down, row_w=plan.row_w)
    with annotate("moe.combine"):
        return combine_rows(y, plan.inv, n, k)


def _lib() -> ctypes.CDLL:
    lib = kernels.load("moe_grouped_gemm")
    if not getattr(lib, "_vats_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.vats_moe_route_plan.argtypes = [vp, i, vp, i, i, i, i, i, vp, vp, vp, vp, vp]
        lib.vats_moe_gather_rows.argtypes = [vp, vp, vp, i, i, vp]
        lib.vats_moe_grouped_gemm.argtypes = [vp] * 6 + [i] * 5 + [vp]
        lib.vats_moe_combine.argtypes = [vp, vp, vp, i, i, i, vp]
        for fn in (lib.vats_moe_route_plan, lib.vats_moe_gather_rows, lib.vats_moe_grouped_gemm,
                   lib.vats_moe_combine):
            fn.restype = ctypes.c_int
        lib._vats_typed = True
    return lib
