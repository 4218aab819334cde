"""K6: paged tail-prefill attention (``csrc/paged_prefill_attention.cu``).

A prefill into a paged cache that holds history (a serving engine's prompt
tails, with or without prefix hits; a speculative verify window; the
row-chunked and multimodal prefills) attends, row by row, the row's cached
tokens and its own window, after ``PagedKVCache.append_tokens`` has written
the window into the pages.  The JAX package gathers every page of the table
into a dense buffer and leaves the masked attention to XLA; there is no TPU
kernel to port.

  * :func:`paged_prefill_attention_ref`: that gather and
    ``cached_decode_attention`` (fp32 scores and softmax over all
    ``pages_per_seq * page_size`` slots of each row, int8 pages dequantized
    into bf16), the plain version.
  * :func:`paged_prefill_attention`: K6 on CUDA tensors, the plain version
    on CPU tensors; it takes bf16 pools whose stored head dim
    :func:`kernel_fits`, and raises on any other.  The kernel reads only the
    pages that hold keys some query may attend, rounds p to bf16 before
    P V (K2's arithmetic), and writes 0 for a query that attends no key
    (the plain version's softmax over nothing is the mean of every slot's
    V; the serving engine's scratch rows keep key 0 valid, so none of its
    queries is such a one).

The attention (``nn/attention.py``) takes K6 where :func:`kernel_fits` holds
for the pool and the plain version elsewhere (int8 pools, head dims the
kernel has no width for).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from vats_tpu_torch.ops import kernels
from vats_tpu_torch.ops.attention_ref import cached_decode_attention
from vats_tpu_torch.ops.decode_attention import PagedKVCache


def kernel_fits(kv_pages: torch.Tensor) -> bool:
    """K6 reads this pool: bf16, a stored head dim that is a whole number of
    wgmma steps (16) and at most the kernel's widest tile (128)."""
    hdp = kv_pages.shape[-1]
    return kv_pages.dtype == torch.bfloat16 and hdp % 16 == 0 and hdp <= 128


def paged_prefill_attention_ref(
    q: torch.Tensor,
    kv_pages: torch.Tensor,
    layer_idx: int,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: float,
    window_mask: Optional[torch.Tensor] = None,
    left_window: int = -1,
    kv_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version: q [B, T, Hq, hd_pad] (padded to the pool's head dim)
    against one layer of the full pool [L, P, 2, G, ps, hd_pad] through
    ``page_table`` [B, pps]; query i of row b at position ``lengths[b] +
    i``; the window [lengths[b], lengths[b] + T) already appended, its
    [B, T] ``window_mask`` (None: all valid) masking keys; int8 pools pass
    ``kv_scales``.  Returns [B, T, Hq, hd_pad] in q's dtype."""
    t = q.shape[1]
    dev = q.device
    k_buf, v_buf = PagedKVCache(kv_pages, page_table, lengths, kv_scales).gather_dense_t(
        layer_idx)
    s = k_buf.shape[-1]
    buf_pos = torch.arange(s, device=dev)[None, :]
    kv_valid = buf_pos < (lengths + t)[:, None]
    if window_mask is not None:
        in_window = (buf_pos >= lengths[:, None]) & kv_valid
        rel = torch.clamp(buf_pos - lengths[:, None], 0, t - 1)
        window_valid = torch.gather(window_mask.bool(), 1, rel)
        kv_valid = kv_valid & torch.where(in_window, window_valid, True)
    return cached_decode_attention(
        q, k_buf, v_buf, scale=scale, causal=True, left_window=left_window,
        q_positions=lengths[:, None] + torch.arange(t, device=dev)[None, :],
        kv_positions=torch.arange(s, device=dev), kv_valid=kv_valid,
    )


def paged_prefill_attention(
    q: torch.Tensor,
    kv_pages: torch.Tensor,
    layer_idx: int,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: float,
    window_mask: Optional[torch.Tensor] = None,
    left_window: int = -1,
) -> torch.Tensor:
    """K6: the arguments of :func:`paged_prefill_attention_ref` over a bf16
    pool that :func:`kernel_fits` (q bf16 and contiguous; ``window_mask``
    bool).  Launches the kernel on CUDA tensors, runs the plain version on
    CPU tensors."""
    kernels.require(kernel_fits(kv_pages),
                    f"K6 takes bf16 pools with a stored head dim that is a multiple of "
                    f"16 up to 128, not {kv_pages.dtype} at {kv_pages.shape[-1]}")
    if not q.is_cuda:
        return paged_prefill_attention_ref(
            q, kv_pages, layer_idx, page_table, lengths, scale=scale,
            window_mask=window_mask, left_window=left_window)
    b, t, hq, hdp = q.shape
    nl, p, _, g, ps, _ = kv_pages.shape
    pps = page_table.shape[1]
    kernels.require(hdp == kv_pages.shape[-1],
                    f"q's head dim {hdp} is not the pool's {kv_pages.shape[-1]}")
    kernels.require(hq % g == 0 and hq // g <= 64,
                    f"{hq} query heads do not fold into {g} groups of at most 64")
    kernels.require(ps % 128 == 0, f"page_size {ps} is not a multiple of 128")
    kernels.require(b <= 65535 and g <= 65535, f"batch {b} or {g} groups beyond the grid")
    kernels.require(0 <= layer_idx < nl, f"layer {layer_idx} out of range")
    kernels.check_cuda_tensor(q, "q", dtype=torch.bfloat16)
    kernels.check_cuda_tensor(kv_pages, "kv_pages")
    kernels.require(kv_pages.data_ptr() % 16 == 0, "kv_pages must be 16-byte aligned")
    kernels.check_cuda_tensor(page_table, "page_table", dtype=torch.int32,
                              shape=(b, pps))
    kernels.check_cuda_tensor(lengths, "lengths", dtype=torch.int32, shape=(b,))
    mask_ptr = ctypes.c_void_p(None)
    if window_mask is not None:
        kernels.check_cuda_tensor(window_mask, "window_mask", dtype=torch.bool,
                                  shape=(b, t))
        mask_ptr = kernels.ptr(window_mask)
    out = torch.empty_like(q)
    lib = _lib()
    rc = lib.vats_paged_prefill_bf16(
        kernels.ptr(q), kernels.ptr(kv_pages), kernels.ptr(page_table),
        kernels.ptr(lengths), mask_ptr, kernels.ptr(out), b, t, hq, g, hdp, nl, p, ps,
        pps, layer_idx, left_window, ctypes.c_float(scale), kernels.stream_ptr(q),
    )
    kernels.check(lib, rc, "paged_prefill_attention")
    kernels.count_launch(paged_prefill_attention)
    return out


paged_prefill_attention.launches = 0


def _lib() -> ctypes.CDLL:
    lib = kernels.load("paged_prefill_attention")
    fn = lib.vats_paged_prefill_bf16
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_float,
                                                                  ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
