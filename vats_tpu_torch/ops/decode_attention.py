"""Paged KV cache + the paged decode attention kernel with commit (K1, K4).

Counterpart of ``vats_tpu/ops/decode_attention.py``.

  * :class:`PagedKVCache`: K and V share ONE pool of pages
    ``[layers, num_pages, 2, kv_heads, page_size, head_dim_pad]``.  This is
    the port's own layout: head-dim minor, with head_dim zero-padded to a
    whole number of 16-byte vectors (8 elements for bf16/fp32 pools, 60 ->
    64; 16 for int8 pools), so one 128-token tile of one (page, K or V,
    group) is one contiguous block for the kernel's bulk copies.  The JAX
    pool is sequence-minor ``[.., head_dim_pad, page_size]`` for the TPU's
    (8, 128) tiling.  The semantics carry over: page tables, the clamp at
    capacity, zero pad rows.  int8 pools carry ``kv_scales``
    ``[layers, num_pages, 2, kv_heads, page_size]`` fp32, one symmetric
    scale per (token, K/V, group) (the JAX scales pad kv_heads to 8 for
    Mosaic; Hopper needs no pad).  The cache is updated in place (the JAX
    one is a functional pytree); methods return ``self`` for call-site
    parity.
  * :func:`paged_decode_attention_commit` (decode hot path): attends the
    paged history plus the current token and writes that token into its
    page, in one launch of ``csrc/decode_attention.cu`` on CUDA tensors --
    K1 for bf16/fp32 pools, K4 (:func:`paged_decode_attention_commit_int8`,
    its own launch count) for int8 pools, which quantizes the committed
    token in the kernel.  The kernel splits each row's history into
    128-token tiles over CTAs and combines them in the same launch; q, the
    current token and the output stay at their logical head dim and dtype.
    :func:`paged_decode_attention` is the same kernel without the commit.
    On CPU tensors every entry runs the plain versions
    (:func:`paged_decode_attention_ref`, :meth:`PagedKVCache.append_token`).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from vats_tpu_torch.ops import kernels

def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, group) symmetric int8 quantization of [..., hd] K or V.

    Returns (int8 values, fp32 scale [...]); dequantized = values * scale.
    The scale floor keeps all-zero vectors at 1e-8/127 (dequant 0).  Both
    divisions are IEEE on every device, as in the JAX package's eager
    ``quantize_kv`` and in K4's commit: the divisor 127 is a tensor because
    PyTorch's CUDA division by a Python scalar multiplies by its reciprocal
    (one ulp off in a few percent of the scales)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=1e-8) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def _pad_head_dim(head_dim: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Stored head dim: zero-padded to whole 16-byte vectors, and to at
    least the 8-element granule (16 bytes of bf16; 16 elements of int8)."""
    granule = max(8, 16 // dtype.itemsize)
    return -(-head_dim // granule) * granule


def _pad_last(x: torch.Tensor, size: int) -> torch.Tensor:
    if x.shape[-1] == size:
        return x
    return torch.nn.functional.pad(x, (0, size - x.shape[-1]))


@dataclass
class PagedKVCache:
    """Paged K/V pool shared by every sequence in the batch."""

    kv_pages: torch.Tensor  # [L, num_pages, 2, G, page_size, hd_pad]
    page_table: torch.Tensor  # [B, pages_per_seq] int32 physical page ids
    lengths: torch.Tensor  # [B] int32 settled tokens per sequence
    # int8 pools: [L, num_pages, 2, G, page_size] fp32 scales; None otherwise
    kv_scales: Optional[torch.Tensor] = None
    head_dim: int = 0  # logical head dim
    # True only between create() and the first append: a fresh-cache prefill
    # attends its own window causally and skips the page gather
    fresh: bool = False

    @classmethod
    def create(
        cls,
        num_layers: int,
        batch_size: int,
        max_seq_len: int,
        kv_heads: int,
        head_dim: int,
        *,
        page_size: int = 128,
        dtype: torch.dtype = torch.bfloat16,
        device=None,
    ) -> "PagedKVCache":
        if page_size % 128 != 0:
            raise ValueError(
                f"page_size ({page_size}) must be a multiple of 128, as in the "
                "JAX package (pages are whole 128-token tiles)"
            )
        pages_per_seq = -(-max_seq_len // page_size)
        num_pages = batch_size * pages_per_seq
        shape = (
            num_layers, num_pages, 2, kv_heads, page_size,
            _pad_head_dim(head_dim, dtype),
        )
        # identity allocation: sequence b owns pages [b*pps, (b+1)*pps)
        table = (
            torch.arange(batch_size, device=device)[:, None] * pages_per_seq
            + torch.arange(pages_per_seq, device=device)[None, :]
        ).to(torch.int32)
        scales = None
        if dtype == torch.int8:
            scales = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
        return cls(
            kv_pages=torch.zeros(shape, dtype=dtype, device=device),
            page_table=table,
            lengths=torch.zeros(batch_size, dtype=torch.int32, device=device),
            kv_scales=scales,
            head_dim=head_dim,
            fresh=True,
        )

    @property
    def quantized(self) -> bool:
        return self.kv_scales is not None

    @property
    def page_size(self) -> int:
        return self.kv_pages.shape[4]

    @property
    def pages_per_seq(self) -> int:
        return self.page_table.shape[1]

    def _stack_kv(self, k_new: torch.Tensor, v_new: torch.Tensor, dim: int):
        """K and V stacked on ``dim`` and padded to the stored head dim, in
        the pool's dtype; int8 pools also return the scales [..., 2, G]."""
        hdp = self.kv_pages.shape[5]
        kv = torch.stack([_pad_last(k_new, hdp), _pad_last(v_new, hdp)], dim=dim)
        if self.quantized:
            return quantize_kv(kv)
        return kv.to(self.kv_pages.dtype), None

    def append_token(
        self, layer_idx: int, k_new: torch.Tensor, v_new: torch.Tensor
    ) -> "PagedKVCache":
        """Write one token's K/V per sequence at its current length (clamped
        at capacity).  k_new/v_new: [B, G, hd].  ``advance`` separately."""
        kv, sc = self._stack_kv(k_new, v_new, dim=1)  # [B, 2, G, hd_pad]
        ps = self.page_size
        pos = torch.clamp(self.lengths.long(), max=self.pages_per_seq * ps - 1)
        phys = torch.gather(self.page_table.long(), 1, (pos // ps)[:, None])[:, 0]
        self.kv_pages[layer_idx][phys, :, :, pos % ps] = kv
        if sc is not None:
            self.kv_scales[layer_idx][phys, :, :, pos % ps] = sc
        self.fresh = False
        return self

    def append_tokens(
        self, layer_idx: int, k_new: torch.Tensor, v_new: torch.Tensor
    ) -> "PagedKVCache":
        """Write T tokens per sequence from its current length (prefill).
        k_new/v_new: [B, T, G, hd].

        A position past the page table (a serving tail prefill padded to its
        bucket) has no page: the JAX scatter drops it; here it lands on the
        row's last slot, which no live token occupies (prompts end below the
        context cap) and which decode overwrites before it is attended.

        Writes may collide: on that last slot, and on the scratch page 0,
        where padding and scratch rows write through unmapped table entries
        (a scratch row of a serving prefill then attends that page's slot
        0).  Every writer of a slot writes the value of the last of them in
        (row, position) order, so the result is a sequential loop's on any
        device: a CUDA scatter with differing values at one address keeps
        whichever write lands last."""
        kv, sc = self._stack_kv(k_new, v_new, dim=2)  # [B, T, 2, G, hd_pad]
        ps = self.page_size
        b, t = k_new.shape[:2]
        dev = kv.device
        pos = self.lengths.long()[:, None] + torch.arange(t, device=dev)
        pos = torch.clamp(pos, max=self.pages_per_seq * ps - 1)
        phys = torch.gather(self.page_table.long(), 1, pos // ps)
        dest = (phys * ps + pos % ps).reshape(-1)
        order = torch.arange(b * t, device=dev)
        last = torch.full((self.kv_pages.shape[1] * ps,), -1, dtype=torch.long, device=dev)
        winner = last.scatter_reduce_(0, dest, order, reduce="amax")[dest]
        kv = kv.reshape(b * t, *kv.shape[2:])[winner].reshape(kv.shape)
        self.kv_pages[layer_idx][phys, :, :, pos % ps] = kv
        if sc is not None:
            sc = sc.reshape(b * t, *sc.shape[2:])[winner].reshape(sc.shape)
            self.kv_scales[layer_idx][phys, :, :, pos % ps] = sc
        self.fresh = False
        return self

    def append_window_pages(
        self, layer_idx: int, k_new: torch.Tensor, v_new: torch.Tensor
    ) -> "PagedKVCache":
        """Fresh-cache prefill append: write the window as whole pages (every
        row at length 0); slots past the window in its last page are zero
        (and their int8 scales 0)."""
        b, t, g, _ = k_new.shape
        ps = self.page_size
        ppu = -(-t // ps)
        kv, sc = self._stack_kv(k_new, v_new, dim=2)  # [B, T, 2, G, hd_pad]
        pad = ppu * ps - t
        if pad:
            kv = torch.nn.functional.pad(kv, (0, 0, 0, 0, 0, 0, 0, pad))
        hdp = kv.shape[-1]
        pages = kv.reshape(b, ppu, ps, 2, g, hdp).permute(0, 1, 3, 4, 2, 5)
        pids = self.page_table[:, :ppu].reshape(-1).long()
        self.kv_pages[layer_idx][pids] = pages.reshape(b * ppu, 2, g, ps, hdp)
        if sc is not None:
            if pad:
                sc = torch.nn.functional.pad(sc, (0, 0, 0, 0, 0, pad))
            sc_pages = sc.reshape(b, ppu, ps, 2, g).permute(0, 1, 3, 4, 2)
            self.kv_scales[layer_idx][pids] = sc_pages.reshape(b * ppu, 2, g, ps)
        self.fresh = False
        return self

    def gather_dense_t(self, layer_idx: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """A layer's pages as the dense cache's sequence-minor views
        ([B, G, hd_pad, S], the layout ``cached_decode_attention`` takes).
        int8 pools are dequantized into bf16 whatever the compute dtype, as
        in the JAX package."""
        table = self.page_table.long()
        kv = self.kv_pages[layer_idx][table]  # [B, pps, 2, G, ps, hdp]
        if self.quantized:
            sc = self.kv_scales[layer_idx][table]  # [B, pps, 2, G, ps]
            kv = (kv.float() * sc[..., None]).to(torch.bfloat16)
        b, pps, _, g, ps, hdp = kv.shape
        kv = kv.permute(2, 0, 3, 5, 1, 4).reshape(2, b, g, hdp, pps * ps)
        return kv[0], kv[1]

    def advance(self, n: int = 1) -> "PagedKVCache":
        """Advance every sequence by ``n``, in place: ``lengths`` keeps its
        storage, so a captured decode step reads and writes the same tensor
        at every replay."""
        self.lengths.add_(n)
        return self

    def advance_by(self, counts: torch.Tensor) -> "PagedKVCache":
        """Per-sequence advance (ragged prefill: each row's true length), in
        place."""
        self.lengths.add_(counts.to(self.lengths.dtype))
        return self


#: tokens a tile: the kernel's unit of work, and the plain version's unit of
#: softmax (pages are whole tiles)
TILE = 128


def paged_decode_attention_ref(
    q: torch.Tensor,
    kv_pages: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: float,
    k_cur: Optional[torch.Tensor] = None,
    v_cur: Optional[torch.Tensor] = None,
    kv_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of K1's and K4's attention: what the kernel computes.

    q [B, Hq, hd]; kv_pages: one layer's pool [P, 2, G, ps, hd_pad];
    ``lengths`` counts settled history (masked at the table's capacity);
    k_cur/v_cur [B, G, hd] add the current token as one extra, always-valid
    column.  bf16/fp32 pools (K1) take q and the current token in pool
    precision.  int8 pools pass ``kv_scales`` [P, 2, G, ps] (K4): the
    history is dequantized (value * scale), and q and the current token
    stay in their own precision, unquantized.

    The history is cut into 128-token tiles.  Each tile takes
    p = exp(s - m_tile), m_tile the max of its valid columns; l sums the
    fp32 p; a bf16 pool rounds p to bf16 for p.v (the JAX kernel's bf16
    P.V operand), fp32 and int8 pools keep it in fp32.  The current token's
    column seeds the softmax in fp32 (m = s_cur, l = 1, o = v_cur), and the
    tiles combine with it through the LSE: M = the max of every m, then l
    and o summed in tile order with weights exp(m - M)."""
    b, hq, hd = q.shape
    _, _, g, ps, hdp = kv_pages.shape
    n = hq // g
    pps = page_table.shape[1]
    nt = pps * ps // TILE
    table = page_table.long()
    gathered = kv_pages[table].float()  # [B, pps, 2, G, ps, hdp]
    if kv_scales is not None:
        gathered = gathered * kv_scales[table][..., None]
        as_input = torch.float32  # q and the current token attend as given
    else:
        as_input = kv_pages.dtype
    kv = gathered.permute(2, 0, 3, 1, 4, 5).reshape(2, b, g, nt, TILE, hdp)
    k_t, v_t = kv[0, ..., :hd], kv[1, ..., :hd]  # [B, G, tiles, TILE, hd]
    valid = torch.arange(pps * ps, device=q.device)[None, :] < lengths[:, None]
    valid = valid.reshape(b, 1, nt, 1, TILE)
    qf = q.to(as_input).float().reshape(b, g, n, hd)
    s = torch.einsum("bgnd,bgtsd->bgtns", qf, k_t) * scale  # [B, G, tiles, N, TILE]
    m_t = torch.where(valid, s, -torch.inf).amax(dim=-1)  # -inf: an empty tile
    p = torch.where(valid, torch.exp(s - m_t[..., None]), 0.0)
    l_t = p.sum(dim=-1)
    if kv_pages.dtype == torch.bfloat16:
        p = p.to(torch.bfloat16).float()
    o_t = torch.einsum("bgtns,bgtsd->bgtnd", p, v_t)
    if k_cur is not None:
        kc = k_cur.to(as_input).float()[:, :, None]  # [B, G, 1, hd]
        m0 = (qf * kc).sum(dim=-1) * scale  # [B, G, N]
        l0 = torch.ones_like(m0)
        o0 = v_cur.to(as_input).float()[:, :, None].expand(b, g, n, hd)
    else:
        m0 = torch.full((b, g, n), -torch.inf, device=q.device)
        l0 = torch.zeros_like(m0)
        o0 = torch.zeros((b, g, n, hd), device=q.device)
    mx = torch.maximum(m0, m_t.amax(dim=2))
    mx = torch.where(torch.isfinite(mx), mx, 0.0)  # nothing to attend
    w0, w_t = torch.exp(m0 - mx), torch.exp(m_t - mx[:, :, None])
    l = w0 * l0 + (w_t * l_t).sum(dim=2)
    o = w0[..., None] * o0 + (w_t[..., None] * o_t).sum(dim=2)
    out = o / torch.where(l == 0, 1.0, l)[..., None]
    return out.reshape(b, hq, hd).to(q.dtype)


def paged_decode_attention(
    q: torch.Tensor,
    kv_pages: torch.Tensor,
    layer_idx: int,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: float,
    k_cur: torch.Tensor,
    v_cur: torch.Tensor,
    kv_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K1 without the commit: attend the history plus the current token,
    write nothing.  kv_pages: the full pool [L, P, 2, G, ps, hd_pad]; int8
    pools pass the full ``kv_scales`` and go to K4
    (:func:`paged_decode_attention_int8`)."""
    if kv_scales is not None:
        return paged_decode_attention_int8(
            q, kv_pages, kv_scales, layer_idx, page_table, lengths, scale=scale,
            k_cur=k_cur, v_cur=v_cur,
        )
    if not q.is_cuda:
        return paged_decode_attention_ref(
            q, kv_pages[layer_idx], page_table, lengths, scale=scale,
            k_cur=k_cur, v_cur=v_cur,
        )
    out = _launch(q, kv_pages, None, layer_idx, page_table, lengths, scale, k_cur,
                  v_cur, commit=False)
    kernels.count_launch(paged_decode_attention)
    return out


def paged_decode_attention_commit(
    q: torch.Tensor,
    kv_pages: torch.Tensor,
    layer_idx: int,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: float,
    k_cur: torch.Tensor,
    v_cur: torch.Tensor,
    kv_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode hot path: attend the paged history plus the current token AND
    write the token into slot ``min(lengths[b], capacity-1)`` of its page.

    q [B, Hq, hd]; kv_pages: the full pool [L, P, 2, G, ps, hd_pad], updated
    in place; k_cur/v_cur [B, G, hd].  Returns the attention [B, Hq, hd].
    int8 pools pass the full ``kv_scales`` (also updated in place) and go to
    K4 (:func:`paged_decode_attention_commit_int8`)."""
    if kv_scales is not None:
        return paged_decode_attention_commit_int8(
            q, kv_pages, kv_scales, layer_idx, page_table, lengths, scale=scale,
            k_cur=k_cur, v_cur=v_cur,
        )
    if not q.is_cuda:
        out = paged_decode_attention_ref(
            q, kv_pages[layer_idx], page_table, lengths, scale=scale,
            k_cur=k_cur, v_cur=v_cur,
        )
        PagedKVCache(kv_pages, page_table, lengths).append_token(
            layer_idx, k_cur, v_cur
        )
        return out
    out = _launch(q, kv_pages, None, layer_idx, page_table, lengths, scale, k_cur,
                  v_cur, commit=True)
    kernels.count_launch(paged_decode_attention_commit)
    return out


def paged_decode_attention_int8(
    q: torch.Tensor,
    kv_pages: torch.Tensor,
    kv_scales: torch.Tensor,
    layer_idx: int,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: float,
    k_cur: torch.Tensor,
    v_cur: torch.Tensor,
) -> torch.Tensor:
    """K4 without the commit, over an int8 pool [L, P, 2, G, ps, hd_pad]
    with its scales [L, P, 2, G, ps]."""
    if not q.is_cuda:
        return paged_decode_attention_ref(
            q, kv_pages[layer_idx], page_table, lengths, scale=scale,
            k_cur=k_cur, v_cur=v_cur, kv_scales=kv_scales[layer_idx],
        )
    out = _launch(q, kv_pages, kv_scales, layer_idx, page_table, lengths, scale,
                  k_cur, v_cur, commit=False)
    kernels.count_launch(paged_decode_attention_int8)
    return out


def paged_decode_attention_commit_int8(
    q: torch.Tensor,
    kv_pages: torch.Tensor,
    kv_scales: torch.Tensor,
    layer_idx: int,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: float,
    k_cur: torch.Tensor,
    v_cur: torch.Tensor,
) -> torch.Tensor:
    """K4, the int8 decode hot path: attend the dequantized history plus the
    current token (unquantized, fp32) and commit the token quantized
    (``quantize_kv``, byte for byte) with its scales, in place."""
    if not q.is_cuda:
        out = paged_decode_attention_ref(
            q, kv_pages[layer_idx], page_table, lengths, scale=scale,
            k_cur=k_cur, v_cur=v_cur, kv_scales=kv_scales[layer_idx],
        )
        PagedKVCache(kv_pages, page_table, lengths, kv_scales).append_token(
            layer_idx, k_cur, v_cur
        )
        return out
    out = _launch(q, kv_pages, kv_scales, layer_idx, page_table, lengths, scale,
                  k_cur, v_cur, commit=True)
    kernels.count_launch(paged_decode_attention_commit_int8)
    return out


paged_decode_attention.launches = 0
paged_decode_attention_commit.launches = 0
paged_decode_attention_int8.launches = 0
paged_decode_attention_commit_int8.launches = 0

#: C entry per pool dtype (the body's storage type); each takes q, the
#: current token and the output in q's dtype, bf16 or fp32
_ENTRY = {
    torch.bfloat16: "vats_paged_decode_bf16",
    torch.float32: "vats_paged_decode_f32",
    torch.int8: "vats_paged_decode_int8",
}

#: per (device, stream): one int32 counter per (row, KV group), zero between
#: calls (the kernel's last CTA of a row resets its own); grown, zeroed, when
#: a call needs more.  Calls on one stream run in its order, so they never
#: share a counter at once; calls on two streams use two buffers.  A CUDA
#: graph captures the buffer of its capture stream, which must exist before
#: the capture (a warm-up call on that stream makes it), and takes it over
#: when the capture ends (:func:`take_counters`).
_COUNTERS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _counters(device: torch.device, n: int) -> torch.Tensor:
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    c = _COUNTERS.get(key)
    if c is None or c.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            # a buffer made here would be a memset replayed from the graph's
            # pool; the warm-up on the capture stream must have made it
            raise RuntimeError(
                "paged decode: no counters of this size for the capturing stream; "
                "run the step once on that stream before capturing it")
        c = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[key] = c
    return c


def take_counters(stream: torch.cuda.Stream) -> Optional[torch.Tensor]:
    """Hand the counters of ``stream`` to a graph just captured on it: the
    graph keeps them alive and alone uses them, at every replay; an eager
    call on that stream later gets a buffer of its own, so it never shares a
    counter with a replay, whatever stream the replay runs on."""
    return _COUNTERS.pop((stream.device, stream.cuda_stream), None)


def _launch(q, kv_pages, kv_scales, layer_idx, page_table, lengths, scale, k_cur,
            v_cur, *, commit: bool) -> torch.Tensor:
    """One launch: checks, the output and the workspace from ``torch.empty``,
    no other kernel."""
    b, hq, hd = q.shape
    l, p, _, g, ps, hdp = kv_pages.shape
    n = hq // g
    pps = page_table.shape[1]
    dt = kv_pages.dtype
    kernels.require(dt in _ENTRY, f"unsupported pool dtype {dt}")
    kernels.require((dt == torch.int8) == (kv_scales is not None),
                    "int8 pools, and only they, need kv_scales")
    kernels.require(q.dtype in (torch.bfloat16, torch.float32),
                    f"q must be bf16 or fp32, got {q.dtype}")
    kernels.require(hq % g == 0, f"{hq} query heads do not fold into {g} groups")
    kernels.require(n <= 8 and hd <= hdp <= 128 and hdp == _pad_head_dim(hdp, dt),
                    f"unsupported head shape: {n} heads/group, head dim {hd} "
                    f"stored as {hdp}")
    kernels.require(ps % TILE == 0, f"page_size {ps} is not a multiple of {TILE}")
    kernels.require(b <= 65535, f"batch {b} beyond the grid")
    kernels.require(0 <= layer_idx < l, f"layer {layer_idx} out of range")
    kernels.check_cuda_tensor(kv_pages, "kv_pages")
    kernels.require(kv_pages.data_ptr() % 16 == 0, "kv_pages must be 16-byte aligned")
    kernels.check_cuda_tensor(page_table, "page_table", dtype=torch.int32,
                              shape=(b, pps))
    kernels.check_cuda_tensor(lengths, "lengths", dtype=torch.int32, shape=(b,))
    for name, t, shape in (("q", q, (b, hq, hd)), ("k_cur", k_cur, (b, g, hd)),
                           ("v_cur", v_cur, (b, g, hd))):
        kernels.check_cuda_tensor(t, name, dtype=q.dtype, shape=shape, strided=True)
    sc_ptr = ctypes.c_void_p(None)
    if kv_scales is not None:
        kernels.check_cuda_tensor(kv_scales, "kv_scales", dtype=torch.float32,
                                  shape=(l, p, 2, g, ps))
        sc_ptr = kernels.ptr(kv_scales)
    out = torch.empty((b, hq, hd), dtype=q.dtype, device=q.device)
    # per (row, group, tile, head): m, l and o[hd_pad], fp32
    work = torch.empty(b * g * (pps * ps // TILE) * n * (hdp + 2), dtype=torch.float32,
                       device=q.device)
    lib = _lib()
    rc = getattr(lib, _ENTRY[dt])(
        kernels.ptr(q), kernels.ptr(k_cur), kernels.ptr(v_cur), kernels.ptr(kv_pages),
        sc_ptr, kernels.ptr(page_table), kernels.ptr(lengths), kernels.ptr(out),
        kernels.ptr(work), kernels.ptr(_counters(q.device, b * g)),
        int(q.dtype == torch.bfloat16), b, g, n, hd, hdp, p, ps, pps, layer_idx,
        q.stride(0), q.stride(1), k_cur.stride(0), k_cur.stride(1),
        v_cur.stride(0), v_cur.stride(1), ctypes.c_float(scale), int(commit),
        kernels.stream_ptr(q),
    )
    kernels.check(lib, rc, "paged_decode_attention")
    return out


def _lib() -> ctypes.CDLL:
    lib = kernels.load("decode_attention")
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_longlong] * 6
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib
