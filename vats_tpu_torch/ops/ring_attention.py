"""Ring attention: context-parallel attention over the ``seq`` mesh axis.

Counterpart of ``vats_tpu/ops/ring_attention.py``.  Each rank holds its
shard of the sequence: q [B, tl, Hq, hd], k/v [B, tl, G, hd] for tokens
``[r * tl, (r + 1) * tl)``, r its coordinate on ``seq``.  The K/V shard
(with its key validity and segment ids) travels one rank ahead after each
hop (``parallel.collectives.shift``), so at hop i rank r holds the shard of
rank ``(r - i) % n``.

It is the JAX package's ring-flash path (``impl="flash"``, its default):

  * forward: every live hop runs K2' (``flash_attention_lse``) with a fixed
    ``q_pos_offset``: ``i * tl`` for a shard from behind (r >= i), and
    ``(i - n) * tl``, negative, for a wrapped one from ahead (r < i).  The
    JAX ``lax.cond`` on the rank's coordinate is a Python branch here.  The
    per-hop outputs (rounded to q's dtype, as the kernel writes them) merge
    in fp32 by their logsumexps (:func:`_merge`).  :func:`_ring_steps` is
    the static plan: hops whose shard lies wholly outside the causal mask or
    the windows for every local query never run a kernel, and trailing dead
    hops are not taken.
  * backward (:class:`RingFlashFn`): the globally merged lse (1e30 where a
    row has no key anywhere) and di = sum(do * o) from the ring's own
    output go into K5a and K5b (``flash_attention_bwd``) at every live hop,
    so each hop yields exactly that shard's part of the global gradient.
    The fp32 dK/dV accumulators travel with their shard; one shift of
    ``len(plan) - 1`` back sends them home.
  * the head dim is padded once, outside the ring, to the kernels' head
    dim (32, 64 or 128; exact).  The kernels take [B, T, H, D], so none of
    the JAX package's transposes remain.

On CUDA tensors the hops run the kernels; on CPU tensors the wrappers run
their plain versions, so the same ring is its own plain counterpart there.

``impl="xla"`` is the JAX package's blockwise ring (``_ring_attention_xla``),
which computes the same function in XLA, outside any Pallas kernel, and so
here in PyTorch, outside any kernel of the port (:func:`_ring_blockwise`):
online-softmax tiles of ``q_chunk`` x ``k_chunk`` (the largest divisors of
tl no larger), fp32 scores of q and k in their storage dtype, p and p·v in
fp32, full fp32 products (no TF32).  It takes the hops of
:func:`_ring_steps`: a hop whose shard lies wholly outside the causal mask
or the windows for every local query computes nothing (the JAX
``lax.cond``, a Python branch here), and the trailing dead hops (under
causal + ``left_window``, those past the window) are not taken.  K, V and
their validity rotate in their storage dtype through the differentiable
``parallel.collectives.ppermute``, so autograd gives the backward, as
``jax.grad`` does through the JAX scan.  The model's context parallelism
takes the flash ring, in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from vats_tpu_torch.device import no_tf32
from vats_tpu_torch.ops.attention_ref import DEFAULT_MASK_VALUE
from vats_tpu_torch.ops.flash_attention import (
    LSE_EMPTY_ROW,
    _kernel_head_dim,
    flash_attention_bwd,
    flash_attention_lse,
)
from vats_tpu_torch.parallel.collectives import _TieFn, ppermute, shift


@dataclasses.dataclass(frozen=True)
class _RingCfg:
    axis_name: str
    n_seq: int
    t_local: int
    scale: float
    causal: bool
    left_window: int
    right_window: int
    use_segids: bool


def _ring_steps(cfg: _RingCfg):
    """Static per-hop plan: list of (past_alive, future_alive).

    ``past``  = un-wrapped sources (idx >= i), offset  i * t_local >= 0;
    ``future``= wrapped sources   (idx <  i), offset (i - n) * t_local < 0.
    A branch is dead when the whole shard lies outside the causal/window
    bounds for every local query — those hops never touch the kernel."""
    tl, n = cfg.t_local, cfg.n_seq
    plan = []
    for i in range(n):
        past = True
        if i > 0 and cfg.left_window >= 0 and i * tl - (tl - 1) > cfg.left_window:
            past = False
        future = i > 0 and not cfg.causal
        if future and cfg.right_window >= 0 and (n - i) * tl - (tl - 1) > cfg.right_window:
            future = False
        plan.append((past, future))
    while plan and plan[-1] == (False, False):
        plan.pop()
    return plan


def _hop_offset(cfg: _RingCfg, idx: int, i: int, past: bool, future: bool):
    """The q_pos_offset of hop i on the rank at ``idx``, or None where the
    hop is dead there."""
    if i == 0:
        return 0
    if idx >= i:
        return i * cfg.t_local if past else None
    return (i - cfg.n_seq) * cfg.t_local if future else None


def _merge(o, lse, o_i, lse_i):
    """Combine normalized per-hop outputs via their logsumexps (fp32).

    o [B, T, Hq, D] fp32; lse [B, Hq, T] fp32 (-inf: no mass yet); o_i in
    q's dtype; lse_i with the kernel's 1e30 for a row that attends nothing."""
    lse_i = torch.where(lse_i > 1e29, -torch.inf, lse_i)
    m = torch.maximum(lse, lse_i)
    finite = m > -torch.inf
    m_safe = torch.where(finite, m, 0.0)
    a = torch.where(finite, torch.exp(lse - m_safe), 0.0)
    b = torch.where(finite, torch.exp(lse_i - m_safe), 0.0)
    # a + b == 0 exactly on rows with no mass anywhere (0/0 otherwise)
    denom = torch.clamp(a + b, min=1e-30)
    w_o = (a / denom).transpose(1, 2)[..., None]
    w_i = (b / denom).transpose(1, 2)[..., None]
    o_new = o * w_o + o_i.float() * w_i
    lse_new = torch.where(finite, m_safe + torch.log(a + b), -torch.inf)
    return o_new, lse_new


def _masks(cfg: _RingCfg, valid, qseg, kseg):
    return dict(kv_valid=valid, q_segment_ids=qseg if cfg.use_segids else None,
                kv_segment_ids=kseg if cfg.use_segids else None)


def _ring_flash_fwd(q, k, v, valid, qseg, kseg, cfg: _RingCfg, mesh):
    """q [B, tl, Hq, D]; k/v [B, tl, G, D]; valid/qseg/kseg [B, tl] int32.
    Returns (out [B, tl, Hq, D] in q.dtype, lse [B, Hq, tl] fp32)."""
    idx = mesh.axis_index(cfg.axis_name)
    b, tl, hq, d = q.shape
    plan = _ring_steps(cfg)
    o = torch.zeros((b, tl, hq, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, hq, tl), -torch.inf, device=q.device)
    blk = [k, v, valid, kseg]
    for i, (past, future) in enumerate(plan):
        off = _hop_offset(cfg, idx, i, past, future)
        if off is not None:
            k_i, v_i, valid_i, kseg_i = blk
            o_i, lse_i = flash_attention_lse(q, k_i, v_i, scale=cfg.scale, causal=cfg.causal,
                             left_window=cfg.left_window, right_window=cfg.right_window,
                             q_pos_offset=off, **_masks(cfg, valid_i, qseg, kseg_i))
            o, lse = _merge(o, lse, o_i, lse_i)
        if i < len(plan) - 1:
            blk = shift(blk, mesh, cfg.axis_name, 1)
    return o.to(q.dtype), lse


class RingFlashFn(torch.autograd.Function):
    """The ring-flash forward and its backward (``_ring_flash_fwd`` /
    ``_ring_flash_bwd`` of the JAX package)."""

    @staticmethod
    def forward(ctx, q, k, v, valid, qseg, kseg, cfg, mesh):
        out, lse = _ring_flash_fwd(q, k, v, valid, qseg, kseg, cfg, mesh)
        ctx.save_for_backward(q, k, v, valid, qseg, kseg, out, lse)
        ctx.cfg, ctx.mesh = cfg, mesh
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, valid, qseg, kseg, out, lse = ctx.saved_tensors
        cfg, mesh = ctx.cfg, ctx.mesh
        idx = mesh.axis_index(cfg.axis_name)
        b, tl, hq, d = q.shape
        g = k.shape[2]
        plan = _ring_steps(cfg)
        do = do.to(q.dtype).contiguous()
        # the global row statistics: a row with no key anywhere gets 1e30, so
        # every hop's p = exp(s - lse) is 0 there
        lse_safe = torch.where(torch.isfinite(lse), lse, LSE_EMPTY_ROW)
        di = (do.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()
        dq = torch.zeros((b, tl, hq, d), dtype=torch.float32, device=q.device)
        dk_t = torch.zeros((b, tl, g, d), dtype=torch.float32, device=q.device)
        dv_t = torch.zeros_like(dk_t)
        blk = [k, v, valid, kseg, dk_t, dv_t]  # the accumulators travel with their shard
        for i, (past, future) in enumerate(plan):
            off = _hop_offset(cfg, idx, i, past, future)
            if off is not None:
                k_i, v_i, valid_i, kseg_i, dk_i, dv_i = blk
                m = _masks(cfg, valid_i, qseg, kseg_i)
                dq_i, dk_c, dv_c = flash_attention_bwd(
                    q, k_i, v_i, do, lse_safe, di, m["kv_valid"], m["q_segment_ids"],
                    m["kv_segment_ids"], scale=cfg.scale, causal=cfg.causal,
                    left_window=cfg.left_window, right_window=cfg.right_window,
                    q_pos_offset=off)
                dq += dq_i
                dk_i += dk_c
                dv_i += dv_c
            if i < len(plan) - 1:
                blk = shift(blk, mesh, cfg.axis_name, 1)
        # after len(plan) - 1 hops a shard's gradients sit that many ranks
        # ahead of home; one shift back returns them
        dk_t, dv_t = shift(blk[4:], mesh, cfg.axis_name, -(len(plan) - 1))
        return (dq.to(q.dtype), dk_t.to(k.dtype), dv_t.to(v.dtype)) + (None,) * 5


def _pick_chunk(t_local: int, target: int) -> int:
    """The largest divisor of t_local that is at most ``target``."""
    c = min(t_local, target)
    while t_local % c:
        c -= 1
    return c


def _tile_update(q_c, k_c, v_c, valid_c, q_pos, k_pos, cfg: _RingCfg, m, l, o):
    """One online-softmax update of a q chunk's stats from one K/V chunk
    (the JAX ``_tile_update``).  q_c [B, G, N, qc, hd] and k_c / v_c
    [B, G, 1, kc, hd] fp32 (values of their storage dtype); valid_c [B, kc]
    bool; m / l [B, G, N, qc, 1] and o [B, G, N, qc, hd] fp32, o
    unnormalised.  Only the [B, G, N, qc, kc] tile is live."""
    s = (q_c @ k_c.transpose(-1, -2)) * cfg.scale
    qp, kp = q_pos[:, None], k_pos[None, :]
    mask = torch.ones((qp.shape[0], kp.shape[1]), dtype=torch.bool, device=s.device)
    if cfg.causal:
        mask &= kp <= qp
    elif cfg.right_window >= 0:
        mask &= (kp - qp) <= cfg.right_window
    if cfg.left_window >= 0:
        mask &= (qp - kp) <= cfg.left_window
    mask = mask & valid_c[:, None, None, None, :]
    s = torch.where(mask, s, DEFAULT_MASK_VALUE)
    # the running max carries no gradient: the normalised output does not
    # depend on it (JAX differentiates through it to the same value)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True)).detach()
    alpha = torch.exp(m - m_new)
    p = torch.where(mask, torch.exp(s - m_new), 0.0)
    return m_new, alpha * l + p.sum(dim=-1, keepdim=True), o * alpha + p @ v_c


def _ring_blockwise(q, k, v, valid, cfg: _RingCfg, mesh, q_chunk: int, k_chunk: int):
    """The blockwise ring on this rank's shards (the JAX
    ``_ring_attention_xla``): q [B, tl, Hq, hd], k / v [B, tl, G, hd] in
    their storage dtypes, valid [B, tl] bool.  Returns [B, tl, Hq, hd] in
    q.dtype, 0 on a row with no key."""
    n, idx, tl = cfg.n_seq, mesh.axis_index(cfg.axis_name), cfg.t_local
    b, _, hq, hd = q.shape
    g = k.shape[2]
    qc, kc = _pick_chunk(tl, q_chunk), _pick_chunk(tl, k_chunk)
    # the flash ring's plan: a hop computes where its shard meets the mask
    # or the windows for some local query (JAX's lax.cond on the same
    # condition); under causal + a left window it has JAX's trip count,
    # 1 + (left_window + tl - 1) // tl hops
    plan = _ring_steps(cfg)
    dev = q.device
    qg = q.reshape(b, tl, g, hq // g, hd).permute(0, 2, 3, 1, 4).float()
    q_pos = idx * tl + torch.arange(tl, device=dev)
    stats = [(torch.full((b, g, hq // g, qc, 1), -torch.inf, device=dev),
              torch.zeros((b, g, hq // g, qc, 1), device=dev),
              torch.zeros((b, g, hq // g, qc, hd), device=dev)) for _ in range(tl // qc)]
    blk, token = [k, v, valid], None
    with no_tf32():
        for i, alive in enumerate(plan):
            if _hop_offset(cfg, idx, i, *alive) is not None:
                src = (idx - i) % n
                k_i, v_i, valid_i = blk
                kg = k_i.permute(0, 2, 1, 3)[:, :, None].float()  # [B, G, 1, tl, hd]
                vg = v_i.permute(0, 2, 1, 3)[:, :, None].float()
                for a in range(tl // qc):
                    qa = slice(a * qc, (a + 1) * qc)
                    m, l, o = stats[a]
                    for j in range(tl // kc):
                        kj = slice(j * kc, (j + 1) * kc)
                        m, l, o = _tile_update(
                            qg[:, :, :, qa], kg[..., kj, :], vg[..., kj, :], valid_i[:, kj],
                            q_pos[qa], src * tl + torch.arange(j * kc, (j + 1) * kc, device=dev),
                            cfg, m, l, o)
                    stats[a] = (m, l, o)
            if i < len(plan) - 1:
                blk, token = ppermute(blk, mesh, cfg.axis_name, 1, token=token)
    out = torch.cat([o / torch.clamp(l, min=1e-30) for _, l, o in stats], dim=3)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, tl, hq, hd).to(q.dtype)
    if token is not None and out.requires_grad:
        # the backward reaches every shift on every rank, latest first
        _, out = _TieFn.apply(token, out)
    return out


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mesh,
    scale: float,
    causal: bool = True,
    left_window: int = -1,
    right_window: int = -1,
    kv_valid: Optional[torch.Tensor] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    axis_name: str = "seq",
    q_chunk: int = 512,
    k_chunk: int = 512,
    impl: str = "flash",
) -> torch.Tensor:
    """Context-parallel attention over this rank's shards (see the module
    docstring): q [B, tl, Hq, hd], k/v [B, tl, G, hd]; kv_valid [B, tl]
    bool (True = real token) and segment ids [B, tl] int, sharded like k.
    Returns this rank's [B, tl, Hq, hd] in q.dtype.

    ``impl="flash"``: every live hop runs K2' (K5a/K5b in the backward).
    ``impl="xla"``: the blockwise ring in tiles of ``q_chunk`` x
    ``k_chunk`` (the flash ring ignores both), no kernel; it takes no
    segment ids, as in JAX."""
    b, tl, hq, hd = q.shape
    if hq % k.shape[2] != 0:
        raise ValueError(f"num q heads ({hq}) % kv groups ({k.shape[2]}) != 0")
    use_segids = q_segment_ids is not None or kv_segment_ids is not None
    if impl not in ("flash", "xla"):
        raise ValueError(f"unknown ring impl: {impl!r}")
    if impl == "xla" and use_segids:
        raise NotImplementedError(
            "segment ids need impl='flash' (masks rotate with KV shards)")
    dev = q.device

    def ids(x):
        if x is None:
            return torch.zeros((b, tl), dtype=torch.int32, device=dev)
        return x.to(torch.int32).contiguous()

    valid = (torch.ones((b, tl), dtype=torch.int32, device=dev) if kv_valid is None
             else kv_valid.to(torch.int32).contiguous())
    cfg = _RingCfg(axis_name=axis_name, n_seq=mesh.shape[axis_name], t_local=tl,
                   scale=float(scale), causal=bool(causal), left_window=int(left_window),
                   right_window=int(right_window), use_segids=use_segids)
    if impl == "xla":
        return _ring_blockwise(q, k, v, valid.bool(), cfg, mesh, q_chunk, k_chunk)
    # the kernels' head dim, padded once outside the ring (exact)
    dp = _kernel_head_dim(hd)
    pad = (lambda x: F.pad(x, (0, dp - hd)).contiguous()) if dp != hd else (
        lambda x: x.contiguous())
    out = RingFlashFn.apply(pad(q), pad(k.to(q.dtype)), pad(v.to(q.dtype)), valid,
                            ids(q_segment_ids), ids(kv_segment_ids), cfg, mesh)
    return out[..., :hd] if dp != hd else out

