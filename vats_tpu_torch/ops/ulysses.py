"""Ulysses sequence parallelism: all-to-all head/sequence exchange.

Counterpart of ``vats_tpu/ops/ulysses.py``.  One tiled all_to_all over the
``seq`` mesh axis turns each rank's sequence shard of Q/K/V into a head
shard over the whole sequence; each rank attends its heads with the plain
``ops/attention_ref.dot_product_attention`` (where the JAX package calls
XLA's), and a second all_to_all restores the sequence shards.  The key
validity mask is all-gathered so every head shard masks the whole
sequence.  No kernel runs here.

Requires num_q_heads % seq_shards == 0 and num_kv_heads % seq_shards == 0.
"""

from __future__ import annotations

from typing import Optional

import torch

from vats_tpu_torch.ops.attention_ref import dot_product_attention
from vats_tpu_torch.parallel.collectives import all_gather, all_to_all


def ulysses_attention(
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
    axis_name: str = "seq",
) -> torch.Tensor:
    """q: [B, tl, Hq, hd]; k/v: [B, tl, G, hd], this rank's sequence shard.

    kv_valid: optional [B, tl] bool padding mask (True = real), sharded like
    k.  Returns this rank's [B, tl, Hq, hd]."""
    n = mesh.shape[axis_name]
    hq, g = q.shape[2], k.shape[2]
    if hq % n != 0 or g % n != 0:
        raise ValueError(
            f"Ulysses needs this rank's heads divisible by seq shards: Hq={hq}, "
            f"G={g}, shards={n} (use ring_attention otherwise)"
        )
    if kv_valid is None:
        kv_valid = torch.ones(q.shape[:2], dtype=torch.bool, device=q.device)
    # [B, tl, H, hd] -> [B, T, H / n, hd]
    qh, kh, vh = (all_to_all(x, mesh, axis_name, split_dim=2, concat_dim=1)
                  for x in (q, k, v))
    valid = all_gather(kv_valid.to(torch.int32), mesh, axis_name, dim=1).bool()
    out = dot_product_attention(
        qh, kh, vh, scale=scale, causal=causal, left_window=left_window,
        right_window=right_window, kv_valid=valid,
    )
    return all_to_all(out, mesh, axis_name, split_dim=1, concat_dim=2)
