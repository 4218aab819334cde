"""Operations and bytes the benchmark's workloads need, from shapes, and the
chip's peaks that turn them into least times.

Everything here counts what the algorithm needs for the given inputs (each
input byte read once, each output byte written once; the attended pairs of
a causal, segment-masked attention), never what a kernel happens to do, so
a roofline share read against it can only fall when a kernel wastes work.
"""

from __future__ import annotations

from typing import Iterable, Sequence

#: NVIDIA H100 SXM data sheet, dense: bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
BF16 = 2
FP32 = 4


def least_s(nbytes: float, flops: float) -> float:
    """The least time of a call: the larger of its bytes over the peak
    bandwidth and its operations over the bf16 peak."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


# ------------------------------------------------------ paged decode (K1)


def decode_attn_cost(lengths: Sequence[int], *, kv_heads: int, q_per_kv: int, hd: int,
                     page_size: int = 128, pages_per_row: int, commit: bool = True):
    """(bytes, flops) of one layer's paged decode attention over a batch
    with settled history ``lengths`` (one entry a row, the scratch rows'
    0): q in and out, the current K/V in, each row's valid history read
    once, the committed K/V out, the page table and lengths (bf16 pool);
    K and V at the head dim the attention needs, not a page's padded one."""
    b = len(lengths)
    cap = pages_per_row * page_size
    tokens = sum(min(int(n), cap) for n in lengths)
    per_tok = 2 * kv_heads * hd * BF16
    nbytes = (2 * b * kv_heads * q_per_kv * hd * BF16 + 2 * b * kv_heads * hd * BF16
              + tokens * per_tok + (b * per_tok if commit else 0)
              + b * pages_per_row * 4 + b * 4)
    flops = 4 * kv_heads * q_per_kv * hd * (tokens + b)  # q.k and p.v a column
    return nbytes, flops


# ------------------------------------------------- flash attention (K2/K5)


def causal_pairs(segment_lengths: Iterable[int]) -> int:
    """Attended (query, key) pairs of causal attention within segments."""
    return sum(n * (n + 1) // 2 for n in segment_lengths)


def flash_fwd_cost(b: int, t: int, hq: int, g: int, hd: int, pairs: int, lse: bool = False):
    """(bytes, flops) of a bf16 flash forward: q, k, v in, out (and the
    fp32 log-sum-exp) written; q.k and p.v over the attended ``pairs``
    (summed over the batch)."""
    nbytes = b * t * hd * BF16 * (2 * hq + 2 * g) + (b * hq * t * FP32 if lse else 0)
    return nbytes, 4 * hq * hd * pairs


def flash_bwd_cost(b: int, t: int, hq: int, g: int, hd: int, pairs: int):
    """(bytes, flops) of a bf16 flash backward: q, k, v, out, dout and the
    log-sum-exp in, dq, dk, dv out; the recomputed q.k, then dv, dp, dq and
    dk over the attended pairs (5 products to the forward's 2)."""
    nbytes = b * t * hd * BF16 * (3 * hq + 2 * g) + b * hq * t * FP32 \
        + b * t * hd * BF16 * (hq + 2 * g)
    return nbytes, 10 * hq * hd * pairs


# --------------------------------------------------------- whole model


def text_lm_params(m: dict):
    """(params outside the experts, params of one expert, embedding
    params) of a TextLM config ``m`` (the model section of a config
    file): every weight that a token's forward multiplies, the embedding
    counted once (its lookup is no product; its tied readout is)."""
    d, h, g, f = m["d_model"], m["num_heads"], m["query_groups"], m["d_ffn"]
    hd = d // h
    e, layers = m["num_experts"], m["num_layers"]
    attn = d * (h + 2 * g) * hd + h * hd * d
    router = d * e + e
    norms = 3 * d
    dense = layers * (attn + router + norms) + d
    expert = 3 * d * f
    return dense, expert, m["vocab_size"] * d


def forward_flops_per_token(m: dict) -> float:
    """Weight products of one token's forward: 2 x (dense params + top_k
    experts + the readout)."""
    dense, expert, embed = text_lm_params(m)
    return 2.0 * (dense + m["num_layers"] * m["top_k"] * expert + embed)


def attention_flops(m: dict, pairs: int) -> float:
    """q.k and p.v of every layer over ``pairs`` attended pairs."""
    hd = m["d_model"] // m["num_heads"]
    return 4.0 * m["num_heads"] * hd * pairs * m["num_layers"]


def weight_bytes(m: dict, experts_touched: int, dtype_bytes: int = BF16) -> float:
    """Bytes of the weights a forward reads: the dense part, the experts
    it touches in each layer, and the embedding (read as the readout)."""
    dense, expert, embed = text_lm_params(m)
    return dtype_bytes * (dense + m["num_layers"] * experts_touched * expert + embed)


def kv_bytes_per_token(m: dict) -> float:
    """Bytes of K and V a settled token holds over all layers (bf16, at the
    head dim the attention needs)."""
    hd = m["d_model"] // m["num_heads"]
    return m["num_layers"] * 2 * m["query_groups"] * hd * BF16
