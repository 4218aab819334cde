"""Operations and bytes of a latent-attention (MLA) model's serving
forwards, from shapes (``LatentModelArgs``' model section), as
``benchmark/work.py`` counts them for the other models: what the algorithm
needs, each input byte read once and each output byte written once.

A decode forward attends absorbed (q.k over the latent width r + rope and
p.v over r, each row's latent vectors read once for every head); a prefill
attends decompressed (q.k over nope + rope, p.v over v).  The weights'
products are the same either way: kv_b_proj's rows are multiplied once a
token, by the key it makes (prefill) or the query it folds (decode).
"""

from __future__ import annotations

from typing import Sequence, Tuple

from benchmark.work import BF16


def latent_width(m: dict) -> int:
    return m["kv_lora_rank"] + m["qk_rope_head_dim"]


def mla_params(m: dict) -> Tuple[int, int, int]:
    """(params a token multiplies outside the routed experts, params of one
    routed expert, params of the readout): attention, norms, the dense
    layers' SwiGLU, the routers and the shared experts of every layer, and
    the final norm; the untied head (the embedding is a lookup, no
    product)."""
    d, h, e, f, layers = (m["d_model"], m["num_heads"], m["num_experts"], m["d_ffn"],
                          m["num_layers"])
    r, nope, rope, vd = (m["kv_lora_rank"], m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                         m["v_head_dim"])
    attn = d * h * (nope + rope) + d * (r + rope) + r + r * h * (nope + vd) + h * vd * d
    dense_layers = m["first_k_dense_replace"]
    ffn_dense = 3 * d * m["dense_d_ffn"]
    moe_fixed = d * e + e + 3 * d * m["n_shared_experts"] * f
    dense = (layers * (attn + 2 * d) + dense_layers * ffn_dense
             + (layers - dense_layers) * moe_fixed + d)
    return dense, 3 * d * f, m["vocab_size"] * d


def moe_layers(m: dict) -> int:
    return m["num_layers"] - m["first_k_dense_replace"]


def flops_per_token(m: dict) -> float:
    """Weight products of one token's forward: the dense part, the top-k
    routed experts of every expert layer and the readout."""
    dense, expert, head = mla_params(m)
    return 2.0 * (dense + moe_layers(m) * m["top_k"] * expert + head)


def weight_bytes(m: dict, experts_touched: int) -> float:
    """bf16 bytes of the weights a forward reads: the dense part, the
    routed experts it touches in each expert layer, the readout."""
    dense, expert, head = mla_params(m)
    return BF16 * (dense + moe_layers(m) * experts_touched * expert + head)


def latent_bytes_per_token(m: dict) -> float:
    """Bytes of the latent cache a token holds over all layers (bf16)."""
    return m["num_layers"] * latent_width(m) * BF16


def decode_attn_flops(m: dict, keys: int) -> float:
    """Absorbed q.k (latent width) and p.v (r) of one layer over ``keys``
    attended (row, key) pairs."""
    return 2.0 * m["num_heads"] * keys * (latent_width(m) + m["kv_lora_rank"])


def prefill_attn_flops(m: dict, pairs: int) -> float:
    """Decompressed q.k (nope + rope) and p.v (v) of one layer over
    ``pairs`` attended (query, key) pairs."""
    qk = m["qk_nope_head_dim"] + m["qk_rope_head_dim"]
    return 2.0 * m["num_heads"] * pairs * (qk + m["v_head_dim"])


def mla_decode_cost(m: dict, keys: Sequence[int]) -> Tuple[float, float]:
    """(bytes, flops) of one layer's K9 call over rows that attend
    ``keys[b]`` latent vectors each (the current token included): each
    row's vectors read once, q_abs in and the latent output out, the
    lengths; q.k and p.v over every (row, key) pair."""
    b, w, r, h = len(keys), latent_width(m), m["kv_lora_rank"], m["num_heads"]
    total = sum(int(n) for n in keys)
    nbytes = total * w * BF16 + b * h * (w + r) * BF16 + b * 4
    return nbytes, decode_attn_flops(m, total)
