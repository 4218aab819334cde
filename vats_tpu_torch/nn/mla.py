"""Multi-head latent attention (MLA, DeepSeek-V2), no q LoRA.

  q = q_proj(x): H heads of (nope + rope); kv_a_proj(x) = [c_kv, k_pe]:
  c_kv = RMSNorm(.) of width ``kv_lora_rank``, k_pe of width ``rope`` shared
  by every head; kv_b_proj(c_kv) = each head's [k_nope, v]; RoPE (the
  port's interleaved pairs, YaRN when given) on q's rope part and on k_pe;
  a head attends with q = [q_nope, q_pe], k = [k_nope, k_pe] and v; o_proj
  maps the heads' values back.

Three paths:
  * uncached: the decompressed attention above over the forward's own
    tokens (causal, key padding);
  * a paged prefill (``ops/mla_decode.LatentPagedCache``, T > 1): the
    window's latent vectors [c_kv, k_pe] are appended to the pool; a fresh
    cache's rows start at 0, so each attends its own window as the
    uncached path does; else each row attends, decompressed, every position
    its pages hold (kv_b_proj up-projects the gathered latents);
  * a paged decode (T == 1), absorbed: the token's latent vector is
    appended, q_nope is folded through W_UK (kv_b_proj's key rows) to the
    latent width and joined to q_pe, K9 (``ops/mla_decode.py``) attends the
    row's latent vectors with values equal to their first ``kv_lora_rank``
    elements, and W_UV (kv_b_proj's value rows) maps the result to each
    head's value.  q.k over the latent equals q.k decompressed: the
    absorption only reorders the products.

The plain attention of the first two paths (``blocked_attention``) takes
bf16 operands into fp32 scores, an fp32 softmax and a p.v with p in bf16,
in blocks of ``BLOCK`` queries; over a window's own tokens a query block
reads only the keys up to its end.

Span (``utils/profiling.annotate``): ``attn.mla`` over each layer's
attention between its projections (RoPE, the append, the up-projection or
the absorption, the attention, W_UV); K9 or its plain version opens
``mla.decode`` inside it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from vats_tpu_torch.device import resolve_dtype
from vats_tpu_torch.nn.attention import dense
from vats_tpu_torch.nn.dropout import SITE_ATTN, Seed, dropout
from vats_tpu_torch.nn.initializers import input_proj_init_, output_proj_init_
from vats_tpu_torch.nn.norms import RMSNorm
from vats_tpu_torch.nn.rope import (
    apply_rope_interleaved,
    rope_inv_freq,
    rope_table_cos_sin,
    yarn_inv_freq,
)
from vats_tpu_torch.ops.attention_ref import DEFAULT_MASK_VALUE
from vats_tpu_torch.ops.mla_decode import mla_decode_attention
from vats_tpu_torch.utils.profiling import annotate

#: queries a block of the plain attention takes at once
BLOCK = 1024
#: fp32 scores one pass over a query block's keys holds at most (512 MB);
#: more keys take more passes, combined through their log-sum-exp
SCORES = 1 << 27


def _f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b ([..., m, k] @ [..., k, n]) with an fp32 result: bf16 operands
    on the card go to the tensor cores with fp32 accumulation and an fp32
    output; elsewhere the product runs in fp32 on the same values."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        lead = a.shape[:-2]
        out = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                        out_dtype=torch.float32)
        return out.view(*lead, *out.shape[-2:])
    return torch.matmul(a.float(), b.float())


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
                      q_pos: Optional[torch.Tensor] = None,
                      k_pos: Optional[torch.Tensor] = None,
                      k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal attention of q [B, T, H, dq] over k [B, S, H, dq], v [B, S,
    H, dv]: a query sees the keys at or before its position (and ``k_valid``
    [B, S] where given).  With ``q_pos`` [B, T] and ``k_pos`` [S] the
    positions are those; without, the queries are the keys' own tokens at
    0..T-1 (S == T): a query block reads only the keys up to its end, and
    masks only its diagonal.

    bf16 products with fp32 results (``_f32_product``), an fp32 softmax, p
    rounded to v's dtype for p.v (as the kernels' P.V operand), in blocks
    of BLOCK queries; a block's keys in one pass where its scores fit
    SCORES, else in passes combined through their log-sum-exp.  A query
    with no key gets uniform weights over the masked scores (finite mask
    value), as ``ops/attention_ref`` does.  Returns [B, T, H, dv] in q's
    dtype."""
    b, t, h, _ = q.shape
    own = q_pos is None
    dev = q.device
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))  # [B, H, T or S, d]
    out = torch.empty((b, h, t, v.shape[-1]), dtype=q.dtype, device=dev)
    for q0 in range(0, t, BLOCK):
        q1 = min(t, q0 + BLOCK)
        keys = q1 if own else k.shape[1]
        step = max(BLOCK, SCORES // (b * h * (q1 - q0)))
        parts = []  # (log-sum-exp or None, normalised p.v) of each pass
        for k0 in range(0, keys, step):
            k1 = min(keys, k0 + step)
            sc = _f32_product(qh[:, :, q0:q1], kh[:, :, k0:k1].transpose(-1, -2)).mul_(scale)
            if not own:
                sc.masked_fill_(~(k_pos[None, None, k0:k1] <= q_pos[:, q0:q1, None])[:, None],
                                DEFAULT_MASK_VALUE)
            elif k1 > q0 + 1:  # the keys past a query, on the block's diagonal
                j0 = max(k0, q0)
                late = (torch.arange(j0, k1, device=dev)[None, :]
                        > torch.arange(q0, q1, device=dev)[:, None])
                sc[..., j0 - k0:].masked_fill_(late, DEFAULT_MASK_VALUE)
            if k_valid is not None:
                sc.masked_fill_(~k_valid[:, None, None, k0:k1], DEFAULT_MASK_VALUE)
            if k1 - k0 == keys:
                p, lse = torch.softmax(sc, dim=-1), None
            else:
                lse = torch.logsumexp(sc, dim=-1, keepdim=True)
                p = sc.sub_(lse).exp_()
            parts.append((lse, _f32_product(p.to(v.dtype), vh[:, :, k0:k1])))
            del sc, p
        if len(parts) == 1:
            o = parts[0][1]
        else:
            total = torch.logsumexp(torch.cat([lse for lse, _ in parts], dim=-1), dim=-1,
                                    keepdim=True)
            o = sum(torch.exp(lse - total) * pv for lse, pv in parts)
        out[:, :, q0:q1] = o.to(q.dtype)
    return out.transpose(1, 2)


class MLAttention(nn.Module):
    """Latent attention of one layer; returns ([B, T, d_model], cache)."""

    def __init__(self, d_model: int, num_heads: int, kv_lora_rank: int, qk_nope_head_dim: int,
                 qk_rope_head_dim: int, v_head_dim: int, *, rope_theta: float = 10000.0,
                 softmax_scale: float, eps: float = 1e-6, num_layers: int = 1,
                 yarn: Optional[Tuple[float, int, float, float, float]] = None,
                 dtype: torch.dtype = torch.float32, param_dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.num_heads = h = num_heads
        self.kv_lora_rank = r = kv_lora_rank
        self.nope, self.rope, self.v_dim = qk_nope_head_dim, qk_rope_head_dim, v_head_dim
        self.rope_theta = rope_theta
        self.softmax_scale = softmax_scale
        self.num_layers = num_layers
        self.yarn = yarn
        self.dtype = dtype
        lin = lambda i, o: nn.Linear(i, o, bias=False, dtype=param_dtype,  # noqa: E731
                                     device=device)
        self.q_proj = lin(d_model, h * (self.nope + self.rope))
        self.kv_a_proj = lin(d_model, r + self.rope)
        self.kv_a_norm = RMSNorm(r, eps, dtype, param_dtype, device=device)
        self.kv_b_proj = lin(r, h * (self.nope + self.v_dim))
        self.o_proj = lin(h * self.v_dim, d_model)
        self._inv_freq = {}  # per device, made at first use (not a buffer: meta builds)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for lin in (self.q_proj, self.kv_a_proj, self.kv_b_proj):
            input_proj_init_(lin.weight, self.num_layers, (lin.in_features, lin.out_features),
                             generator)
        output_proj_init_(self.o_proj.weight, self.num_layers, generator)
        with torch.no_grad():
            self.kv_a_norm.weight.fill_(1.0)

    def _cos_sin(self, positions: torch.Tensor):
        dev = positions.device
        inv = self._inv_freq.get(dev)
        if inv is None:
            if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError("MLA: no RoPE table for this device yet; run the step "
                                   "once before capturing it")
            if self.yarn is None:
                inv = rope_inv_freq(self.rope, self.rope_theta, device=dev)
            else:
                factor, original, fast, slow, _ = self.yarn
                inv = yarn_inv_freq(self.rope, self.rope_theta, factor, original, fast, slow,
                                    device=dev)
            self._inv_freq[dev] = inv
        return rope_table_cos_sin(positions, inv, self.yarn[4] if self.yarn else 1.0)

    def _project(self, x: torch.Tensor):
        """The input projections: q [B, T, H, nope + rope], and kv_a_proj's
        output with its latent part normed [B, T, r + rope] (k_pe not yet
        roped)."""
        b, t, _ = x.shape
        q = dense(self.q_proj, x, self.dtype).reshape(b, t, self.num_heads, -1)
        kv_a = dense(self.kv_a_proj, x, self.dtype)
        c = self.kv_a_norm(kv_a[..., :self.kv_lora_rank])
        return q, torch.cat([c, kv_a[..., self.kv_lora_rank:]], dim=-1)

    def _rotate(self, q: torch.Tensor, kv_a: torch.Tensor, positions: torch.Tensor):
        """(q_nope [B, T, H, nope], q_pe roped, latent vectors [B, T, r +
        rope]: c_kv then k_pe roped) at ``positions`` [B, T]."""
        r = self.kv_lora_rank
        cos, sin = self._cos_sin(positions)
        q_pe = apply_rope_interleaved(q[..., self.nope:], cos, sin)
        k_pe = apply_rope_interleaved(kv_a[..., None, r:], cos, sin)[..., 0, :]
        return q[..., :self.nope], q_pe, torch.cat([kv_a[..., :r], k_pe], dim=-1)

    def _decompress(self, latent: torch.Tensor):
        """Keys [B, S, H, nope + rope] and values [B, S, H, v] of latent
        vectors [B, S, r + rope]."""
        b, s, _ = latent.shape
        kv = dense(self.kv_b_proj, latent[..., :self.kv_lora_rank], self.dtype)
        kv = kv.reshape(b, s, self.num_heads, self.nope + self.v_dim)
        k_pe = latent[..., None, self.kv_lora_rank:].expand(b, s, self.num_heads, self.rope)
        return torch.cat([kv[..., :self.nope], k_pe], dim=-1), kv[..., self.nope:]

    def forward(self, x: torch.Tensor, *, padding_mask: Optional[torch.Tensor] = None,
                paged_cache=None, layer_idx: int = 0, **_):
        b, t, _ = x.shape
        dev = x.device
        q, kv_a = self._project(x)
        lengths = None if paged_cache is None else paged_cache.lengths
        positions = torch.arange(t, device=dev)[None, :]
        positions = positions.expand(b, t) if lengths is None else lengths[:, None] + positions
        with annotate("attn.mla"):
            q_nope, q_pe, latent = self._rotate(q, kv_a, positions)
            if paged_cache is not None:
                paged_cache.append_tokens(layer_idx, latent)
            if paged_cache is not None and t == 1:
                out = self._absorbed_decode(q_nope[:, 0], q_pe[:, 0], paged_cache, layer_idx)
            elif paged_cache is None or paged_cache.fresh:  # the keys are this window's
                k, v = self._decompress(latent)
                # a fresh prefill's padding follows its tokens (the engine's):
                # no valid query reaches it
                valid = (None if padding_mask is None or paged_cache is not None
                         else padding_mask.bool())
                out = blocked_attention(torch.cat([q_nope, q_pe], dim=-1), k, v,
                                        scale=self.softmax_scale, k_valid=valid)
            else:
                out = self._paged_prefill(q_nope, q_pe, paged_cache, layer_idx,
                                          padding_mask, positions)
        return dense(self.o_proj, out.reshape(b, t, -1), self.dtype), paged_cache

    def _absorbed_decode(self, q_nope, q_pe, cache, layer_idx):
        """[B, 1, H, v]: q_nope [B, H, nope] folded through W_UK, K9 over
        the row's latents (the current one appended), W_UV."""
        h, r = self.num_heads, self.kv_lora_rank
        w = self.kv_b_proj.weight.to(self.dtype).view(h, self.nope + self.v_dim, r)
        q_abs = torch.bmm(q_nope.transpose(0, 1), w[:, :self.nope])  # [H, B, r]
        q_abs = torch.cat([q_abs.transpose(0, 1), q_pe], dim=-1).contiguous()
        cap = cache.pages_per_seq * cache.page_size
        keys = torch.clamp(cache.lengths + 1, max=cap)
        o_lat = mla_decode_attention(q_abs, cache.pages, layer_idx, cache.page_table, keys,
                                     scale=self.softmax_scale, v_dim=r)  # [B, H, r]
        out = torch.bmm(o_lat.transpose(0, 1), w[:, self.nope:].transpose(1, 2))  # [H, B, v]
        return out.transpose(0, 1)[:, None]

    def _paged_prefill(self, q_nope, q_pe, cache, layer_idx, padding_mask, positions):
        """[B, T, H, v]: each row's queries over its pages (its history and
        the window just appended), decompressed."""
        b, t = positions.shape
        latent = cache.gather(layer_idx)
        k, v = self._decompress(latent)
        counts = (torch.full((b,), t, device=q_nope.device) if padding_mask is None
                  else padding_mask.to(torch.int32).sum(dim=1))
        k_pos = torch.arange(latent.shape[1], device=q_nope.device)
        valid = k_pos[None, :] < (cache.lengths + counts)[:, None]
        q = torch.cat([q_nope, q_pe], dim=-1)
        return blocked_attention(q, k, v, scale=self.softmax_scale, q_pos=positions,
                                 k_pos=k_pos, k_valid=valid)


class MLABlock(nn.Module):
    """Pre-RMSNorm -> MLAttention -> dropout -> residual."""

    def __init__(self, cfg, device=None):
        super().__init__()
        dtype, param_dtype = resolve_dtype(cfg.dtype), resolve_dtype(cfg.param_dtype)
        self.dropout = cfg.dropout
        self.norm = RMSNorm(cfg.d_model, cfg.rms_norm_eps, dtype, param_dtype, device=device)
        yarn = None
        if cfg.yarn_factor > 1:
            yarn = (cfg.yarn_factor, cfg.yarn_original_max_position, cfg.yarn_beta_fast,
                    cfg.yarn_beta_slow, cfg.rope_scale)
        self.attn = MLAttention(
            cfg.d_model, cfg.num_heads, cfg.kv_lora_rank, cfg.qk_nope_head_dim,
            cfg.qk_rope_head_dim, cfg.v_head_dim, rope_theta=cfg.rope_base,
            softmax_scale=cfg.softmax_scale, eps=cfg.rms_norm_eps, num_layers=cfg.num_layers,
            yarn=yarn, dtype=dtype, param_dtype=param_dtype, device=device)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.norm.weight.fill_(1.0)
        self.attn.reset_parameters(generator)

    def forward(self, x, *, deterministic: bool = True, dropout_seed: Optional[Seed] = None,
                cache=None, **kw) -> Tuple:
        if cache is not None:
            raise NotImplementedError("MLA runs uncached or over a LatentPagedCache; "
                                      "a dense KV cache has no latent layout")
        out, new_cache = self.attn(self.norm(x), **kw)
        out = dropout(out, self.dropout, deterministic=deterministic, seed=dropout_seed,
                      layer=kw.get("layer_idx", 0), site=SITE_ATTN)
        return x + out, new_cache
