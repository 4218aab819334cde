"""The plain reference of DeepSeek-V2-Lite (and of any model the port's
``LatentModelArgs`` states): its forward's logits in plain PyTorch and
float32, TF32 off, with no kernel, cache or batching of the program's, and
the seed's weights under the port's state-dict names.

It follows the published modeling code and config
(huggingface.co/deepseek-ai/DeepSeek-V2-Lite, config.json,
modeling_deepseek.py) as the configuration's ``model`` section states it:

  token embedding -> N x [x + MLA(RMSNorm(x)) -> x + FFN_i(RMSNorm(x))]
  -> RMSNorm -> untied readout

MLA, decompressed as the published code runs it (no absorption): q =
q_proj(x) per head [q_nope, q_pe]; [c_kv, k_pe] = kv_a_proj(x), c_kv
RMSNorm'd (``kv_a_layernorm``); [k_nope, v] = kv_b_proj(c_kv) per head; q_pe
and k_pe (one for every head) rotated by YaRN (inv_freq ramped between the
plain and the ``yarn_factor``-interpolated frequencies over the correction
range of ``beta_fast`` / ``beta_slow``, cos and sin times mscale(mscale) /
mscale(mscale_all_dim)); softmax scale (nope + rope)^-0.5 times
mscale(mscale_all_dim)^2; causal.  FFN_i: a dense SwiGLU for the first
``first_k_dense_replace`` layers, else a softmax router over the experts
(fp32; the top ``top_k`` probabilities, renormalised only with
``norm_topk_prob``, times ``routed_scaling_factor``), SwiGLU experts run on
the rows routed to them alone, plus the shared experts (one SwiGLU of
``n_shared_experts * d_ffn``) on every token.

Departures from the published model, all fixed relabelings or zeros:
  * RoPE rotates interleaved pairs (2i, 2i + 1): the published code permutes
    q_pe and k_pe (``view(..., d / 2, 2).transpose``) and then rotates
    halves, which is the same rotation of the same pairs;
  * the router has the port's bias, held at zero (the published gate has
    none), and of equal probabilities the lower expert wins (the published
    ``topk`` leaves ties unspecified);
  * the router's auxiliary loss is left out (serving does not need it), as
    is any MTP head (the config declares none).

Attention runs in blocks of ``QUERY_BLOCK`` queries, each over the keys its
rows may see, so a 12k sequence fits.  ``precision`` 'fp8' and 'bf16' round
where the program holds bf16, as ``reference/model.py`` does: 'fp8' is the
control, 'bf16' for the record.  The weights may come in bf16 (the dtype
the program serves); :meth:`DeepSeekV2Reference.hidden_all` raises one
layer's weights to fp32 at a time and runs every checked sequence through
it, each alone, so 31 GB need not be held twice.  Building a reference
turns TF32 off (``reference/model.no_tf32``).

Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.mellum import QUERY_BLOCK, SEED_MOD, yarn_inv_freq
from benchmark.reference.model import MASK_VALUE, ROUNDING, _Round, no_tf32


def yarn_mscale(factor: float, mscale: float) -> float:
    """The published ``yarn_get_mscale``."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def softmax_scale(m: dict) -> float:
    scale = m.get("softmax_scale")
    if scale is not None:
        return scale
    scale = (m["qk_nope_head_dim"] + m["qk_rope_head_dim"]) ** -0.5
    if m.get("yarn_mscale_all_dim"):
        scale *= yarn_mscale(m["yarn_factor"], m["yarn_mscale_all_dim"]) ** 2
    return scale


def param_specs(m: dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, init, scale) of every parameter of the model section
    ``m``, under the port's state-dict names, by ``benchmark/weights.py``'s
    scheme: a uniform of each initializer's standard deviation, RMSNorm
    scales 1, the router's bias 0."""
    d, h, f, e = m["d_model"], m["num_heads"], m["d_ffn"], m["num_experts"]
    r, nope, rope, vd = (m["kv_lora_rank"], m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                         m["v_head_dim"])
    layers, v = m["num_layers"], m["vocab_size"]
    std_uniform = math.sqrt(3.0)
    depth = 1.0 / math.sqrt(layers / 6.0) if layers > 12 else 1.0

    def xavier(fan_in, fan_out):
        return math.sqrt(6.0 / (fan_in + fan_out)) * depth

    out_std = 0.02 / math.sqrt(2 * layers) * std_uniform

    def swiglu(pre, width):
        return [(pre + "w_gate.weight", (width, d), "uniform", xavier(d, width)),
                (pre + "w_up.weight", (width, d), "uniform", xavier(d, width)),
                (pre + "w_down.weight", (d, width), "uniform", out_std)]

    specs = [("token_embed.weight", (v, d), "uniform", 0.02 * std_uniform)]
    for i in range(layers):
        p = f"layers.{i}."
        a = p + "attn_block.attn."
        specs += [
            (p + "attn_block.norm.weight", (d,), "ones", 1.0),
            (a + "q_proj.weight", (h * (nope + rope), d), "uniform", xavier(d, h * (nope + rope))),
            (a + "kv_a_proj.weight", (r + rope, d), "uniform", xavier(d, r + rope)),
            (a + "kv_a_norm.weight", (r,), "ones", 1.0),
            (a + "kv_b_proj.weight", (h * (nope + vd), r), "uniform", xavier(r, h * (nope + vd))),
            (a + "o_proj.weight", (d, h * vd), "uniform", out_std),
        ]
        if i < m["first_k_dense_replace"]:
            specs.append((p + "ffn_block.norm.weight", (d,), "ones", 1.0))
            specs += swiglu(p + "ffn_block.swiglu.", m["dense_d_ffn"])
            continue
        mo = p + "moe_block.moe."
        specs += [
            (p + "moe_block.norm.weight", (d,), "ones", 1.0),
            (mo + "router.router.weight", (e, d), "uniform", xavier(d, e)),
            (mo + "router.router.bias", (e,), "zeros", 0.0),
            (mo + "experts.w_gate", (e, d, f), "uniform", xavier(d, f)),
            (mo + "experts.w_up", (e, d, f), "uniform", xavier(d, f)),
            (mo + "experts.w_down", (e, f, d), "uniform", out_std),
        ]
        if m["n_shared_experts"]:
            specs += swiglu(mo + "shared.", m["n_shared_experts"] * f)
    specs.append(("norm.weight", (d,), "ones", 1.0))
    specs.append(("lm_head.weight", (v, d), "uniform", 0.02 * std_uniform))
    return specs


def make_params(m: dict, seed: int, dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """Every parameter as a view of one flat buffer on ``device``, one
    uniform draw of a ``torch.Generator`` seeded by ``seed`` (the same seed,
    dtype and device give the same bits), scaled leaf by leaf."""
    specs = param_specs(m)
    total = sum(math.prod(shape) for _, shape, _, _ in specs)
    gen = torch.Generator(device=device).manual_seed(int(seed) % SEED_MOD)
    flat = torch.empty(total, dtype=dtype, device=device)
    out, off = {}, 0
    with torch.no_grad():
        flat.uniform_(-1.0, 1.0, generator=gen)
        for name, shape, init, scale in specs:
            n = math.prod(shape)
            view = flat[off:off + n].view(shape)
            if init == "ones":
                view.fill_(1.0)
            elif init == "zeros":
                view.zero_()
            else:
                view.mul_(scale)
            out[name] = view
            off += n
    return out


class DeepSeekV2Reference:
    """The reference over a parameter dict (names as the port's state dict;
    fp32 or bf16 tensors) and a config's model section ``m``."""

    def __init__(self, m: dict, params: Dict[str, torch.Tensor], precision: str = "fp32"):
        if precision not in ("fp32", "fp8", "bf16"):
            raise ValueError(f"unknown precision {precision!r}")
        no_tf32()
        self._round = ROUNDING.get(precision)
        self.m = m
        self.p = params
        self.scale = softmax_scale(m)
        self._fp32: Dict[str, torch.Tensor] = {}  # the current layer's weights, raised

    # ------------------------------------------------------------ pieces

    def w(self, name: str) -> torch.Tensor:
        got = self._fp32.get(name)
        return got if got is not None else self.p[name].float()

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """x as the program holds it in its compute dtype (the identity in fp32)."""
        return x if self._round is None else _Round.apply(x, self._round)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)

    def linear(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return self.q(self.mm(x, self.w(name).t()))

    def rms_norm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        rms = torch.sqrt(x.square().mean(dim=-1, keepdim=True) + self.m["rms_norm_eps"])
        return self.q(self.w(name) * (x / rms))

    def cos_sin(self, t: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(cos, sin) [T, rope/2] at positions 0..T-1."""
        m, rd = self.m, self.m["qk_rope_head_dim"]
        factor = m.get("yarn_factor", 1.0)
        if factor > 1:
            inv = yarn_inv_freq(rd, m["rope_base"], factor, m["yarn_original_max_position"],
                                m["yarn_beta_fast"], m["yarn_beta_slow"], device)
        else:
            inv = 1.0 / m["rope_base"] ** (torch.arange(0, rd, 2, dtype=torch.float32,
                                                        device=device) / rd)
        ang = torch.arange(t, dtype=torch.float32, device=device)[:, None] * inv
        c, s = torch.cos(ang), torch.sin(ang)
        if factor > 1:
            f = (yarn_mscale(factor, m.get("yarn_mscale", 1.0))
                 / yarn_mscale(factor, m.get("yarn_mscale_all_dim", 0.0)))
            c, s = c * f, s * f
        return c, s

    @staticmethod
    def rope(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        """Interleaved RoPE on [T, H, d] by (cos, sin) [T, d/2]."""
        c, s = c[:, None, :], s[:, None, :]
        x1, x2 = x[..., 0::2], x[..., 1::2]
        return torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).reshape(x.shape)

    def attention(self, x: torch.Tensor, i: int) -> torch.Tensor:
        m = self.m
        h, r = m["num_heads"], m["kv_lora_rank"]
        nope, rd, vd = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]
        t = x.shape[0]
        pre = f"layers.{i}.attn_block.attn."
        q = self.linear(x, pre + "q_proj.weight").reshape(t, h, nope + rd)
        kv_a = self.linear(x, pre + "kv_a_proj.weight")
        c_kv = self.rms_norm(kv_a[:, :r], pre + "kv_a_norm.weight")
        cos, sin = self.cos_sin(t, x.device)
        q_pe = self.q(self.rope(q[..., nope:], cos, sin))
        k_pe = self.q(self.rope(kv_a[:, None, r:], cos, sin))  # [T, 1, rope]
        kv = self.linear(c_kv, pre + "kv_b_proj.weight").reshape(t, h, nope + vd)
        qh = torch.cat([q[..., :nope], q_pe], dim=-1).permute(1, 0, 2)  # h t d
        kh = torch.cat([kv[..., :nope], k_pe.expand(t, h, rd)], dim=-1).permute(1, 0, 2)
        vh = kv[..., nope:].permute(1, 0, 2)
        out = torch.empty(h, t, vd, device=x.device)
        pos = torch.arange(t, device=x.device)
        for q0 in range(0, t, QUERY_BLOCK):
            q1 = min(t, q0 + QUERY_BLOCK)
            mask = pos[None, :q1] <= pos[q0:q1, None]
            sc = self.mm(qh[:, q0:q1], kh[:, :q1].transpose(-1, -2)) * self.scale
            probs = torch.softmax(torch.where(mask, sc, MASK_VALUE), dim=-1)
            out[:, q0:q1] = self.q(self.mm(probs, vh[:, :q1]))
        return self.linear(out.permute(1, 0, 2).reshape(t, h * vd), pre + "o_proj.weight")

    def swiglu(self, x: torch.Tensor, pre: str) -> torch.Tensor:
        gate = self.linear(x, pre + "w_gate.weight")
        up = self.linear(x, pre + "w_up.weight")
        return self.linear(self.q(F.silu(gate) * up), pre + "w_down.weight")

    def moe(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """Layer i's routed experts, each on its routed rows, and the shared
        experts on every token, over tokens x [T, d]."""
        m = self.m
        pre = f"layers.{i}.moe_block.moe."
        e, k = m["num_experts"], m["top_k"]
        logits = x @ self.w(pre + "router.router.weight").t() + self.w(pre + "router.router.bias")
        probs = torch.softmax(logits, dim=-1)
        vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        vals, idx = vals[:, :k], idx[:, :k]
        if m.get("norm_topk_prob", True):
            vals = vals / vals.sum(dim=-1, keepdim=True)
        weights = self.q(vals * m.get("routed_scaling_factor", 1.0))
        out = torch.zeros_like(x)
        wg, wu, wd = (self.w(pre + "experts." + s) for s in ("w_gate", "w_up", "w_down"))
        for j in range(e):
            rows, slot = torch.nonzero(idx == j, as_tuple=True)
            if rows.numel() == 0:
                continue
            xe = x[rows]
            gate = self.q(self.mm(xe, wg[j]))
            up = self.q(self.mm(xe, wu[j]))
            y = self.q(self.mm(self.q(F.silu(gate) * up), wd[j]))
            out = out.index_add(0, rows, self.q(y * weights[rows, slot][:, None]))
        out = self.q(out)
        if m.get("n_shared_experts"):
            out = self.q(out + self.swiglu(x, pre + "shared."))
        return out

    def layer(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """Layer i over one sequence's residual stream x [T, d]."""
        pre = f"layers.{i}."
        x = self.q(x + self.attention(self.rms_norm(x, pre + "attn_block.norm.weight"), i))
        if i < self.m["first_k_dense_replace"]:
            out = self.swiglu(self.rms_norm(x, pre + "ffn_block.norm.weight"),
                              pre + "ffn_block.swiglu.")
        else:
            out = self.moe(self.rms_norm(x, pre + "moe_block.norm.weight"), i)
        return self.q(x + out)

    # ----------------------------------------------------------- entries

    @torch.no_grad()
    def hidden_all(self, seqs: List[torch.Tensor]) -> List[torch.Tensor]:
        """Post-norm hidden states [T_s, d] of each sequence ``seqs[s]``
        [T_s], each alone and causal over itself; the layers walked once
        for all of them, each layer's weights raised to fp32 once."""
        xs = [self.q(self.p["token_embed.weight"][ids.long()].float()) for ids in seqs]
        for i in range(self.m["num_layers"]):
            pre = f"layers.{i}."
            self._fp32 = {k: v.float() for k, v in self.p.items() if k.startswith(pre)}
            xs = [self.layer(x, i) for x in xs]
            self._fp32 = {}
        return [self.rms_norm(x, "norm.weight") for x in xs]

    @torch.no_grad()
    def readout(self, hidden: torch.Tensor) -> torch.Tensor:
        """fp32 logits [T, V] of post-norm hidden states [T, d]."""
        return self.mm(hidden, self.w("lm_head.weight").t())

    @torch.no_grad()
    def logits(self, ids: torch.Tensor) -> torch.Tensor:
        """fp32 logits [T, V] of one sequence ``ids`` [T], causal over it."""
        return self.readout(self.hidden_all([ids])[0])
