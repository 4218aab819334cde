"""The plain reference of Mellum2-12B-A2.5B (and of any model the port's
``HybridModelArgs`` states): its forward's logits in plain PyTorch and
float32 (the caller turns TF32 off, ``reference/model.no_tf32``), with no
kernel, cache or batching of the program's, and the seed's weights under
the port's state-dict names.

It follows the published config
(huggingface.co/JetBrains/Mellum2-12B-A2.5B-Instruct, config.json) as the
configuration's ``model`` section states it:

  token embedding -> N x [x + Attn_i(RMSNorm(x)) -> x + MoE(RMSNorm(x))]
  -> RMSNorm -> untied readout

Layer i attends by its kind (``layer_types[i]``): 'sliding_attention'
layers see keys with 0 <= q - k <= ``left_window`` (HF's sliding_window
1024: q - k < 1024) and rotate by RoPE at ``rope_base``;
'full_attention' layers see every earlier key and rotate by YaRN (HF's
``_compute_yarn_parameters``: the inv_freq ramp between the plain and the
``yarn_factor``-interpolated frequencies over pairs low..high, cos and sin
times ``yarn_attention_factor``).  Grouped KV heads of width ``head_dim``
(decoupled from d_model / heads), fused q/k/v, no attention bias, no
QK-norm, softmax scale head_dim^-0.5.  The experts: a top-k softmax router
(fp32, ties to the lower expert, weights renormalised), SwiGLU experts run
on the rows routed to them alone, lossless.

Departures from the published model, all fixed relabelings or zeros:
  * RoPE rotates interleaved pairs (2i, 2i + 1), as the port does, where HF
    rotates halves (i, i + hd/2): a fixed permutation of each head's q/k
    rows, the same model under other weights;
  * the router has the port's bias, held at zero (the published gate has
    none);
  * the MTP head is left out: the config declares none, and serving reads
    the main head only.

Attention runs in blocks of ``QUERY_BLOCK`` queries (so an 8k sequence fits
in memory), each over the keys its rows may see.  ``precision`` 'fp8' and
'bf16' round where the program holds bf16, as ``reference/model.py`` does:
'fp8' is the control, 'bf16' for the record.  The weights may come in
bf16 (the dtype the program serves); each is taken to fp32 at its use, so
the values are the same and 24 GB need not be held twice.

Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.model import MASK_VALUE, ROUNDING, _Round

SEED_MOD = 1 << 63
SLIDING, FULL = "sliding_attention", "full_attention"
#: queries an attention block takes at once
QUERY_BLOCK = 1024


def head_dim(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["num_heads"]


def param_specs(m: dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, init, scale) of every parameter of the model section
    ``m``, under the port's state-dict names, by ``benchmark/weights.py``'s
    scheme: a uniform of each initializer's standard deviation, RMSNorm
    scales 1, the router's bias 0."""
    d, h, g, f = m["d_model"], m["num_heads"], m["query_groups"], m["d_ffn"]
    hd, e, layers, v = head_dim(m), m["num_experts"], m["num_layers"], m["vocab_size"]
    std_uniform = math.sqrt(3.0)
    depth = 1.0 / math.sqrt(layers / 6.0) if layers > 12 else 1.0

    def xavier(fan_in, fan_out):
        return math.sqrt(6.0 / (fan_in + fan_out)) * depth

    out_std = 0.02 / math.sqrt(2 * layers) * std_uniform
    specs = [("token_embed.weight", (v, d), "uniform", 0.02 * std_uniform)]
    for i in range(layers):
        p = f"layers.{i}."
        specs += [
            (p + "attn_block.norm.weight", (d,), "ones", 1.0),
            (p + "attn_block.attn.w_qkv.weight", ((h + 2 * g) * hd, d), "uniform",
             xavier(d, (h + 2 * g) * hd)),
            (p + "attn_block.attn.w_o.weight", (d, h * hd), "uniform", out_std),
            (p + "moe_block.norm.weight", (d,), "ones", 1.0),
            (p + "moe_block.moe.router.router.weight", (e, d), "uniform", xavier(d, e)),
            (p + "moe_block.moe.router.router.bias", (e,), "zeros", 0.0),
            (p + "moe_block.moe.experts.w_gate", (e, d, f), "uniform", xavier(d, f)),
            (p + "moe_block.moe.experts.w_up", (e, d, f), "uniform", xavier(d, f)),
            (p + "moe_block.moe.experts.w_down", (e, f, d), "uniform", out_std),
        ]
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


def yarn_inv_freq(hd: int, theta: float, factor: float, original: int, beta_fast: float,
                  beta_slow: float, device=None) -> torch.Tensor:
    """HF's YaRN inv_freq [hd/2] (``_compute_yarn_parameters``, truncated
    correction range)."""

    def corr_dim(rotations):
        return hd * math.log(original / (rotations * 2 * math.pi)) / (2 * math.log(theta))

    low = max(math.floor(corr_dim(beta_fast)), 0)
    high = min(math.ceil(corr_dim(beta_slow)), hd - 1)
    if low == high:
        high += 0.001
    extra = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd)
    inter = 1.0 / (factor * theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                                   device=device) / hd))
    ramp = torch.clamp((torch.arange(hd // 2, dtype=torch.float32, device=device) - low)
                       / (high - low), 0, 1)
    return inter * ramp + extra * (1 - ramp)


class MellumReference:
    """The reference over a parameter dict (names as the port's state dict;
    fp32 or bf16 tensors) and a config's model section ``m``."""

    def __init__(self, m: dict, params: Dict[str, torch.Tensor], precision: str = "fp32"):
        if precision not in ("fp32", "fp8", "bf16"):
            raise ValueError(f"unknown precision {precision!r}")
        self._round = ROUNDING.get(precision)
        self.m = m
        self.p = params
        self.hd = head_dim(m)
        scale = m.get("softmax_scale")
        self.scale = scale if scale is not None else 1.0 / math.sqrt(self.hd)
        self.types = list(m["layer_types"])

    # ------------------------------------------------------------ pieces

    def w(self, name: str) -> torch.Tensor:
        return self.p[name].float()

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

    def cos_sin(self, kind: str, t: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(cos, sin) [T, hd/2] of a layer kind at positions 0..T-1."""
        m, hd = self.m, self.hd
        yarn = kind == FULL and m.get("yarn_factor", 1.0) > 1
        if yarn:
            inv = yarn_inv_freq(hd, m["rope_base"], m["yarn_factor"],
                                m["yarn_original_max_position"], m["yarn_beta_fast"],
                                m["yarn_beta_slow"], device)
        else:
            inv = 1.0 / m["rope_base"] ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                                        device=device) / hd)
        ang = torch.arange(t, dtype=torch.float32, device=device)[:, None] * inv
        c, s = torch.cos(ang), torch.sin(ang)
        if yarn:
            f = m.get("yarn_attention_factor") or 1.0
            c, s = c * f, s * f
        return c, s

    @staticmethod
    def rope(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        """Interleaved RoPE on [T, H, hd] by (cos, sin) [T, hd/2]."""
        c, s = c[:, None, :], s[:, None, :]
        x1, x2 = x[..., 0::2], x[..., 1::2]
        return torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).reshape(x.shape)

    def attention(self, x: torch.Tensor, i: int) -> torch.Tensor:
        m, hd = self.m, self.hd
        h, g = m["num_heads"], m["query_groups"]
        n = h // g
        t = x.shape[0]
        pre = f"layers.{i}.attn_block.attn."
        qkv = self.linear(x, pre + "w_qkv.weight")
        q, k, v = torch.split(qkv, [h * hd, g * hd, g * hd], dim=-1)
        c, s = self.cos_sin(self.types[i], t, x.device)
        q = self.q(self.rope(q.reshape(t, h, hd), c, s))
        k = self.q(self.rope(k.reshape(t, g, hd), c, s))
        v = v.reshape(t, g, hd)
        lw = m["left_window"] if self.types[i] == SLIDING else -1
        qg = q.reshape(t, g, n, hd).permute(1, 2, 0, 3)  # g n t d
        kg, vg = k.permute(1, 0, 2), v.permute(1, 0, 2)  # g s d
        out = torch.empty(g, n, t, hd, device=x.device)
        pos = torch.arange(t, device=x.device)
        for q0 in range(0, t, QUERY_BLOCK):
            q1 = min(t, q0 + QUERY_BLOCK)
            k0 = max(0, q0 - lw) if lw >= 0 else 0
            qp, kp = pos[q0:q1, None], pos[None, k0:q1]
            mask = kp <= qp
            if lw >= 0:
                mask = mask & (qp - kp <= lw)
            sc = self.mm(qg[:, :, q0:q1], kg[:, None, k0:q1].transpose(-1, -2)) * self.scale
            probs = torch.softmax(torch.where(mask, sc, MASK_VALUE), dim=-1)
            out[:, :, q0:q1] = self.q(self.mm(probs, vg[:, None, k0:q1]))
        out = out.permute(2, 0, 1, 3).reshape(t, h * hd)
        return self.linear(out, pre + "w_o.weight")

    def moe(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """Layer i's experts over tokens x [T, d], each on its routed rows."""
        m = self.m
        pre = f"layers.{i}.moe_block.moe."
        e, k = m["num_experts"], m["top_k"]
        logits = x @ self.w(pre + "router.router.weight").t() + self.w(pre + "router.router.bias")
        probs = torch.softmax(logits, dim=-1)
        vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        vals, idx = vals[:, :k], idx[:, :k]
        weights = self.q(vals / vals.sum(dim=-1, keepdim=True))
        out = torch.zeros_like(x)
        wg, wu, wd = (self.p[pre + "experts." + s] for s in ("w_gate", "w_up", "w_down"))
        for j in range(e):
            rows, slot = torch.nonzero(idx == j, as_tuple=True)
            if rows.numel() == 0:
                continue
            xe = x[rows]
            gate = self.q(self.mm(xe, wg[j].float()))
            up = self.q(self.mm(xe, wu[j].float()))
            y = self.q(self.mm(self.q(F.silu(gate) * up), wd[j].float()))
            out = out.index_add(0, rows, self.q(y * weights[rows, slot][:, None]))
        return self.q(out)

    # ----------------------------------------------------------- entries

    @torch.no_grad()
    def hidden(self, ids: torch.Tensor) -> torch.Tensor:
        """Post-norm hidden states [T, d] of one sequence ``ids`` [T]."""
        x = self.q(self.p["token_embed.weight"][ids.long()].float())
        for i in range(self.m["num_layers"]):
            pre = f"layers.{i}."
            a = self.attention(self.rms_norm(x, pre + "attn_block.norm.weight"), i)
            x = self.q(x + a)
            out = self.moe(self.rms_norm(x, pre + "moe_block.norm.weight"), i)
            x = self.q(x + out)
        return self.rms_norm(x, "norm.weight")

    @torch.no_grad()
    def logits(self, ids: torch.Tensor) -> torch.Tensor:
        """fp32 logits [T, V] of one sequence ``ids`` [T], causal over it."""
        return self.mm(self.hidden(ids), self.w("lm_head.weight").t())
