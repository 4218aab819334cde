"""The plain reference of the MoE TextLM: its forward, loss, gradients and
optimizer step, in plain PyTorch and float32 (TF32 off), with no kernel,
cache or batching of the program's.

It follows the model that ``benchmark/configs/*.json`` state (the JAX
package's TextLM, which the port implements):

  token embedding -> dropout -> N x [x + dropout(Attn(RMSNorm(x)))
  -> x + dropout(dropout(MoE(RMSNorm(RMSNorm(x)))))] -> RMSNorm
  -> tied readout

with fused q/k/v projections, L2-normalised q and k, interleaved 1-D RoPE,
grouped KV heads, causal and segment masks; a top-k router (fp32 softmax,
ties to the lower expert, weights renormalised, a coefficient-of-variation
aux loss) over SwiGLU experts, and where a capacity is set the slot-major
keep rule (an assignment is dropped once its expert holds ``capacity``
earlier ones, every token's first choice before any second).  Dropout
masks come from ``dropout_hash`` (a frozen copy of the port's rule), so a
step seed gives the same masks as in the program.

``precision`` other than 'fp32' rounds every tensor where the program holds
its compute dtype (the configurations state bfloat16): the embedding rows,
each weight as a product takes it, each product's and norm's output, q and
k after their norm and rotation, attention's probabilities and output, the
router's weights, the experts' intermediates, the dropout outputs and the
residual stream; the fp32 islands (norm statistics, softmax, the router's
logits, the loss) stay fp32.  The gradient is rounded at the same points in
the backward.  'fp8' (float8 e4m3 under a per-tensor scale) is the control,
the nearest step below bfloat16, which the comparison has to fail; 'bf16'
follows the program's own rounding and is for the record only.

Nothing here imports the program; it reads the weights that
``benchmark/weights.py`` makes and the batches the traffic generator makes.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference.dropout_hash import (
    SITE_ATTN,
    SITE_EMBED,
    SITE_MOE_BLOCK,
    SITE_MOE_LAYER,
    dropout,
)

IGNORE_INDEX = -100
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
FP8_MAX = 448.0


def no_tf32():
    """Full fp32 products on the card (the reference's precision)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in fp32."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    s = FP8_MAX / amax
    return (x * s).to(torch.float8_e4m3fn).to(torch.float32) / s


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


ROUNDING = {"fp8": _fp8, "bf16": _bf16}


class _Round(torch.autograd.Function):
    """A rounding in the forward whose gradient is rounded alike."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


class Reference:
    """The reference over a parameter dict (names as the port's state dict)
    and a config's model section ``m``."""

    def __init__(self, m: dict, params: Dict[str, torch.Tensor], precision: str = "fp32",
                 remat: bool = False):
        if precision not in ("fp32", "fp8", "bf16"):
            raise ValueError(f"unknown precision {precision!r}")
        self._round = ROUNDING.get(precision)
        self.m = m
        self.p = params
        self.precision = precision
        self.remat = remat
        d, h = m["d_model"], m["num_heads"]
        self.hd = d // h
        scale = m.get("softmax_scale")
        self.scale = scale if scale is not None else 1.0 / math.sqrt(self.hd)

    # ------------------------------------------------------------ pieces

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """x as the program holds it in its compute dtype (the identity in fp32)."""
        return x if self._round is None else _Round.apply(x, self._round)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)

    def linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.q(self.mm(x, w.t()))

    def rms_norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        rms = torch.sqrt(x.square().mean(dim=-1, keepdim=True) + self.m["rms_norm_eps"])
        return self.q(w * (x / rms))

    @staticmethod
    def l2_normalize(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        sq = x.square().sum(dim=-1, keepdim=True)
        return x / torch.sqrt(torch.clamp(sq, min=eps * eps))

    def rope(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """Interleaved 1-D RoPE on [B, T, H, hd] at ``positions`` [T]."""
        hd = x.shape[-1]
        inv = 1.0 / (self.m["rope_base"] ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                                           device=x.device) / hd))
        ang = positions.float()[:, None] * inv
        c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., 0::2], x[..., 1::2]
        return torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).reshape(x.shape)

    def attention(self, x, i, segment_ids, padding_mask):
        m, hd = self.m, self.hd
        h, g = m["num_heads"], m["query_groups"]
        b, t, _ = x.shape
        pre = f"layers.{i}.attn_block."
        qkv = self.linear(x, self.p[pre + "attn.w_qkv.weight"])
        q, k, v = torch.split(qkv, [h * hd, g * hd, g * hd], dim=-1)
        q = q.reshape(b, t, h, hd)
        k = k.reshape(b, t, g, hd)
        v = v.reshape(b, t, g, hd)
        if m.get("use_qk_norm", True):
            q, k = self.q(self.l2_normalize(q)), self.q(self.l2_normalize(k))
        pos = torch.arange(t, device=x.device)
        q, k = self.q(self.rope(q, pos)), self.q(self.rope(k, pos))
        n = h // g
        qg = q.reshape(b, t, g, n, hd).permute(0, 2, 3, 1, 4)  # b g n t d
        kg = k.permute(0, 2, 3, 1)[:, :, None]  # b g 1 d s
        vg = v.permute(0, 2, 1, 3)[:, :, None]  # b g 1 s d
        scores = self.mm(qg, kg) * self.scale  # b g n t s
        mask = pos[None, :] <= pos[:, None]
        if m.get("left_window", -1) >= 0:
            mask = mask & ((pos[:, None] - pos[None, :]) <= m["left_window"])
        mask = mask[None].expand(b, t, t)
        if segment_ids is not None:
            mask = mask & (segment_ids[:, :, None] == segment_ids[:, None, :])
        if padding_mask is not None:
            mask = mask & padding_mask.bool()[:, None, :]
        scores = torch.where(mask[:, None, None], scores, MASK_VALUE)
        probs = torch.softmax(scores, dim=-1)
        out = self.q(self.mm(probs, vg))  # b g n t d
        out = out.permute(0, 3, 1, 2, 4).reshape(b, t, h * hd)
        return self.linear(out, self.p[pre + "attn.w_o.weight"])

    def moe(self, x, i, train: bool):
        """(out [N, d], aux) of layer i's experts over tokens x [N, d]."""
        m = self.m
        pre = f"layers.{i}.moe_block.moe."
        n, d = x.shape
        e, k = m["num_experts"], m["top_k"]
        logits = x @ self.p[pre + "router.router.weight"].t() + self.p[pre + "router.router.bias"]
        probs = torch.softmax(logits, dim=-1)
        vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        vals, idx = vals[:, :k], idx[:, :k]
        weights = vals / vals.sum(dim=-1, keepdim=True)
        aux = torch.zeros((), device=x.device)
        if train:
            mass = probs.sum(dim=0)
            frac = mass / mass.sum()
            aux = torch.sqrt((frac - frac.mean()).square().mean() + 1e-12) / frac.mean()
        # slot-major order: every token's first choice, then every second
        ids = idx.t().reshape(-1)
        onehot = F.one_hot(ids, e)
        pos = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(-1)
        cf = m.get("capacity_factor", -1.0)
        if cf > 0:
            cap = min(n, int(math.ceil(n * k / e * cf)))
            cap = min(max(8, -(-cap // 8) * 8), n * k)
            kept = pos < cap
        else:
            kept = torch.ones_like(ids, dtype=torch.bool)
        tok = torch.arange(n, device=x.device).repeat(k)
        w = self.q(weights.t().reshape(-1))
        out = torch.zeros_like(x)
        wg, wu, wd = (self.p[pre + "experts." + s] for s in ("w_gate", "w_up", "w_down"))
        for j in range(e):
            sel = torch.nonzero(kept & (ids == j)).flatten()
            if sel.numel() == 0:
                continue
            rows = tok[sel]
            xe = x[rows]
            gate, up = self.q(self.mm(xe, wg[j])), self.q(self.mm(xe, wu[j]))
            y = self.q(self.mm(self.q(F.silu(gate) * up), wd[j]))
            out = out.index_add(0, rows, self.q(y * w[sel][:, None]))
        return self.q(out), aux

    def block(self, x, i, seed, segment_ids, padding_mask, train: bool):
        rate = self.m["dropout"] if train else 0.0
        pre = f"layers.{i}."
        a = self.attention(self.rms_norm(x, self.p[pre + "attn_block.norm.weight"]), i,
                           segment_ids, padding_mask)
        x = self.q(x + self.q(dropout(a, rate, seed, layer=i, site=SITE_ATTN)))
        hdn = self.rms_norm(x, self.p[pre + "moe_block.norm.weight"])
        if self.m.get("moe_double_norm", True):
            hdn = self.rms_norm(hdn, self.p[pre + "moe_block.moe.norm.weight"])
        b, t, d = hdn.shape
        out, aux = self.moe(hdn.reshape(b * t, d), i, train)
        out = self.q(dropout(out.reshape(b, t, d), rate, seed, layer=i, site=SITE_MOE_LAYER))
        out = self.q(dropout(out, rate, seed, layer=i, site=SITE_MOE_BLOCK))
        return self.q(x + out), aux

    # ----------------------------------------------------------- entries

    def hidden(self, ids: torch.Tensor, *, seed: Optional[int] = None,
               segment_ids=None, padding_mask=None, train: bool = False):
        """(post-norm hidden states [B, T, d], summed aux loss)."""
        rate = self.m["dropout"] if train else 0.0
        x = self.q(self.p["token_embed.weight"][ids.long()])
        x = self.q(dropout(x, rate, seed, layer=-1, site=SITE_EMBED))
        total_aux = torch.zeros((), device=x.device)
        for i in range(self.m["num_layers"]):
            if self.remat and torch.is_grad_enabled():
                x, aux = checkpoint(self.block, x, i, seed, segment_ids, padding_mask, train,
                                    use_reentrant=False, preserve_rng_state=False)
            else:
                x, aux = self.block(x, i, seed, segment_ids, padding_mask, train)
            total_aux = total_aux + aux
        return self.rms_norm(x, self.p["norm.weight"]), total_aux

    def readout(self) -> torch.Tensor:
        return self.p.get("lm_head.weight", self.p["token_embed.weight"])

    @torch.no_grad()
    def logits(self, ids: torch.Tensor) -> torch.Tensor:
        """fp32 logits [T, V] of one sequence ``ids`` [T] (no dropout,
        causal over the whole sequence)."""
        h, _ = self.hidden(ids[None])
        return self.mm(h[0], self.readout().t())

    def loss(self, batch: Dict[str, torch.Tensor], seed: int, aux_weight: float, chunk: int = 512):
        """(objective, lm loss, aux) of one training micro-batch: the mean
        cross-entropy over the labelled tokens plus ``aux_weight`` x aux."""
        h, aux = self.hidden(batch["input_ids"], seed=seed,
                             segment_ids=batch.get("segment_ids"),
                             padding_mask=batch.get("padding_mask"), train=True)
        labels = batch["labels"].long()
        w = self.readout()
        b, t, d = h.shape
        total = torch.zeros((), device=h.device)
        for c0 in range(0, t, chunk):
            def nll(hc, yc):
                logits = self.mm(hc, w.t())  # fp32 logits from operands as held
                valid = yc != IGNORE_INDEX
                lse = torch.logsumexp(logits, dim=-1)
                tgt = torch.gather(logits, -1, torch.where(valid, yc, 0)[..., None])[..., 0]
                return torch.where(valid, lse - tgt, 0.0).sum()
            hc, yc = h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
            total = total + (checkpoint(nll, hc, yc, use_reentrant=False)
                             if torch.is_grad_enabled() else nll(hc, yc))
        lm = total / (labels != IGNORE_INDEX).sum().clamp(min=1)
        return lm + aux_weight * aux, lm, aux


# --------------------------------------------------------------- training


def warmup_cosine(base_lr: float, warmup: int, total: int, cycles: float):
    def lr(step: int) -> float:
        if step < warmup:
            return base_lr * step / max(1.0, warmup)
        progress = (step - warmup) / max(1.0, total - warmup)
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * 2.0 * cycles * progress))
    return lr


class ReferenceTrainer:
    """Gradient accumulation (the mean of ``accum`` micro-batches' gradients),
    a global-norm clip, AdamW with a bf16 first moment (updated in fp32,
    stored rounded, decayed in bf16) and a warmup-cosine learning rate read
    at the count of applied updates, over fp32 parameters.  Returns per
    micro-step losses and keeps the first gradient and the parameters'
    starting values for the comparison."""

    def __init__(self, ref: Reference, t: dict, accum: int, num_training_steps: int):
        self.ref = ref
        self.t = t
        self.accum = accum
        self.params = ref.p
        for p in self.params.values():
            p.requires_grad_(True)
        self.lr = warmup_cosine(t["learning_rate"], int(t["warmup_ratio"] * num_training_steps),
                                num_training_steps, t["num_cycles"])
        mu_dtype = getattr(torch, t.get("adam_mu_dtype") or "float32")
        self.mu = {n: torch.zeros_like(p, dtype=mu_dtype) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.acc = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.count = 0
        self.micro = 0
        self.first_grad: Optional[Dict[str, float]] = None

    def micro_step(self, batch: Dict[str, torch.Tensor], seed: int) -> float:
        for p in self.params.values():
            p.grad = None
        obj, _, _ = self.ref.loss(batch, seed, self.t["aux_loss_weight"])
        obj.backward()
        with torch.no_grad():
            n_acc = self.micro % self.accum
            for name, p in self.params.items():
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                self.acc[name] += (g - self.acc[name]) / (n_acc + 1)
            if self.first_grad is None:
                self.first_grad = self._first_grad()
            self.micro += 1
            if self.micro % self.accum == 0:
                self._apply()
        return float(obj.detach())

    def _first_grad(self) -> Dict[str, float]:
        """Per-leaf norms of the first gradient as the optimizer gets it:
        the accumulator after one micro-step (with accumulation), else the
        clipped gradient."""
        if self.accum > 1:
            return {n: float(a.norm()) for n, a in self.acc.items()}
        gn = torch.linalg.vector_norm(torch.stack([a.norm() for a in self.acc.values()]))
        scale = min(1.0, self.t["clip_grad_norm"] / max(float(gn), 1e-12))
        return {n: float(a.norm()) * scale for n, a in self.acc.items()}

    def _apply(self):
        t = self.t
        b1, b2 = t["betas"]
        grads = self.acc
        gn = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in grads.values()])))
        if not math.isfinite(gn):
            raise FloatingPointError("reference gradient norm is not finite")
        scale = min(1.0, t["clip_grad_norm"] / max(gn, 1e-12))
        n = self.count + 1
        bc1, bc2 = 1.0 - b1 ** n, 1.0 - b2 ** n
        lr = self.lr(self.count)
        for name, p in self.params.items():
            g = grads[name] * scale
            mu = self.mu[name]
            mu32 = (mu * torch.tensor(b1, dtype=mu.dtype)).float() + (1.0 - b1) * g
            nu = self.nu[name]
            nu.mul_(b2).add_((1.0 - b2) * (g * g))
            u = (mu32 / bc1) / (torch.sqrt(nu / bc2) + t["epsilon"])
            if t["weight_decay"]:
                u = u + t["weight_decay"] * p
            p.add_(u * -lr)
            mu.copy_(mu32)
            grads[name].zero_()
        self.count += 1


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], names: Sequence[str],
             median: bool = False) -> float:
    """The worst leaf's (with ``median``, the median leaf's) |program norm -
    reference norm| over the larger of the reference's norm of that leaf
    and of the median leaf."""
    if not names:
        return float("nan")
    vals = sorted(ref[n] for n in names)
    mid = vals[len(vals) // 2]
    gaps = sorted(abs(prog[n] - ref[n]) / max(ref[n], mid, 1e-30) for n in names)
    return gaps[len(gaps) // 2] if median else gaps[-1]


def moving_leaves(first_grad: Dict[str, float], frac: float = 1e-3) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding:
    above ``frac`` of the median leaf's."""
    vals = sorted(first_grad.values())
    median = vals[len(vals) // 2]
    return [n for n, v in first_grad.items() if v > frac * median]
