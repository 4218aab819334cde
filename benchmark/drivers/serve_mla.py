"""Serving cells of models that attend by multi-head latent attention
(``LatentModelArgs``: MLA over a latent paged pool, shared and routed
experts, leading dense layers): the port's ``ServingEngine`` under the
traffic's closed loop, run by ``drivers/serve_hybrid.py``'s ``run`` and
checked by its ``finish``, with this model's pieces in their place:

  * the weights and the reference are ``reference/deepseek_v2.py``'s;
  * the work is counted by ``benchmark/work_mla.py``: a decode forward's
    K9 calls (each row's latent vectors read once for its 16 heads) and
    its whole forward, a prefill decompressed;
  * every step reads the tally of K9's launches and of its plain
    version's calls (host counters on the wrapper, no sync; the plain
    version runs on CPU tensors alone, and on the card a call K9 does not
    take raises);
  * the check's reference walks the checked sequences layer by layer (each
    layer's weights raised to fp32 once for all of them), each sequence
    still alone, with no cache or batching.

A traced run probes the engine after the window (``spans.probe_serve``)
for the decode forward's device time under ``attn.mla``.
"""

from __future__ import annotations

import types

import torch

from benchmark import harness, work, work_mla
from benchmark.drivers import serve_hybrid
from benchmark.reference import sampling as ref_sampling
from benchmark.reference.deepseek_v2 import DeepSeekV2Reference, make_params


def _rebound(fn, **names):
    """``fn`` reading ``names`` in place of the globals of its module."""
    return types.FunctionType(fn.__code__, dict(fn.__globals__, **names), fn.__name__,
                              fn.__defaults__, fn.__closure__)


def _tally():
    """(K9 launches, plain-version calls) so far, from the wrapper."""
    from vats_tpu_torch.ops.mla_decode import mla_decode_attention as k9

    return k9.launches, k9.plain.launches


class LatentDrive(serve_hybrid.HybridDrive):
    """``HybridDrive`` with the latent model's work counts and each step's
    K9 tally."""

    @staticmethod
    def zero() -> dict:
        return dict(serve_hybrid.HybridDrive.zero(), mla_decode_least_s=0.0, k9_launches=0,
                    k9_plain_calls=0)

    def step(self):
        before = _tally()
        t, raw = super().step()
        after = _tally()
        return t, raw + (after[0] - before[0], after[1] - before[1])

    def step_work(self, new_tokens, k, n_prefill, decode_rows, prefills, dead, used,
                  k9_launches, k9_plain) -> dict:
        m = self.m
        layers = m["num_layers"]
        fpt = work_mla.flops_per_token(m)
        kvb = work_mla.latent_bytes_per_token(m)
        d = self.zero()
        d.update(output_tokens=new_tokens, decode_forwards=k, k9_launches=k9_launches,
                 k9_plain_calls=k9_plain)
        if used > 0:
            d["kv_dead_share_sum"], d["kv_share_steps"] = dead / used, 1
        for j in range(k):
            lens = [L + j for L, n in decode_rows if j < n]
            if not lens:
                continue
            d["decode_rows"] += len(lens)
            keys = [L + 1 for L in lens]  # the settled vectors and the current one
            nb, nf = work_mla.mla_decode_cost(m, keys)
            d["mla_decode_least_s"] += layers * work.least_s(nb, nf)
            flops = len(lens) * fpt + layers * work_mla.decode_attn_flops(m, sum(keys))
            touched = min(m["num_experts"], len(lens) * m["top_k"])
            nbytes = work_mla.weight_bytes(m, touched) + sum(keys) * kvb
            d["forward_least_s"] += work.least_s(nbytes, flops)
        if n_prefill:
            flops, tail_total = 0.0, 0
            nbytes = n_prefill * work_mla.weight_bytes(m, m["num_experts"])
            for i in prefills:
                plen = len(self.t.requests[i].prompt)
                tail_total += plen
                pairs = plen * (plen + 1) // 2
                flops += plen * fpt + layers * work_mla.prefill_attn_flops(m, pairs)
                nbytes += plen * kvb
            d["prefill_tokens"] = tail_total
            d["forward_least_s"] += work.least_s(nbytes, flops)
        return d


def build_model(m: dict, seed: int, device, rec: harness.Recorder):
    """The port's TextLM over the seed's weights (set-up phases 'weights'
    and 'model')."""
    from vats_tpu_torch.configs.nlp import LatentModelArgs
    from vats_tpu_torch.models.text_lm import TextLM

    with rec.phase("weights"):
        params = make_params(m, seed, getattr(torch, m["param_dtype"]), device)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
    with rec.phase("model"):
        model = TextLM(LatentModelArgs(**m), device="meta")
        model.load_state_dict(params, assign=True)
    return model.eval()


def served_gaps(m: dict, seed: int, device, checked, rule: dict, fp8_control: bool = False):
    """``drivers/serve.served_gaps`` under ``DeepSeekV2Reference``: per
    served position, the gap of the served token under the fp32 reference;
    with ``fp8_control`` also the gaps of the control's tokens."""
    params = make_params(m, seed, getattr(torch, m["param_dtype"]), device)
    args = (rule["temperature"], int(rule["top_k"]), rule["top_p"], int(rule["kmax"]))
    seqs = [torch.tensor(prompt + served[:-1], dtype=torch.long, device=device)
            for prompt, served, _ in checked]
    ref = DeepSeekV2Reference(m, params)
    hidden = ref.hidden_all(seqs)
    low_hidden = None
    if fp8_control:
        low = DeepSeekV2Reference(m, params, precision="fp8")
        low_hidden = low.hidden_all(seqs)
    prog, ctrl = [], []
    for i, (prompt, served, draw_seed) in enumerate(checked):
        logits = ref.readout(hidden[i][len(prompt) - 1:])
        floor = (logits.max(-1).values if draw_seed is None
                 else ref_sampling.set_floor(logits, *args))
        toks = [torch.as_tensor(served, dtype=torch.long, device=device)]
        if low_hidden is not None:
            lo = low.readout(low_hidden[i][len(prompt) - 1:])
            if draw_seed is None:
                toks.append(lo.argmax(-1))
            else:
                pos = torch.arange(len(prompt), len(prompt) + len(served), device=device)
                toks.append(ref_sampling.draw(lo, *args, draw_seed, pos))
            del lo
        for out, tok in zip((prog, ctrl), toks):
            g = floor - logits.gather(1, tok[:, None])[:, 0]
            out.append(g.clamp(min=0).cpu().numpy())
        del logits
    del params, ref, hidden, low_hidden
    return prog + ctrl


finish = _rebound(serve_hybrid.finish, served_gaps=served_gaps)
_run = _rebound(serve_hybrid.run, build_model=build_model, HybridDrive=LatentDrive,
                finish=finish)


def run(ctx) -> dict:
    """One run of a latent serving cell; ``ctx`` as ``benchmark/run.py``
    makes it."""
    # a program without latent attention fails here, before set-up
    from vats_tpu_torch.configs.nlp import LatentModelArgs  # noqa: F401

    return _run(ctx)
