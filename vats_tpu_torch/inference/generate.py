"""Autoregressive generation: prefill, then a Python decode loop.

Counterpart of ``vats_tpu/inference/generate.py``:
  * :func:`generate`: dense KV cache (a sliding-window ring for windowed
    models), every row at the same buffer positions.
  * :func:`generate_paged`: paged KV cache, rows advance by their true
    lengths; K2 serves long fresh prefills and K1 every decode step (K4
    with ``kv_quant='int8'``).
  * :class:`TokenGenerator`: the tokenizer-facing wrapper, with int8
    weights (``quantize='int8'``, ``inference/quantize.QuantizedModel``)
    and int8 KV pages.

Every entry takes a ``TextLM`` or a ``QuantizedModel``.

The JAX package compiles the loop into one ``while_loop``.  Here one
decode step is a function of tensors that persist across steps (tokens,
validity, the unfinished rows, the next logits, the cache and a step
counter, all on the model's device), updated in place.  On the card the
first step runs eagerly as the warm-up and every later step replays it,
captured once per call as a CUDA graph (``inference/graphs.py``); on the CPU
every step runs eagerly.  The loop reads nothing back to the host except,
when an ``eos_token_id`` is set, whether any row is still unfinished, every
``graphs.FINISH_CHECK_EVERY`` steps: a step after every row has finished
changes neither tokens nor lengths, which are those the JAX loop, stopping
at once, returns.  Without an EOS a row that runs out of buffer stops
emitting tokens as in the JAX loop; the loop itself runs at most
``max_new_tokens`` steps.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vats_tpu_torch.configs.nlp import GenerationArgs, ModelArgs, layer_attention
from vats_tpu_torch.device import resolve_device, resolve_dtype
from vats_tpu_torch.inference.graphs import StepGraph, run_steps
from vats_tpu_torch.inference.sampling import sample_logits
from vats_tpu_torch.models.text_lm import TextLM
from vats_tpu_torch.nn.kv_cache import ring_slots_for_window
from vats_tpu_torch.inference.quantize import QuantizedModel
from vats_tpu_torch.ops.decode_attention import PagedKVCache


def _prepare(model, input_ids, attention_mask, pad_token_id, total_len):
    dev = model.device
    input_ids = input_ids.to(dev)
    b, t_prompt = input_ids.shape
    if attention_mask is None:
        attention_mask = input_ids != pad_token_id
    attention_mask = attention_mask.to(dev).bool()
    n = min(t_prompt, total_len)
    tokens = torch.full((b, total_len), pad_token_id, dtype=torch.int32, device=dev)
    tokens[:, :n] = input_ids[:, :n].to(torch.int32)
    valid = torch.zeros((b, total_len), dtype=torch.bool, device=dev)
    valid[:, :n] = attention_mask[:, :n]
    prompt_lens = attention_mask.sum(dim=1).to(torch.int32)
    return input_ids, attention_mask, tokens, valid, prompt_lens


def _on_card(model) -> bool:
    return model.device.type == "cuda"


@torch.no_grad()
def generate(
    model: TextLM,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor],
    generator: Optional[torch.Generator],
    *,
    max_new_tokens: int,
    temperature: Optional[float] = None,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    do_sample: bool = True,
    repetition_penalty: Optional[float] = None,
    pad_token_id: int = 0,
    eos_token_id: Optional[int] = None,
    total_len: Optional[int] = None,
    approx_top_k: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generate up to ``max_new_tokens`` after a right-padded prompt.

    input_ids [B, T_prompt]; attention_mask [B, T_prompt] bool or None.
    Runs on the model's device, decode steps as a replayed CUDA graph on the
    card.  Returns (tokens [B, total_len], lengths [B]) with lengths
    counting valid tokens (prompt + generated) per row."""
    sample = dict(temperature=temperature, top_k=top_k, top_p=top_p,
                  do_sample=do_sample, repetition_penalty=repetition_penalty,
                  approx_top_k=approx_top_k)
    tokens, lengths, _ = _generate(
        model, input_ids, attention_mask, generator, sample,
        max_new_tokens=max_new_tokens, pad_token_id=pad_token_id,
        eos_token_id=eos_token_id, total_len=total_len, use_graph=_on_card(model),
    )
    return tokens, lengths


@torch.no_grad()
def _generate(model, input_ids, attention_mask, generator, sample, *,
              max_new_tokens, pad_token_id, eos_token_id, total_len,
              use_graph: bool) -> Tuple[torch.Tensor, torch.Tensor, Optional[StepGraph]]:
    """:func:`generate`; ``use_graph=False`` runs every step eagerly (on the
    card, only to compare the two).  Also returns the step's graph."""
    b, t_prompt = input_ids.shape
    cfg = model.cfg
    if total_len is None:
        total_len = min(cfg.max_seq_len, t_prompt + max_new_tokens)
    num_new = min(max_new_tokens, max(0, total_len - t_prompt))
    input_ids, _, tokens, valid, prompt_lens = _prepare(
        model, input_ids, attention_mask, pad_token_id, total_len
    )

    # a ring holds the widest window, when every layer attends one (a window
    # not enforced in attention, or a full layer, would lose keys to a ring)
    windows = [layer_attention(cfg, i).left_window for i in range(cfg.num_layers)]
    lw = -1 if min(windows) < 0 else max(windows)
    if lw >= 0 and ring_slots_for_window(lw) < total_len:
        cache = model.init_cache(b, ring_slots_for_window(lw), ring=True)
    else:
        cache = model.init_cache(b, total_len)

    last_idx = torch.clamp(prompt_lens - 1, min=0)
    logits, cache, _ = model(
        input_ids, padding_mask=valid, cache=cache, readout_positions=last_idx
    )
    next_logits = logits[:, 0].clone()
    unfinished = torch.ones(b, dtype=torch.bool, device=tokens.device)
    col = torch.full((1,), t_prompt, dtype=torch.int64, device=tokens.device)

    def step():
        # every row writes column ``col``: a finished row writes a pad there,
        # not valid, as the buffers already hold
        nxt = sample_logits(generator, next_logits, generated_ids=tokens,
                            generated_valid=valid, **sample)
        nxt = torch.where(unfinished, nxt, pad_token_id).to(torch.int32)
        tokens.index_copy_(1, col, nxt[:, None])
        valid.index_copy_(1, col, unfinished[:, None])
        if eos_token_id is not None:
            unfinished.logical_and_(nxt != eos_token_id)
        logits, _, _ = model(nxt[:, None], padding_mask=valid, cache=cache)
        next_logits.copy_(logits[:, 0])
        col.add_(1)

    graph = run_steps(step, num_new, device=tokens.device, use_graph=use_graph,
                      unfinished=unfinished if eos_token_id is not None else None,
                      generator=generator)
    return tokens, valid.sum(dim=1).to(torch.int32), graph


@torch.no_grad()
def generate_paged(
    model: TextLM,
    input_ids: torch.Tensor,
    attention_mask: Optional[torch.Tensor],
    generator: Optional[torch.Generator],
    *,
    max_new_tokens: int,
    temperature: Optional[float] = None,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    do_sample: bool = True,
    repetition_penalty: Optional[float] = None,
    pad_token_id: int = 0,
    eos_token_id: Optional[int] = None,
    total_len: Optional[int] = None,
    page_size: int = 128,
    approx_top_k: bool = False,
    kv_quant: Optional[str] = None,
    prefill_row_chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ragged-batch generation over a paged KV cache.

    Rows advance by their true lengths (per-row page tables, lengths and
    RoPE positions).  Returns (tokens [B, total_len] laid out compactly per
    row, lengths [B]).  ``prefill_row_chunk`` runs the prompt forward in
    waves of that many rows sharing one page pool.  ``kv_quant='int8'``
    stores the pages in int8 with per-(token, group) scales; the current
    token always attends at full precision (K4).  Decode steps run as a
    replayed CUDA graph on the card."""
    sample = dict(temperature=temperature, top_k=top_k, top_p=top_p,
                  do_sample=do_sample, repetition_penalty=repetition_penalty,
                  approx_top_k=approx_top_k)
    tokens, lengths, _ = _generate_paged(
        model, input_ids, attention_mask, generator, sample,
        max_new_tokens=max_new_tokens, pad_token_id=pad_token_id,
        eos_token_id=eos_token_id, total_len=total_len, page_size=page_size,
        kv_quant=kv_quant, prefill_row_chunk=prefill_row_chunk,
        use_graph=_on_card(model),
    )
    return tokens, lengths


@torch.no_grad()
def _generate_paged(model, input_ids, attention_mask, generator, sample, *,
                    max_new_tokens, pad_token_id, eos_token_id, total_len,
                    page_size, kv_quant, prefill_row_chunk,
                    use_graph: bool) -> Tuple[torch.Tensor, torch.Tensor,
                                              Optional[StepGraph]]:
    """:func:`generate_paged`; ``use_graph=False`` runs every step eagerly
    (on the card, only to compare the two).  Also returns the step's graph."""
    if kv_quant not in (None, "int8"):
        raise ValueError(f"unsupported kv_quant mode: {kv_quant!r}")
    b, t_prompt = input_ids.shape
    cfg = model.cfg
    if total_len is None:
        total_len = min(cfg.max_seq_len, t_prompt + max_new_tokens)
    input_ids, attention_mask, tokens, valid, prompt_lens = _prepare(
        model, input_ids, attention_mask, pad_token_id, total_len
    )
    cache = PagedKVCache.create(
        num_layers=cfg.num_layers, batch_size=b, max_seq_len=total_len,
        kv_heads=cfg.query_groups, head_dim=cfg.head_dim, page_size=page_size,
        dtype=torch.int8 if kv_quant == "int8" else resolve_dtype(cfg.dtype),
        device=model.device,
    )
    last_idx = torch.clamp(prompt_lens - 1, min=0)
    if prefill_row_chunk is None or prefill_row_chunk >= b:
        logits, cache, _ = model(
            input_ids, padding_mask=attention_mask, paged_cache=cache,
            readout_positions=last_idx,
        )
        next_logits = logits[:, 0].clone()
    else:
        rc = prefill_row_chunk
        if b % rc != 0:
            raise ValueError(f"prefill_row_chunk ({rc}) must divide batch ({b})")
        chunk_logits = []
        for lo in range(0, b, rc):
            sub = PagedKVCache(
                kv_pages=cache.kv_pages,  # one pool, shared by every wave
                page_table=cache.page_table[lo:lo + rc],
                lengths=cache.lengths[lo:lo + rc],  # advanced in place
                kv_scales=cache.kv_scales,
                head_dim=cache.head_dim,
                fresh=cache.fresh,
            )
            lg, sub, _ = model(
                input_ids[lo:lo + rc], padding_mask=attention_mask[lo:lo + rc],
                paged_cache=sub, readout_positions=last_idx[lo:lo + rc],
            )
            chunk_logits.append(lg[:, 0])
        cache.fresh = False
        next_logits = torch.cat(chunk_logits, dim=0)

    unfinished = torch.ones(b, dtype=torch.bool, device=tokens.device)
    rows = torch.arange(b, device=tokens.device)

    def step():
        nxt = sample_logits(generator, next_logits, generated_ids=tokens,
                            generated_valid=valid, **sample)
        # rows that would overflow their buffer stop generating
        unfinished.logical_and_(cache.lengths < total_len)
        active = unfinished.clone()  # rows actually emitting a token this step
        nxt = torch.where(active, nxt, pad_token_id).to(torch.int32)
        pos = torch.clamp(cache.lengths, max=total_len - 1).long()
        tokens[rows, pos] = torch.where(active, nxt, tokens[rows, pos])
        valid[rows, pos] = valid[rows, pos] | active
        if eos_token_id is not None:
            unfinished.logical_and_(nxt != eos_token_id)
        logits, _, _ = model(nxt[:, None], paged_cache=cache)
        # finished rows appended a pad; roll their length back
        cache.lengths.sub_((~active).to(torch.int32))
        next_logits.copy_(logits[:, 0])

    graph = run_steps(step, max_new_tokens, device=tokens.device, use_graph=use_graph,
                      unfinished=unfinished if eos_token_id is not None else None,
                      generator=generator)
    return tokens, valid.sum(dim=1).to(torch.int32), graph


class TokenGenerator:
    """Tokenizer-facing wrapper: ``generate_tokens(prompt, args, tokenizer)``.

    ``params`` is a state dict for :class:`TextLM` (for instance from
    ``utils.convert.params_from_jax``); without one the model is built from
    ``seed``.  Prompt lengths are bucketed to powers of two, as in the JAX
    package.  ``quantize='int8'``: weight-only int8 serving
    (:class:`QuantizedModel`, dequantized into bf16 layer by layer);
    ``kv_quant='int8'``: int8 KV pages (needs ``use_paged``).  Runs on the
    card unless ``device="cpu"``."""

    def __init__(
        self,
        model_args: ModelArgs,
        params: Optional[dict] = None,
        seed: int = 0,
        cast_params_to_compute_dtype: bool = False,
        use_paged: bool = False,
        quantize: Optional[str] = None,
        kv_quant: Optional[str] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        if quantize not in (None, "int8"):
            raise ValueError(f"unsupported quantize mode: {quantize!r}")
        if kv_quant is not None and not use_paged:
            raise ValueError("kv_quant requires use_paged=True")
        self.model_args = model_args
        if params is None:
            self.model = TextLM(model_args, device=self.device, seed=seed)
        else:
            self.model = TextLM(model_args, device="meta")
            self.model.load_state_dict(params, assign=True)
            self.model.to(self.device)
        if cast_params_to_compute_dtype and model_args.dtype != "float32":
            cdt = resolve_dtype(model_args.dtype)
            for p in self.model.parameters():
                if p.dtype == torch.float32:
                    p.data = p.data.to(cdt)
        self.model.eval()
        if quantize is not None:
            self.model = QuantizedModel(self.model)
        self.use_paged = use_paged
        self.kv_quant = kv_quant
        self._generator = torch.Generator(device=self.device).manual_seed(seed + 1)

    @staticmethod
    def _bucket(n: int) -> int:
        b = 8
        while b < n:
            b *= 2
        return b

    def generate_tokens(
        self,
        prompt: str,
        generation_args: GenerationArgs,
        tokenizer,
        attention_mask: Optional[torch.Tensor] = None,
    ) -> str:
        if not prompt or not prompt.strip():
            return "Please enter a valid prompt."
        if generation_args.max_new_tokens <= 0:
            return prompt
        ids = tokenizer.encode(prompt)
        pad_id = generation_args.pad_token_id
        if pad_id is None:
            pad_id = getattr(tokenizer, "pad_token_id", 0) or 0
        bucket = min(self._bucket(len(ids)), self.model_args.max_seq_len)
        ids = ids[:bucket]
        t = len(ids)
        input_ids = torch.full((1, bucket), pad_id, dtype=torch.int32)
        input_ids[0, :t] = torch.tensor(ids, dtype=torch.int32)
        mask = torch.zeros((1, bucket), dtype=torch.bool)
        mask[0, :t] = True
        total_len = min(
            self.model_args.max_seq_len, bucket + generation_args.max_new_tokens
        )
        gen_fn = generate_paged if self.use_paged else generate
        extra = {"kv_quant": self.kv_quant} if self.use_paged else {}
        tokens, lengths = gen_fn(
            self.model,
            input_ids,
            mask,
            self._generator,
            max_new_tokens=generation_args.max_new_tokens,
            temperature=generation_args.temperature,
            top_k=generation_args.top_k,
            top_p=generation_args.top_p,
            do_sample=generation_args.do_sample,
            repetition_penalty=generation_args.repetition_penalty,
            pad_token_id=int(pad_id),
            eos_token_id=generation_args.eos_token_id,
            total_len=total_len,
            **extra,
        )
        row = tokens[0].cpu().tolist()
        n_valid = int(lengths[0])
        # dense layout: generated tokens start at the padded bucket length;
        # paged layout: rows are compact, generated tokens start at t
        gen_start = t if self.use_paged else bucket
        new_ids = row[gen_start: gen_start + max(0, n_valid - t)]
        out_ids = new_ids if generation_args.return_only_new_tokens else ids + new_ids
        return tokenizer.decode(list(out_ids), skip_special_tokens=True)
