"""Fused text+image+video token-stream generation over a paged KV cache.

Counterpart of ``vats_tpu/inference/multimodal.py``: a ragged text prefill
into a fresh paged cache (room for the prompt and every image and video
token, pages of ``page_size``), then one decode step a token over the image
segment and then the video segment, the logits masked to the active
modality's range of the fused vocabulary before sampling, each token fed
back with its modality and segment-local position (so its RoPE is the raster
2-D or 3-D one); the last token is sampled with no forward after it.  The
result comes back as codebook indices with the vocabulary offsets removed,
ready for the image and video VQ-VAE decoders.

The JAX package runs the loop as one ``fori_loop`` program.  Here a step
(mask and sample the previous logits, write the token, one paged decode
forward, keep its logits) is a function of tensors that persist across
steps, the step counter among them; on the card the first step runs eagerly
and every later one replays it, captured once as a CUDA graph
(``inference/graphs.py``); on the CPU every step runs eagerly.  Every decode
forward runs K3's paged prologue in table mode and K1 once a layer; a prompt
of at least ``FLASH_MIN_SEQ_LEN`` tokens is prefilled through K2.  Draws come
from an explicit ``torch.Generator``: sampled tokens agree with the JAX
package in distribution only, greedy tokens exactly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vats_tpu_torch.inference.graphs import StepGraph, run_steps
from vats_tpu_torch.inference.image_generation import ImageGenerationSampler
from vats_tpu_torch.models.multimodal import (
    MODALITY_IMAGE,
    MODALITY_TEXT,
    MODALITY_VIDEO,
    MultimodalLM,
)


@torch.no_grad()
def _generate_multimodal(
    model: MultimodalLM, text_ids: torch.Tensor, text_mask: Optional[torch.Tensor],
    generator: Optional[torch.Generator], *, sampler: ImageGenerationSampler,
    page_size: int, use_graph: bool,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[StepGraph]]:
    """The prefill and the decode loop; ``use_graph=False`` runs every step
    eagerly (on the card, only to compare the two).  Returns (image codes,
    video codes, the step's graph or None)."""
    cfg = model.cfg
    dev = model.device
    text_ids = text_ids.to(dev)
    b, t_text = text_ids.shape
    n_img, n_vid = cfg.image_tokens, cfg.video_tokens
    n_total = n_img + n_vid
    vt, vi = cfg.text_vocab_size, cfg.image_vocab_size
    if text_mask is None:
        text_mask = torch.ones((b, t_text), dtype=torch.bool, device=dev)
    text_mask = text_mask.to(dev).bool()
    prompt_lens = text_mask.to(torch.int32).sum(dim=1)
    cache = model.init_paged_cache(b, max_len=t_text + n_total, page_size=page_size)

    # ragged text prefill; each row reads out its last prompt token
    modality = torch.full((b, t_text), MODALITY_TEXT, dtype=torch.int32, device=dev)
    local_pos = torch.arange(t_text, dtype=torch.int32, device=dev)[None, :].expand(b, t_text)
    logits, _ = model(text_ids, modality, local_pos, padding_mask=text_mask,
                      paged_cache=cache, readout_positions=torch.clamp(prompt_lens - 1, min=0))
    next_logits = logits[:, 0].clone()

    vocab_ids = torch.arange(cfg.vocab_size, device=dev)
    gen = torch.zeros((b, n_total), dtype=torch.int32, device=dev)
    i = torch.zeros((1,), dtype=torch.int64, device=dev)  # the step, on the device

    def sample():
        is_img = i < n_img
        lo = torch.where(is_img, vt, vt + vi)
        hi = torch.where(is_img, vt + vi, cfg.vocab_size)
        allowed = (vocab_ids >= lo) & (vocab_ids < hi)
        tok = sampler(generator, torch.where(allowed, next_logits, float("-inf")))
        gen.index_copy_(1, i, tok[:, None])
        return tok, is_img

    def step():
        tok, is_img = sample()
        mod = torch.where(is_img, MODALITY_IMAGE, MODALITY_VIDEO).to(torch.int32)
        loc = torch.where(is_img, i, i - n_img).to(torch.int32)
        lg, _ = model(tok[:, None], mod.expand(b, 1), loc.expand(b, 1), paged_cache=cache)
        next_logits.copy_(lg[:, 0])
        i.add_(1)

    graph = run_steps(step, n_total - 1, device=dev, use_graph=use_graph,
                      generator=generator)
    sample()  # the last token needs no forward after it

    image_codes = (gen[:, :n_img] - vt).reshape(b, cfg.image_grid_h, cfg.image_grid_w)
    video_codes = (gen[:, n_img:] - (vt + vi)).reshape(
        b, cfg.video_grid_t, cfg.video_grid_h, cfg.video_grid_w)
    return image_codes, video_codes, graph


def generate_multimodal(
    model: MultimodalLM,
    text_ids: torch.Tensor,
    text_mask: Optional[torch.Tensor],
    generator: Optional[torch.Generator],
    *,
    temperature: Optional[float] = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    do_sample: bool = True,
    page_size: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """text_ids [B, T_text], right-padded (ids < text_vocab_size); text_mask
    [B, T_text] bool or None.  Returns (image_codes [B, gh, gw],
    video_codes [B, gt, gh, gw]) int32 on the model's device (decode steps
    replayed from a CUDA graph on the card)."""
    sampler = ImageGenerationSampler(temperature, top_k, top_p, do_sample)
    image_codes, video_codes, _ = _generate_multimodal(
        model, text_ids, text_mask, generator, sampler=sampler, page_size=page_size,
        use_graph=model.device.type == "cuda")
    return image_codes, video_codes
