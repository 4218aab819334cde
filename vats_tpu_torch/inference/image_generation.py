"""Autoregressive image generation: raster-order token sampling and decode.

Counterpart of ``vats_tpu/inference/image_generation.py``:

  * :class:`ImageGenerationSampler`: temperature / top-k / top-p / greedy
    over the shared :func:`~vats_tpu_torch.inference.sampling.sample_logits`;
  * :func:`generate_image_tokens`: a raster-order loop over the
    grid_h x grid_w latent grid through the dense KV cache, with
    cross-attention to the text embeddings; the input at step i is the
    token sampled at step i-1 (step 0 feeds ``start_token_id``);
  * :func:`generate_image_tokens_paged`: the same loop through the paged
    cache (pages of ``page_size`` tokens, room for n + 1 tokens), where
    each decode step attends with K1;
  * :class:`ImageGenerationPipeline`: text ids -> text encoder -> token
    sampling -> codebook lookup -> VQ-VAE decoder -> [B, C, H, W] images
    in [0, 1].

The JAX package runs the loop as one ``fori_loop`` program.  Here a decode
step (sample the previous logits, write the token, one cached forward of
one token a row, keep its logits) is a function of tensors that persist
across steps; on the card the first step runs eagerly and every later step
replays it, captured once as a CUDA graph (``inference/graphs.py``, launch
tallies as for ``generate``); on the CPU every step runs eagerly.  Every
decode forward runs K3's prologue in table mode (the '2d_ntk' RoPE) once a
layer.  As in JAX, the cross-attention recomputes the text's K/V at every
step.  Draws come from an explicit ``torch.Generator``: sampled tokens agree
with the JAX package in distribution only, greedy tokens exactly.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch

from vats_tpu_torch.configs.image_gen import ImageGenArgs
from vats_tpu_torch.device import resolve_device
from vats_tpu_torch.inference.graphs import StepGraph, run_steps
from vats_tpu_torch.inference.sampling import sample_logits
from vats_tpu_torch.models.image_gen import (
    AutoregressiveImageTransformer,
    TransformerTextEncoder,
    VQVAEDecoder,
)


class ImageGenerationSampler:
    """Sampler settings; ``sampler(generator, logits)`` draws [B] tokens."""

    def __init__(self, temperature: Optional[float] = 1.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, do_sample: bool = True):
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.do_sample = do_sample

    def __call__(self, generator: Optional[torch.Generator],
                 logits: torch.Tensor) -> torch.Tensor:
        return sample_logits(generator, logits, temperature=self.temperature,
                             top_k=self.top_k, top_p=self.top_p, do_sample=self.do_sample)


@torch.no_grad()
def _generate_image_tokens(
    model: AutoregressiveImageTransformer, text_embeddings: torch.Tensor,
    text_mask: Optional[torch.Tensor], generator: Optional[torch.Generator], *,
    grid_h: int, grid_w: int, sampler: ImageGenerationSampler, start_token_id: int,
    paged: bool, page_size: int, use_graph: bool,
) -> Tuple[torch.Tensor, Optional[StepGraph]]:
    """The raster loop; ``use_graph=False`` runs every step eagerly (on the
    card, only to compare the two).  Returns (tokens [B, gh, gw] int32, the
    step's graph or None)."""
    dev = model.device
    text_embeddings = text_embeddings.to(dev)
    if text_mask is not None:
        text_mask = text_mask.to(dev).bool()
    b = text_embeddings.shape[0]
    n = grid_h * grid_w
    if paged:
        cache = model.init_paged_cache(b, n + 1, page_size=page_size)
        kw = {"paged_cache": cache}
    else:
        cache = model.init_cache(b, n)
        kw = {"cache": cache}
    tokens = torch.zeros((b, n), dtype=torch.int32, device=dev)
    start = torch.full((b, 1), start_token_id, dtype=torch.int32, device=dev)
    logits, _ = model(start, text_embeddings, cross_padding_mask=text_mask, grid_w=grid_w,
                      return_logits=True, **kw)
    next_logits = logits[:, -1].clone()
    col = torch.zeros((1,), dtype=torch.int64, device=dev)

    def step():
        nxt = sampler(generator, next_logits)
        tokens.index_copy_(1, col, nxt[:, None])
        lg, _ = model(nxt[:, None], text_embeddings, cross_padding_mask=text_mask,
                      grid_w=grid_w, return_logits=True, **kw)
        next_logits.copy_(lg[:, -1])
        col.add_(1)

    graph = run_steps(step, n - 1, device=dev, use_graph=use_graph, generator=generator)
    # the last token needs no forward after it
    tokens[:, n - 1] = sampler(generator, next_logits)
    return tokens.reshape(b, grid_h, grid_w), graph


def generate_image_tokens(
    model: AutoregressiveImageTransformer,
    text_embeddings: torch.Tensor,
    text_mask: Optional[torch.Tensor],
    generator: Optional[torch.Generator],
    *,
    grid_h: int,
    grid_w: int,
    temperature: Optional[float] = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    do_sample: bool = True,
    start_token_id: int = 0,
) -> torch.Tensor:
    """Sample [B, grid_h, grid_w] codebook indices through the dense KV
    cache, on the model's device (decode steps replayed from a CUDA graph
    on the card).  text_embeddings [B, T_txt, d]; text_mask [B, T_txt] bool
    or None."""
    sampler = ImageGenerationSampler(temperature, top_k, top_p, do_sample)
    tokens, _ = _generate_image_tokens(
        model, text_embeddings, text_mask, generator, grid_h=grid_h, grid_w=grid_w,
        sampler=sampler, start_token_id=start_token_id, paged=False, page_size=0,
        use_graph=model.device.type == "cuda")
    return tokens


def generate_image_tokens_paged(
    model: AutoregressiveImageTransformer,
    text_embeddings: torch.Tensor,
    text_mask: Optional[torch.Tensor],
    generator: Optional[torch.Generator],
    *,
    grid_h: int,
    grid_w: int,
    temperature: Optional[float] = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    do_sample: bool = True,
    start_token_id: int = 0,
    page_size: int = 128,
) -> torch.Tensor:
    """:func:`generate_image_tokens` through the paged KV cache: the RoPE
    positions come from the cache's per-row lengths, and every decode step
    attends and commits with K1.  Greedy tokens equal the dense loop's."""
    sampler = ImageGenerationSampler(temperature, top_k, top_p, do_sample)
    tokens, _ = _generate_image_tokens(
        model, text_embeddings, text_mask, generator, grid_h=grid_h, grid_w=grid_w,
        sampler=sampler, start_token_id=start_token_id, paged=True, page_size=page_size,
        use_graph=model.device.type == "cuda")
    return tokens


def _load(module, state: Optional[Mapping[str, torch.Tensor]], device) -> torch.nn.Module:
    """``module`` (built on the meta device) with ``state`` loaded on
    ``device``."""
    module.load_state_dict(dict(state), assign=True)
    return module.to(device)


class ImageGenerationPipeline:
    """Text prompt ids -> images, owning the text encoder, the transformer,
    the decoder and the codebook.

    Each ``*_params`` is a state dict of that module (for instance from
    ``utils.convert.params_from_jax``; the decoder's carries its BatchNorm
    running statistics) and ``quantizer_codebook`` a [num_embeddings, d]
    tensor; what is not given is drawn from ``seed``.  Runs on the card
    unless ``device="cpu"``."""

    def __init__(
        self,
        cfg: ImageGenArgs,
        text_encoder_params: Optional[Mapping[str, torch.Tensor]] = None,
        transformer_params: Optional[Mapping[str, torch.Tensor]] = None,
        decoder_params: Optional[Mapping[str, torch.Tensor]] = None,
        quantizer_codebook: Optional[torch.Tensor] = None,
        *,
        seed: int = 0,
        device=None,
    ):
        dev = resolve_device(device)
        self.cfg = cfg
        self.device = dev
        gen = torch.Generator(device=dev).manual_seed(seed)
        if text_encoder_params is None:
            self.text_encoder = TransformerTextEncoder(cfg, device=dev, seed=seed)
        else:
            self.text_encoder = _load(TransformerTextEncoder(cfg, device="meta"),
                                      text_encoder_params, dev)
        if transformer_params is None:
            self.transformer = AutoregressiveImageTransformer(cfg, device=dev, seed=seed + 1)
        else:
            self.transformer = _load(AutoregressiveImageTransformer(cfg, device="meta"),
                                     transformer_params, dev)
        self.decoder = VQVAEDecoder(cfg, device=dev)
        if decoder_params is None:
            self.decoder.reset_parameters(gen)
        else:
            self.decoder.load_state_dict(dict(decoder_params))
        if quantizer_codebook is None:
            e = cfg.num_embeddings
            quantizer_codebook = torch.empty(e, cfg.d_model, device=dev).uniform_(
                -1.0 / e, 1.0 / e, generator=gen)
        self.codebook = torch.as_tensor(quantizer_codebook).to(dev)
        for m in (self.text_encoder, self.transformer, self.decoder):
            m.eval()
        #: the last call's decode-step graph (None on the CPU)
        self.last_graph: Optional[StepGraph] = None

    @torch.no_grad()
    def generate_images(
        self,
        text_ids: torch.Tensor,
        generator: Optional[torch.Generator],
        *,
        grid_h: int,
        grid_w: int,
        text_mask: Optional[torch.Tensor] = None,
        sampler: Optional[ImageGenerationSampler] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (images [B, C, 4 grid_h, 4 grid_w] in [0, 1], tokens
        [B, grid_h, grid_w])."""
        sampler = sampler or ImageGenerationSampler()
        text_ids = text_ids.to(self.device)
        if text_mask is None:
            text_mask = torch.ones(text_ids.shape, dtype=torch.bool, device=self.device)
        text_mask = text_mask.to(self.device).bool()
        text_emb = self.text_encoder(text_ids, padding_mask=text_mask)
        tokens, self.last_graph = _generate_image_tokens(
            self.transformer, text_emb, text_mask, generator, grid_h=grid_h,
            grid_w=grid_w, sampler=sampler, start_token_id=0, paged=False, page_size=0,
            use_graph=self.device.type == "cuda")
        z_q = self.codebook[tokens.long()]  # [B, gh, gw, d]
        return self.decoder(z_q), tokens
