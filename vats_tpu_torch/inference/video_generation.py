"""Autoregressive video generation: the frame-by-frame raster decode loop and
the pipeline.

Counterpart of ``vats_tpu/inference/video_generation.py``:

  * :data:`VideoGenerationSampler`: the image sampler (temperature / top-k
    / top-p / greedy);
  * :func:`generate_video_tokens`: tokens factorize in (frame, raster)
    order.  Frames decode one at a time, past frames living in the temporal
    KV cache.  Within a frame each inner step runs the transformer on the
    whole current frame in ``read`` mode, with the spatial keys past the
    frontier masked out, samples the token at the frontier and writes it
    into the frame's input; a finished frame takes one more forward of the
    same shifted inputs in ``append`` mode, which commits its temporal K/V.
    The input at flat position i is the token sampled at i - 1
    (``start_token_id`` at 0).  Every inner step runs the whole frame
    through every layer: O((H*W)^2) a frame, as in JAX;
  * :class:`VideoGenerationPipeline`: text ids -> text encoder -> token
    sampling -> codebook lookup -> 3-D decoder -> [B, C, T, H, W] video in
    [0, 1].

The JAX package runs the inner loop as a ``fori_loop`` program.  Here an
inner step is a function of tensors that persist across steps and frames
(the frame's input, the frame's tokens, the frontier); on the card the first
step runs eagerly and every later one, in every frame, replays it from one
CUDA graph (``inference/graphs.py``): the cache's length lives on the device,
so the same graph serves every frame.  The frames' append forwards run
eagerly.  Every cached forward writes each layer's temporal K/V through K3's
append mode (one launch a layer).  On the CPU every step runs eagerly.  Draws
come from an explicit ``torch.Generator``: sampled tokens agree with the JAX
package in distribution only, greedy tokens exactly.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch

from vats_tpu_torch.configs.image_gen import ImageGenArgs
from vats_tpu_torch.configs.video_gen import VideoGenArgs
from vats_tpu_torch.device import resolve_device
from vats_tpu_torch.inference.graphs import StepGraph
from vats_tpu_torch.inference.image_generation import ImageGenerationSampler, _load
from vats_tpu_torch.models.image_gen import TransformerTextEncoder
from vats_tpu_torch.models.video_gen import AutoregressiveVideoTransformer, Decoder3D

VideoGenerationSampler = ImageGenerationSampler


@torch.no_grad()
def _generate_video_tokens(
    model: AutoregressiveVideoTransformer, text_embeddings: torch.Tensor,
    text_mask: Optional[torch.Tensor], generator: Optional[torch.Generator], *,
    num_frames: int, sampler: ImageGenerationSampler, start_token_id: int,
    use_graph: bool,
) -> Tuple[torch.Tensor, Optional[StepGraph]]:
    """The frame loop; ``use_graph=False`` runs every step eagerly (on the
    card, only to compare the two).  Returns (tokens [B, F, H, W] int32,
    the inner step's graph or None)."""
    cfg = model.cfg
    dev = model.device
    gh, gw = cfg.latent_height, cfg.latent_width
    hw = gh * gw
    text = text_embeddings.to(dev)
    mask = None if text_mask is None else text_mask.to(dev).bool()
    b = text.shape[0]
    tokens = torch.zeros((b, num_frames, hw), dtype=torch.int32, device=dev)
    cache = model.init_cache(b)
    prev_last = torch.full((b,), start_token_id, dtype=torch.int32, device=dev)
    # the frame's shifted input; slot hw takes the write after the frame's
    # last step, which no forward reads
    inp = torch.zeros((b, hw + 1), dtype=torch.int32, device=dev)
    frame = torch.zeros((b, hw), dtype=torch.int32, device=dev)
    col = torch.zeros((1,), dtype=torch.int64, device=dev)  # the frontier
    raster = torch.arange(hw, device=dev)

    def step():
        frontier = (raster <= col)[None, :].expand(b, hw)  # inputs 0..col are set
        logits, _ = model(inp[:, :hw].reshape(b, 1, gh, gw), text, mask, cache=cache,
                          spatial_valid=frontier, cache_mode="read", return_logits=True)
        tok = sampler(generator, logits[:, 0].index_select(1, col)[:, 0])
        frame.index_copy_(1, col, tok[:, None])
        inp.index_copy_(1, col + 1, tok[:, None])
        col.add_(1)

    graph = StepGraph(step, dev, generator=generator) if use_graph else None
    for f in range(num_frames):
        inp.zero_()
        inp[:, 0] = prev_last
        col.zero_()
        for _ in range(hw):
            if graph is None:
                step()
            else:
                graph.run()
        # commit the frame's temporal K/V (the inputs the inner steps saw)
        model(inp[:, :hw].reshape(b, 1, gh, gw), text, mask, cache=cache,
              cache_mode="append")
        tokens[:, f] = frame
        prev_last = frame[:, -1].clone()
    return tokens.reshape(b, num_frames, gh, gw), graph


def generate_video_tokens(
    model: AutoregressiveVideoTransformer,
    text_embeddings: torch.Tensor,
    text_mask: Optional[torch.Tensor],
    generator: Optional[torch.Generator],
    *,
    num_frames: int,
    temperature: Optional[float] = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    do_sample: bool = True,
    start_token_id: int = 0,
) -> torch.Tensor:
    """Sample [B, num_frames, H, W] codebook indices on the model's device
    (inner steps replayed from a CUDA graph on the card).  text_embeddings
    [B, T_txt, d]; text_mask [B, T_txt] bool or None."""
    sampler = VideoGenerationSampler(temperature, top_k, top_p, do_sample)
    tokens, _ = _generate_video_tokens(
        model, text_embeddings, text_mask, generator, num_frames=num_frames,
        sampler=sampler, start_token_id=start_token_id,
        use_graph=model.device.type == "cuda")
    return tokens


def text_encoder_args(cfg: VideoGenArgs) -> ImageGenArgs:
    """The text encoder a pipeline builds when given none: the image stack's
    ``TransformerTextEncoder`` at the video config's width, with its
    ``text_*`` depth and heads, vocabulary, FFN width and dtypes."""
    return ImageGenArgs(
        d_model=cfg.d_model, num_heads=cfg.text_num_heads, query_groups=cfg.text_query_groups,
        d_ffn=cfg.d_ffn, dropout=0.0, rms_norm_eps=cfg.rms_norm_eps,
        vocab_size=cfg.vocab_size, text_num_layers=cfg.text_num_layers,
        text_num_heads=cfg.text_num_heads, text_query_groups=cfg.text_query_groups,
        dtype=cfg.dtype, param_dtype=cfg.param_dtype)


class VideoGenerationPipeline:
    """Text prompt ids -> videos, owning the text encoder, the transformer,
    the 3-D decoder and the codebook.

    ``text_encoder``: a module taking (ids [B, T], padding_mask=[B, T]) to
    [B, T, d] embeddings (for instance the image stack's
    ``TransformerTextEncoder``, as the JAX tests pair them); without one,
    a ``TransformerTextEncoder`` of :func:`text_encoder_args` is drawn from
    ``seed``.  Each ``*_params`` is a state dict of that module (for
    instance from ``utils.convert.params_from_jax``; the decoder's carries
    its BatchNorm running statistics) and ``quantizer_codebook`` a
    [num_embeddings, d] tensor; what is not given is drawn from ``seed``.
    Runs on the card unless ``device="cpu"``."""

    def __init__(
        self,
        cfg: VideoGenArgs,
        text_encoder: Optional[torch.nn.Module] = None,
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
        if text_encoder is None:
            text_encoder = TransformerTextEncoder(text_encoder_args(cfg), device=dev,
                                                  seed=seed)
        self.text_encoder = text_encoder.to(dev)
        if transformer_params is None:
            self.transformer = AutoregressiveVideoTransformer(cfg, device=dev, seed=seed + 1)
        else:
            self.transformer = _load(AutoregressiveVideoTransformer(cfg, device="meta"),
                                     transformer_params, dev)
        self.decoder = Decoder3D(cfg, device=dev)
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
        #: the last call's inner-step graph (None on the CPU)
        self.last_graph: Optional[StepGraph] = None

    @torch.no_grad()
    def generate_videos(
        self,
        text_ids: torch.Tensor,
        generator: Optional[torch.Generator],
        *,
        num_frames: int,
        text_mask: Optional[torch.Tensor] = None,
        sampler: Optional[VideoGenerationSampler] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (videos [B, C, num_frames * pt, H * ph, W * pw] in
        [0, 1], tokens [B, num_frames, H, W])."""
        sampler = sampler or VideoGenerationSampler()
        text_ids = text_ids.to(self.device)
        if text_mask is None:
            text_mask = torch.ones(text_ids.shape, dtype=torch.bool, device=self.device)
        text_mask = text_mask.to(self.device).bool()
        text_emb = self.text_encoder(text_ids, padding_mask=text_mask)
        tokens, self.last_graph = _generate_video_tokens(
            self.transformer, text_emb, text_mask, generator, num_frames=num_frames,
            sampler=sampler, start_token_id=0, use_graph=self.device.type == "cuda")
        z_q = self.codebook[tokens.long()]  # [B, T, H, W, d]
        return self.decoder(z_q), tokens
