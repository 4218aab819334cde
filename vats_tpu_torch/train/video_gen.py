"""Video-generation training: the 3-D VQ-VAE trainer and the token trainer.

Counterpart of ``vats_tpu/train/video_gen.py`` (``VideoGenTrainingArgs``,
``VQVAE3DTrainer``, ``VideoTokenTrainer``):

  * :class:`VQVAE3DTrainer`: the training forward of
    :class:`~vats_tpu_torch.models.video_gen.VQVAE3D` on raw clips
    (BatchNorm on the batch's statistics, which update the running
    statistics in place); loss = reconstruction MSE + VQ loss;
  * :class:`VideoTokenTrainer`: next-token cross-entropy over the
    (frame, raster)-ordered codebook indices, text-conditioned: the input
    at flat position i is index i - 1 (``start_token_id`` at 0), the
    transformer's fp32 logits against every index; dropout on, the blocks
    recomputed in the backward when ``cfg.use_checkpointing``.

Both step with optax's chain, written out: ``clip_by_global_norm`` ->
``adamw`` on the cosine schedule with linear warmup (``train/optimizer.py``).
A step's dropout seed comes from a generator seeded by ``args.seed + 1``
(not JAX's bits; the packages agree at dropout 0).  ``train_step`` returns
the loss as a Python float, as in JAX.  Both trainers' steps replay a CUDA
graph per batch shape on the card, as the JAX trainers jit them
(``train/step_graphs.py``): the batch and the seed are copied into static
buffers, every update is in place.  On the CPU the same body runs eagerly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import torch

from vats_tpu_torch.configs.video_gen import VideoGenArgs
from vats_tpu_torch.device import resolve_device
from vats_tpu_torch.models.video_gen import VQVAE3D, AutoregressiveVideoTransformer
from vats_tpu_torch.nn.dropout import Seed
from vats_tpu_torch.train.optimizer import AdamW, ClipByGlobalNorm, cosine_with_warmup_schedule
from vats_tpu_torch.train.state import create_train_state
from vats_tpu_torch.train.step_graphs import (
    TrainGraphs,
    capturable,
    state_tensors,
    static_like,
    zero_grads,
)

Batch = Dict[str, torch.Tensor]


@dataclass
class VideoGenTrainingArgs:
    learning_rate: float = 3e-4
    weight_decay: float = 5e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    epsilon: float = 1e-6
    clip_grad_norm: float = 1.0
    warmup_ratio: float = 0.05
    num_cycles: float = 0.5
    seed: int = 42


def _make_tx(args: VideoGenTrainingArgs, num_training_steps: int) -> ClipByGlobalNorm:
    schedule = cosine_with_warmup_schedule(
        args.learning_rate, int(args.warmup_ratio * num_training_steps),
        num_training_steps, args.num_cycles)
    return ClipByGlobalNorm(args.clip_grad_norm, AdamW(
        schedule, b1=args.betas[0], b2=args.betas[1], eps=args.epsilon,
        weight_decay=args.weight_decay))


def _build(module_cls, cfg, seed: int, state: Optional[Mapping[str, torch.Tensor]], dev):
    """The module drawn from ``seed``, or built on the meta device and given
    ``state`` on ``dev``."""
    if state is None:
        return module_cls(cfg, device=dev, seed=seed)
    module = module_cls(cfg, device="meta")
    module.load_state_dict(dict(state), assign=True)
    return module.to(dev)


class _Trainer:
    """The optimizer state and one step of a scalar loss, from a graph per
    batch shape on the card (``graphs.use_graph = False`` runs the same body
    eagerly)."""

    def __init__(self, model: torch.nn.Module, args: VideoGenTrainingArgs,
                 num_training_steps: int):
        self.model = model
        self.args = args
        self.tx = _make_tx(args, num_training_steps)
        self.state = create_train_state(model, self.tx)
        self._seeds = torch.Generator().manual_seed(args.seed + 1)
        self.graphs = TrainGraphs(model.device, model)

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _step(self, inputs: Dict[str, torch.Tensor], loss_fn) -> float:
        """One update of ``loss_fn(buffers)``, the loss of the batch in
        ``inputs`` (and the step's seed, ``buffers['seed']``)."""
        dev = self.device
        seed = int(torch.randint(0, 1 << 62, (1,), generator=self._seeds))
        inputs = {**inputs, "seed": torch.tensor(seed, dtype=torch.int64)}

        def build():
            bufs = {k: static_like(v, dev) for k, v in inputs.items()}
            out = torch.zeros((), dtype=torch.float32, device=dev)

            def body():
                zero_grads(self.state.params.values())
                loss = loss_fn(bufs)
                loss.backward()
                grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                         for n, p in self.state.params.items()}
                self.state.apply_gradients(grads)
                out.copy_(loss.detach())

            return bufs, body, out

        key = tuple((k, tuple(v.shape), v.dtype) for k, v in inputs.items())
        out = self.graphs(key, build, inputs, params=self.state.params.values(),
                          state=state_tensors(self.state, list(self.model.buffers())),
                          use_graph=capturable(self.state.params))
        return float(out)


class VQVAE3DTrainer(_Trainer):
    """Owns the VQVAE3D (params and BatchNorm statistics), the optimizer
    state and the step.  ``variables``: a VQVAE3D state dict (for instance
    ``utils.convert.params_from_jax`` of JAX variables with their
    batch_stats); without it the model is drawn from ``args.seed``.  Runs
    on the card unless ``device="cpu"``."""

    def __init__(self, cfg: VideoGenArgs, args: VideoGenTrainingArgs,
                 num_training_steps: int = 1000,
                 variables: Optional[Mapping[str, torch.Tensor]] = None, *, device=None):
        self.cfg = cfg
        super().__init__(_build(VQVAE3D, cfg, args.seed, variables, resolve_device(device)),
                         args, num_training_steps)

    def loss(self, videos: torch.Tensor) -> torch.Tensor:
        """The training forward's loss on [B, C, T, H, W] clips in [0, 1]."""
        _, loss, _ = self.model(torch.as_tensor(videos).to(self.device), deterministic=False)
        return loss

    def train_step(self, videos: torch.Tensor) -> float:
        return self._step({"videos": torch.as_tensor(videos)},
                          lambda bufs: self.loss(bufs["videos"]))


class VideoTokenTrainer(_Trainer):
    """Next-token CE over flat (frame, raster) order with shifted inputs.
    ``params``: an AutoregressiveVideoTransformer state dict; without it the
    model is drawn from ``args.seed``.  Runs on the card unless
    ``device="cpu"``."""

    def __init__(self, cfg: VideoGenArgs, args: VideoGenTrainingArgs,
                 num_training_steps: int = 1000, start_token_id: int = 0,
                 params: Optional[Mapping[str, torch.Tensor]] = None, *, device=None):
        self.cfg = cfg
        self.start_token_id = start_token_id
        super().__init__(_build(AutoregressiveVideoTransformer, cfg, args.seed, params,
                                resolve_device(device)), args, num_training_steps)

    def loss(self, batch: Batch, dropout_seed: Optional[Seed]) -> torch.Tensor:
        """Mean CE of ``batch`` ({"indices" [B, T, H, W], "text_embeddings"
        [B, T_txt, d], optional "text_mask" [B, T_txt]})."""
        dev = self.device
        indices = torch.as_tensor(batch["indices"]).to(dev)
        text = torch.as_tensor(batch["text_embeddings"]).to(dev)
        mask = batch.get("text_mask")
        mask = None if mask is None else torch.as_tensor(mask).to(dev).bool()
        b, t, h, w = indices.shape
        flat = indices.reshape(b, t * h * w).long()
        start = torch.full((b, 1), self.start_token_id, dtype=torch.long, device=dev)
        inputs = torch.cat([start, flat[:, :-1]], dim=1).reshape(b, t, h, w)
        logits, _ = self.model(inputs, text, mask, return_logits=True, deterministic=False,
                               dropout_seed=dropout_seed)
        logp = torch.log_softmax(logits.reshape(b, t * h * w, -1), dim=-1)
        return -torch.gather(logp, -1, flat[..., None])[..., 0].mean()

    def train_step(self, batch: Batch) -> float:
        inputs = {k: torch.as_tensor(batch[k]) for k in ("indices", "text_embeddings",
                                                         "text_mask")
                  if batch.get(k) is not None}
        return self._step(inputs, lambda bufs: self.loss(bufs, bufs["seed"]))
