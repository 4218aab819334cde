"""Image-generation training: the VQ-VAE trainer.

Counterpart of ``vats_tpu/train/image_gen.py`` (``ImageGenTrainingArgs``,
``ImageGenTrainer``).  One train step is the training forward of
:class:`~vats_tpu_torch.models.image_gen.VQVAE` (dropout on, BatchNorm on
the batch's statistics, which update the running statistics in place, the
transformer's blocks recomputed in the backward when
``cfg.use_checkpointing``), the loss, the backward and the update:

  * loss = VQ loss + ``recon_weight`` * the reconstruction MSE (fp32)
    + ``token_ce_weight`` * the raster next-token cross-entropy of the
    transformer's features through ``to_logits`` (fp32 product) against
    the quantized indices;
  * the optimizer is optax's chain, written out: ``clip_by_global_norm``
    -> ``adamw`` on the cosine schedule with linear warmup
    (``train/optimizer.py``).

``evaluate`` runs the deterministic forward (BatchNorm on the running
statistics): VQ and reconstruction losses.  The step's dropout seed comes
from a generator seeded by ``args.seed + 1`` (not JAX's bits; the packages
agree at dropout 0).  Metrics come back as Python floats, as in JAX.

Both the train step and the eval step replay a CUDA graph per batch shape
on the card, as the JAX trainer jits them with the params, the BatchNorm
statistics and the optimizer state donated (``train/step_graphs.py``): the
batch and the seed are copied into static buffers, every update is in
place.  On the CPU the same bodies run eagerly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Mapping, Optional, Tuple

import torch

from vats_tpu_torch.configs.image_gen import ImageGenArgs
from vats_tpu_torch.device import resolve_device
from vats_tpu_torch.models.image_gen import VQVAE
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
#: the batch entries a step reads (the masks optional)
_INPUTS = ("images", "text_embeddings", "image_attention_mask", "text_attention_mask")


@dataclass
class ImageGenTrainingArgs:
    learning_rate: float = 3e-4
    weight_decay: float = 5e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    epsilon: float = 1e-6
    clip_grad_norm: float = 1.0
    warmup_ratio: float = 0.05
    num_cycles: float = 0.5
    grad_accum_steps: int = 1
    use_recon_loss: bool = True
    use_token_ce: bool = True
    recon_weight: float = 1.0
    token_ce_weight: float = 1.0
    seed: int = 42


def token_ce(transformer_out: torch.Tensor, indices: torch.Tensor,
             head_weight: torch.Tensor) -> torch.Tensor:
    """Mean raster next-token cross-entropy: features [B, H, W, d] through
    the head [V, d] in fp32, position i predicting index i + 1."""
    b, h, w, d = transformer_out.shape
    logits = transformer_out.reshape(b, h * w, d).float() @ head_weight.float().T
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    targets = indices.reshape(b, h * w)[:, 1:].long()
    return -torch.gather(logp, -1, targets[..., None])[..., 0].mean()


class ImageGenTrainer:
    """Owns the VQVAE (params and BatchNorm statistics), the optimizer
    state and the step.  ``variables``: a VQVAE state dict (for instance
    ``utils.convert.params_from_jax`` of JAX variables with their
    batch_stats); without it the model is drawn from ``args.seed``.  Runs
    on the card unless ``device="cpu"``."""

    def __init__(self, cfg: ImageGenArgs, args: ImageGenTrainingArgs,
                 num_training_steps: int = 1000,
                 variables: Optional[Mapping[str, torch.Tensor]] = None, *, device=None):
        dev = resolve_device(device)
        self.cfg = cfg
        self.args = args
        if variables is None:
            self.model = VQVAE(cfg, device=dev, seed=args.seed)
        else:
            self.model = VQVAE(cfg, device="meta")
            self.model.load_state_dict(dict(variables), assign=True)
            self.model.to(dev)
        schedule = cosine_with_warmup_schedule(
            args.learning_rate, int(args.warmup_ratio * num_training_steps),
            num_training_steps, args.num_cycles)
        self.tx = ClipByGlobalNorm(args.clip_grad_norm, AdamW(
            schedule, b1=args.betas[0], b2=args.betas[1], eps=args.epsilon,
            weight_decay=args.weight_decay))
        self.state = create_train_state(self.model, self.tx)
        self._seeds = torch.Generator().manual_seed(args.seed + 1)
        #: the train and eval steps' graphs (``graphs.use_graph = False``
        #: runs the same bodies eagerly on the card)
        self.graphs = TrainGraphs(dev, self.model)
        self.eval_graphs = TrainGraphs(dev, self.model)

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _inputs(self, batch: Batch):
        dev = self.device
        get = lambda k: None if batch.get(k) is None else torch.as_tensor(batch[k]).to(dev)  # noqa: E731
        return tuple(get(k) for k in _INPUTS)

    def loss(self, batch: Batch, dropout_seed: Optional[Seed]):
        """(loss, metrics) of the training forward on ``batch``."""
        args = self.args
        images, text, img_mask, txt_mask = self._inputs(batch)
        recon, vq_loss, indices, t_out = self.model(
            images, text, img_mask, txt_mask, deterministic=False,
            dropout_seed=dropout_seed)
        loss = vq_loss
        metrics = {"vq_loss": vq_loss}
        if args.use_recon_loss:
            recon_loss = (recon.float() - images.float()).square().mean()
            loss = loss + args.recon_weight * recon_loss
            metrics["recon_loss"] = recon_loss
        if args.use_token_ce:
            ce = token_ce(t_out, indices, self.model.model.to_logits.weight)
            loss = loss + args.token_ce_weight * ce
            metrics["token_ce"] = ce
        metrics["loss"] = loss
        return loss, metrics

    def _train_body(self, batch: Batch, seed: Seed) -> torch.Tensor:
        """One step on ``batch``: its metrics stacked (fp32)."""
        zero_grads(self.state.params.values())
        loss, metrics = self.loss(batch, seed)
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in self.state.params.items()}
        self.state.apply_gradients(grads)
        return torch.stack([v.detach().float() for v in metrics.values()])

    def _metric_names(self):
        return (("vq_loss",) + (("recon_loss",) if self.args.use_recon_loss else ())
                + (("token_ce",) if self.args.use_token_ce else ()) + ("loss",))

    def _run(self, graphs: TrainGraphs, batch: Batch, body, n_out: int, extra=None,
             params=()) -> torch.Tensor:
        """``body(buffers) -> [n_out] fp32`` from ``graphs``: one graph per
        batch shape, over the params, the BatchNorm statistics and the
        optimizer state in place."""
        dev = self.device
        inputs = {k: torch.as_tensor(batch[k]) for k in _INPUTS if batch.get(k) is not None}
        inputs.update(extra or {})

        def build():
            bufs = {k: static_like(torch.as_tensor(v), dev) for k, v in inputs.items()}
            out = torch.zeros((n_out,), dtype=torch.float32, device=dev)
            return bufs, lambda: out.copy_(body(bufs)), out

        key = tuple((k, tuple(v.shape), v.dtype) for k, v in inputs.items()
                    if isinstance(v, torch.Tensor))
        return graphs(key, build, inputs, params=params,
                      state=state_tensors(self.state, list(self.model.buffers())),
                      use_graph=capturable(self.state.params))

    def train_step(self, batch: Batch) -> Dict[str, float]:
        seed = int(torch.randint(0, 1 << 62, (1,), generator=self._seeds))
        names = self._metric_names()
        out = self._run(self.graphs, batch, lambda bufs: self._train_body(bufs, bufs["seed"]),
                        len(names), {"seed": torch.tensor(seed, dtype=torch.int64)},
                        params=self.state.params.values())
        return dict(zip(names, out.tolist()))

    def _eval_body(self, batch: Batch) -> torch.Tensor:
        images, text, img_mask, txt_mask = self._inputs(batch)
        recon, vq_loss, _, _ = self.model(images, text, img_mask, txt_mask,
                                          deterministic=True)
        recon_loss = (recon.float() - images.float()).square().mean()
        return torch.stack([vq_loss.float(), recon_loss, (vq_loss + recon_loss).float()])

    @torch.no_grad()
    def eval_step(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """The deterministic forward's VQ, reconstruction and total loss."""
        out = self._run(self.eval_graphs, batch, self._eval_body, 3).clone()
        return {"vq_loss": out[0], "recon_loss": out[1], "loss": out[2]}

    def evaluate(self, data_iter: Iterable[Batch],
                 max_batches: int = 10**9) -> Dict[str, float]:
        total: Dict[str, float] = {}
        n = 0
        for batch in data_iter:
            if n >= max_batches:
                break
            for k, v in self.eval_step(batch).items():
                total[k] = total.get(k, 0.0) + float(v)
            n += 1
        return {k: v / max(n, 1) for k, v in total.items()} | {"batches": n}

    def train(self, data_iter: Iterable[Batch], max_steps: int = 10**9) -> Dict[str, float]:
        total: Dict[str, float] = {}
        n = 0
        for batch in data_iter:
            if n >= max_steps:
                break
            for k, v in self.train_step(batch).items():
                total[k] = total.get(k, 0.0) + v
            n += 1
        return {k: v / max(n, 1) for k, v in total.items()} | {"steps": n}
