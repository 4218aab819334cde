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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Mapping, Optional, Tuple

import torch

from vats_tpu_torch.configs.image_gen import ImageGenArgs
from vats_tpu_torch.device import resolve_device
from vats_tpu_torch.models.image_gen import VQVAE
from vats_tpu_torch.train.optimizer import AdamW, ClipByGlobalNorm, cosine_with_warmup_schedule
from vats_tpu_torch.train.state import create_train_state

Batch = Dict[str, torch.Tensor]


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

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _inputs(self, batch: Batch):
        dev = self.device
        get = lambda k: None if batch.get(k) is None else torch.as_tensor(batch[k]).to(dev)  # noqa: E731
        return (get("images"), get("text_embeddings"), get("image_attention_mask"),
                get("text_attention_mask"))

    def loss(self, batch: Batch, dropout_seed: Optional[int]):
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

    def train_step(self, batch: Batch) -> Dict[str, float]:
        seed = int(torch.randint(0, 1 << 62, (1,), generator=self._seeds))
        for p in self.state.params.values():
            p.grad = None
        loss, metrics = self.loss(batch, seed)
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in self.state.params.items()}
        self.state.apply_gradients(grads)
        return {k: float(v.detach()) for k, v in metrics.items()}

    @torch.no_grad()
    def eval_step(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """The deterministic forward's VQ, reconstruction and total loss."""
        images, text, img_mask, txt_mask = self._inputs(batch)
        recon, vq_loss, _, _ = self.model(images, text, img_mask, txt_mask,
                                          deterministic=True)
        recon_loss = (recon.float() - images.float()).square().mean()
        return {"vq_loss": vq_loss, "recon_loss": recon_loss, "loss": vq_loss + recon_loss}

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
