"""Train state: params, optimizer state and progress counters.

Counterpart of ``vats_tpu/train/state.py`` (a flax ``TrainState`` with
``tokens_seen`` and ``skipped_steps``).  ``params`` are the model's own
``nn.Parameter`` tensors by name, so an update in place is the model's
update; ``step``, ``tokens_seen`` and ``skipped_steps`` are int32 device
tensors, so counting never waits for the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn


@dataclass
class TrainState:
    params: Dict[str, torch.Tensor]
    tx: Any
    opt_state: Any
    step: torch.Tensor
    tokens_seen: torch.Tensor
    skipped_steps: torch.Tensor

    def apply_gradients(self, grads: Mapping[str, torch.Tensor]) -> "TrainState":
        """``tx`` applied to the params in place, and one more step."""
        with torch.no_grad():
            self.opt_state = self.tx.update_(self.params, grads, self.opt_state)
            self.step += 1
        return self


def create_train_state(
    model: nn.Module, tx, params: Optional[Mapping[str, torch.Tensor]] = None
) -> TrainState:
    """A state over ``model``'s parameters (after loading ``params``, a
    state dict, when given), with ``tx``'s initial state."""
    if params is not None:
        model.load_state_dict(params)
    named = dict(model.named_parameters())
    dev = next(iter(named.values())).device

    def zero():
        return torch.zeros((), dtype=torch.int32, device=dev)

    return TrainState(params=named, tx=tx, opt_state=tx.init(named), step=zero(),
                      tokens_seen=zero(), skipped_steps=zero())
