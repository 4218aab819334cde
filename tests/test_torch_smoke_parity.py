"""The per-leaf parity checks (``torch_card_parity.leaf_errors`` /
``leaf_report``) can fail.

The card tests' train steps against the CPU (medium_dense, ViT-2D and the
image- and video-gen trainers at full width, in
``tests/test_torch_cuda_kernels.py``) and ``chip_smoke.py``'s multi-rank
phases hold each parameter's gradient and its change in the step, leaf by
leaf.  Here both sides run on the CPU: a ViT-2D train step through the
flash path's plain backward, against the same step with one of the
backward's outputs made wrong.  Equal runs read 0 on every
leaf; a negated dq or dk (whose share of the fused ``w_qkv`` gradient is
small at init) moves that leaf's change by far more than the change limit;
dv 10% too large moves the gradients past the gradient limit."""

import pytest
import torch

import torch_card_parity as parity
from vats_tpu_torch.configs import vit2d_xsmall
from vats_tpu_torch.models import ImageEncoder
from vats_tpu_torch.ops import flash_attention as fa
from vats_tpu_torch.train import (
    VisionTrainingArgs,
    create_train_state,
    create_vision_optimizer,
    make_vision_train_step,
)

torch.set_num_threads(1)

CFG = vit2d_xsmall(target_size=64, patch_size=8, d_model=144, num_heads=2, query_groups=1,
                   num_layers=2, dropout=0.0, num_classes=10, attention_impl="flash")
ARGS = VisionTrainingArgs(grad_accum_steps=1, use_augmentation=False, warmup_epochs=1,
                          epochs=10)


def _stepped(monkeypatch, wrong=None):
    """A model after one train step from seed 1 and its params before it;
    ``wrong`` = (index of dq / dk / dv, factor) alters the plain backward."""
    model = ImageEncoder(CFG, device="cpu", seed=1)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = create_train_state(model, create_vision_optimizer(ARGS, 1))
    if wrong is not None:
        ref, (i, f) = fa.flash_attention_bwd_ref, wrong
        monkeypatch.setattr(fa, "flash_attention_bwd_ref", lambda *a, **kw: tuple(
            f * g if j == i else g for j, g in enumerate(ref(*a, **kw))))
    x = torch.randn((2, 3, 64, 64), generator=torch.Generator().manual_seed(0))
    make_vision_train_step(model, ARGS, 10)(
        state, {"images": x, "labels": torch.tensor([3, 7])}, 0)
    monkeypatch.undo()
    return model, start


def _reports(monkeypatch, wrong):
    """(gradient check, change check): None where it held, else its message."""
    want, start = _stepped(monkeypatch)
    got, _ = _stepped(monkeypatch, wrong)
    change = lambda n, p: p.detach() - start[n]  # noqa: E731
    out = []
    for of, limit in ((parity.leaf_grad, parity.PARITY_LEAF_GRAD_RTOL),
                      (change, parity.PARITY_LEAF_CHANGE_RTOL)):
        try:
            parity.leaf_report("leaf", parity.leaf_errors(got, want, of), limit)
            out.append(None)
        except AssertionError as e:
            out.append(str(e))
    return out


def test_leaf_checks_read_zero_on_equal_runs(monkeypatch):
    want, start = _stepped(monkeypatch)
    got, _ = _stepped(monkeypatch)
    for of in (parity.leaf_grad, lambda n, p: p.detach() - start[n]):
        errs = parity.leaf_errors(got, want, of)
        assert len(errs) == len(list(want.parameters()))
        assert max(errs.values()) == 0.0


@pytest.mark.parametrize("wrong, fails", [
    ((0, -1.0), "change"),  # dq negated
    ((1, -1.0), "change"),  # dk negated
    ((2, 1.1), "gradients"),  # dv 10% too large
], ids=["dq-negated", "dk-negated", "dv-scaled"])
def test_leaf_checks_catch_a_wrong_backward(monkeypatch, wrong, fails):
    grads, change = _reports(monkeypatch, wrong)
    caught = grads if fails == "gradients" else change
    assert caught is not None and "w_qkv" in caught


def test_leaf_errors_flag_a_leaf_only_the_card_moved():
    a, b = torch.nn.Linear(2, 2), torch.nn.Linear(2, 2)
    with torch.no_grad():
        b.weight.zero_()
        a.weight.zero_()
        a.weight[0, 0] = 1.0
    errs = parity.leaf_errors(a, b, lambda n, p: p if n == "weight" else p * 0)
    assert errs == {"weight": float("inf"), "bias": 0.0}
    with pytest.raises(AssertionError, match="beyond it: \\['weight'\\]"):
        parity.leaf_report("leaf", errs, 0.5)
