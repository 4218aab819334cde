"""The port's vision scripts, driven in-process through their ``main(argv)``.

  * ``vit2d.train.main`` and ``vit3d.train.main`` on the CPU with the
    arguments of tests/test_data_and_scripts.py (one or two epochs of two
    steps at B=2, synthetic data): the epoch loop runs every epoch, the
    history has one entry per epoch, ``best_model`` and the regular
    ``checkpoint_tokens_seen_0`` with their meta, the log and the plot land
    in ``--ckpt-dir``; nothing is written into the working directory and
    the tracked plots at the repository root stay byte for byte; the last
    checkpoint restores the returned params exactly (no tolerance: a copy);
  * each script without ``--device`` raises where there is no card.

Every test runs in ``tmp_path``.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from vats_tpu_torch.checkpoint import load_checkpoint
from vats_tpu_torch.scripts.vision.vit2d import train as vit2d_train
from vats_tpu_torch.scripts.vision.vit3d import train as vit3d_train
from vats_tpu_torch.train import create_train_state
from vats_tpu_torch.train.vision import create_vision_optimizer

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
#: (script, its arguments on the CPU, the plot's name, epochs)
CASES = {
    "vit2d": (vit2d_train, ["--size", "xsmall", "--num-classes", "4", "--epochs", "2",
                            "--steps-per-epoch", "2", "--batch-size", "2"],
              "vit2d_training_metrics.png", 2),
    "vit3d": (vit3d_train, ["--size", "tiny", "--frames", "4", "--epochs", "2",
                            "--steps-per-epoch", "2", "--batch-size", "2"],
              "vit3d_training_metrics.png", 2),
}


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.mark.parametrize("name", sorted(CASES))
def test_vision_script_epoch_loop_checkpoints_and_plot(in_tmp, name):
    script, argv, plot, epochs = CASES[name]
    tracked = {p: (REPO / p).read_bytes() for p in
               ("vit2d_training_metrics.png", "vit3d_training_metrics.png")}
    ckpt = str(in_tmp / "ckpt")
    out = script.main(argv + ["--device", "cpu", "--ckpt-dir", ckpt])
    hist = out["history"]
    assert all(len(v) == epochs for v in hist.values()) and "val_loss" in hist
    assert np.isfinite(hist["train_loss"]).all() and np.isfinite(hist["val_loss"]).all()
    assert int(out["state"].step) == epochs * 2  # a step a batch (micro-steps)
    files = set(os.listdir(ckpt))
    assert {"best_model", "best_model.meta.json", "checkpoint_tokens_seen_0",
            "checkpoint_tokens_seen_0.meta.json", "logs", plot} <= files
    assert out["plot"] == os.path.join(ckpt, plot)
    assert os.path.exists(os.path.join(ckpt, "logs", "training.log"))
    # a regular save every epoch (both scripts' save frequency is 1)
    assert all(s["regular"] == os.path.join(ckpt, "checkpoint_tokens_seen_0")
               for s in out["saves"])
    assert os.listdir(in_tmp) == ["ckpt"]
    assert {p: (REPO / p).read_bytes() for p in tracked} == tracked
    with open(os.path.join(ckpt, "checkpoint_tokens_seen_0.meta.json")) as f:
        meta = json.load(f)
    assert meta["is_best"] is False and meta["loss"] == hist["val_loss"][-1]
    assert meta["training_args"]["batch_size"] == 2
    assert meta["training_args"]["epochs"] == epochs
    # the last regular checkpoint holds the returned params, bit for bit
    model = out["model"]
    fresh = create_train_state(model, create_vision_optimizer(out["training_args"], 2))
    saved = {n: p.detach().clone() for n, p in model.named_parameters()}
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    load_checkpoint(os.path.join(ckpt, "checkpoint_tokens_seen_0"), target=fresh)
    for n, p in model.named_parameters():
        assert torch.equal(p, saved[n]), n


@pytest.mark.parametrize("name", sorted(CASES))
def test_vision_script_defaults_to_the_card(in_tmp, name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")
    script, argv, _, _ = CASES[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        script.main(argv + ["--ckpt-dir", "unused"])
    assert os.listdir(in_tmp) == []
