"""A run with its timed path broken underneath comes out not correct.

Each test drives a whole run of a tiny cell on the CPU (the harness's look
for a chip skipped) through the cells' own drivers and limits, with one
fault planted in the program: a training step that returns its state
unchanged; half of each batch left out, the mean taken over the rest; a
served token altered where it is sampled, in every row or in the sampling
rows alone.  The same run without the fault comes out correct.  (No cell spans chips, so no exchange can be left out.)
"""

import torch
import pytest

from benchmark import harness
from benchmark.drivers import serve, train
from benchmark.tests import tiny

TRAIN_CELLS = [("lm_rows", "medium_moe.train_short_512"),
               ("lm_packed", "medium_moe.train_packed_2k")]
#: (tiny mix, the cell whose limits it is held to): no open-loop cell is in
#: the manifest, so the open loop is held to the serving cell's limits
SERVE_CELLS = [("closed_loop", "medium_e8.decode_heavy"), ("open_loop", "medium_e8.decode_heavy")]


def _correct(out) -> bool:
    return harness.within(out["checks"])


def _wrap_step(monkeypatch, make_broken):
    import vats_tpu_torch.train as port_train

    real_make = port_train.make_train_step

    def make(model, targs):
        return make_broken(real_make(model, targs))

    monkeypatch.setattr(port_train, "make_train_step", make)


def state_unchanged(real):
    from vats_tpu_torch.train.step_graphs import state_tensors

    def step(state, batch, rng):
        saved = [t.detach().clone() for t in state_tensors(state)]
        state, metrics = real(state, batch, rng)
        with torch.no_grad():
            for t, s in zip(state_tensors(state), saved):
                t.copy_(s)
        return state, metrics
    return step


def half_batch(real):
    def step(state, batch, rng):
        return real(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()}, rng)
    return step


@pytest.mark.parametrize("kind,cell", TRAIN_CELLS)
def test_sound_training_run_is_correct(kind, cell):
    assert _correct(train.run(tiny.train_ctx(kind, cell)))


@pytest.mark.parametrize("fault", [state_unchanged, half_batch], ids=lambda f: f.__name__)
@pytest.mark.parametrize("kind,cell", TRAIN_CELLS)
def test_training_fault_is_not_correct(monkeypatch, kind, cell, fault):
    _wrap_step(monkeypatch, fault)
    out = train.run(tiny.train_ctx(kind, cell))
    assert not _correct(out), out["checks"]


@pytest.mark.parametrize("kind,cell", SERVE_CELLS)
def test_sound_serving_run_is_correct(kind, cell):
    out = serve.run(tiny.serve_ctx(kind, cell))
    assert min(out["info"]["checked_tokens"]) > 0
    assert _correct(out), out["checks"]


@pytest.mark.parametrize("sampled_only", [False, True], ids=["every_row", "sampled_rows"])
@pytest.mark.parametrize("kind,cell", SERVE_CELLS)
def test_altered_token_is_not_correct(monkeypatch, kind, cell, sampled_only):
    from vats_tpu_torch.inference.serving import ServingEngine

    real = ServingEngine._sample

    def altered(self, logits, bufs, positions):
        tok = real(self, logits, bufs, positions)
        bad = (tok + 1) % logits.shape[-1]
        if not sampled_only:
            return bad
        return torch.where(bufs["temp"] > 0, bad, tok).to(tok.dtype)

    monkeypatch.setattr(ServingEngine, "_sample", altered)
    out = serve.run(tiny.serve_ctx(kind, cell))
    assert min(out["info"]["checked_tokens"]) > 0
    assert not _correct(out), out["checks"]
    if sampled_only:  # the greedy rows are sound: the sampled check catches it
        greedy, sampled = out["checks"]["mean_logit_gap"], out["checks"]["sampled_set_gap"]
        assert greedy["value"] <= greedy["limit"] < sampled["limit"] < sampled["value"]
