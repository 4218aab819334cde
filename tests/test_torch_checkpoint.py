"""The port's checkpoints: round trip, schema, and JAX checkpoints carried in.

  * Port round trip (nlp_xsmall at 2 layers, fp32, dropout 0), for both
    optimizer layouts (bare AdamW at grad_accum_steps 1; MultiSteps with
    clip and skip at 4): after three port train steps, save and load into a
    fresh state.  Params, moments, accumulated gradients and counters are
    bit-equal to the saved state, and the restored state's next step is
    bit-equal to the same step of the state that never went through a save
    (the same CPU ops on the same bits).  The async save snapshots the
    state at the call, whatever the steps taken before ``wait()``.
  * Schema: ``vats_tpu``'s ``save_checkpoint`` and the port's write meta
    JSON with the same keys and values and the same names; the JAX meta's
    ``model_args`` loads through the port's ``ModelArgs.from_dict``.
  * JAX -> port: ``vats_tpu`` trains one step and saves with orbax; the
    checkpoint is restored on the JAX side and converted with
    ``train_state_from_jax``.  The params, moments and accumulated
    gradients are carried exactly; the port's logits match ``vats_tpu``'s
    (LOGIT_TOL, as tests/test_torch_text_lm.py: fp32 sums in another
    order); one more step in both packages gives params within PARAM_TOL
    of tests/test_torch_training.py.  Both layouts (at grad_accum_steps 2
    the next step is the boundary, so the carried accumulator is applied),
    with an fp32 and a bf16 first moment.  The schedule has no warmup at
    10 training steps, so every update runs at a nonzero learning rate.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import meta

from vats_tpu.checkpoint import load_checkpoint as j_load_checkpoint
from vats_tpu.checkpoint import save_checkpoint as j_save_checkpoint
from vats_tpu.configs import TrainingArgs as JTrainingArgs
from vats_tpu.configs import nlp_xsmall as j_nlp_xsmall
from vats_tpu.data import synthetic_lm_batches as j_batches
from vats_tpu.models import TextLM as JTextLM
from vats_tpu.train import create_optimizer as j_create_optimizer
from vats_tpu.train import create_train_state as j_create_train_state
from vats_tpu.train import make_train_step as j_make_train_step
from vats_tpu_torch.checkpoint import CheckpointManager, load_checkpoint, save_checkpoint
from vats_tpu_torch.checkpoint.manager import state_tree
from vats_tpu_torch.configs import ModelArgs, TrainingArgs, nlp_xsmall
from vats_tpu_torch.models import TextLM
from vats_tpu_torch.train import create_optimizer, create_train_state, make_train_step
from vats_tpu_torch.train.optimizer import AdamWState, MultiStepsState
from vats_tpu_torch.utils.convert import params_from_jax, train_state_from_jax

torch.set_num_threads(1)

LOGIT_TOL = dict(atol=2e-4, rtol=2e-3)
PARAM_TOL = {None: dict(atol=5e-6, rtol=1e-5), "bfloat16": dict(atol=3e-5, rtol=1e-5)}
META_KEYS = {"model_args", "training_args", "tokens_seen", "loss", "is_best"}
MODEL_KW = dict(num_layers=2, dropout=0.0, dtype="float32", gradient_checkpointing=False,
                attention_impl="xla")
B, T = 2, 32


def np_batches(n, seed):
    return [jax.tree_util.tree_map(np.asarray, x) for x in
            j_batches(jax.random.PRNGKey(seed), vocab_size=512, batch_size=B, seq_len=T,
                      num_batches=n, pad_fraction=0.3)]


def torch_batch(nb):
    return {k: torch.from_numpy(v.copy()) for k, v in nb.items()}


def port_setup(accum, mu_dtype=None, seed=0):
    cfg = nlp_xsmall(**MODEL_KW)
    targs = TrainingArgs(grad_accum_steps=accum, adam_mu_dtype=mu_dtype)
    model = TextLM(cfg, device="cpu", seed=seed)
    state = create_train_state(model, create_optimizer(targs, 10))
    return cfg, targs, model, state, make_train_step(model, targs)


def assert_trees_equal(a, b, where="state"):
    """Bit-equal tensors (and equal scalars and class tags) throughout."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, where
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_trees_equal(a[k], b[k], f"{where}.{k}")
    else:
        assert a == b, where


# --- port round trip ----------------------------------------------------------


@pytest.mark.parametrize("accum", [1, 4])
def test_port_round_trip_is_bit_equal_and_so_is_the_next_step(tmp_path, accum):
    cfg, targs, model, state, step = port_setup(accum)
    batches = np_batches(4, seed=3)
    for i in range(3):
        state, _ = step(state, torch_batch(batches[i]), i)
    layout = MultiStepsState if accum > 1 else AdamWState
    assert isinstance(state.opt_state, layout)
    if accum > 1:
        assert state.opt_state.mini_step == 3
        assert any(bool(a.abs().sum() > 0) for a in state.opt_state.acc_grads.values())

    tokens = int(state.tokens_seen)
    path = save_checkpoint(str(tmp_path), state, model_args=cfg, training_args=targs,
                           loss=1.5)
    assert os.path.basename(path) == f"checkpoint_tokens_seen_{tokens}"
    best = save_checkpoint(str(tmp_path), state, model_args=cfg, is_best=True, step_key=7)
    assert os.path.basename(best) == "best_model"
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["best_model", "best_model.meta.json", f"checkpoint_tokens_seen_{tokens}",
         f"checkpoint_tokens_seen_{tokens}.meta.json"])  # no temporary left

    # a fresh state of other weights, overwritten from the file
    _, _, model2, fresh, step2 = port_setup(accum, seed=1)
    restored, meta_ = load_checkpoint(path, target=fresh)
    assert restored is fresh
    assert_trees_equal(state_tree(state), state_tree(restored))
    assert set(meta_) == META_KEYS
    assert meta_["tokens_seen"] == tokens and meta_["loss"] == 1.5
    assert meta_["is_best"] is False and meta_["training_args"]["grad_accum_steps"] == accum
    assert ModelArgs.from_dict(meta_["model_args"]) == cfg
    # the model's own parameters were overwritten (the state holds them)
    for (n, p), (_, q) in zip(model.named_parameters(), model2.named_parameters()):
        assert torch.equal(p, q), n

    # the next step: restored and never-saved states stay bit-equal
    state, m1 = step(state, torch_batch(batches[3]), 3)
    restored, m2 = step2(restored, torch_batch(batches[3]), 3)
    assert torch.equal(m1["loss"], m2["loss"])
    assert_trees_equal(state_tree(state), state_tree(restored))

    raw, _ = load_checkpoint(path)
    assert set(raw) == {"params", "opt_state", "step", "tokens_seen", "skipped_steps"}
    assert raw["params"].keys() == dict(model.named_parameters()).keys()


def test_loading_into_another_layout_raises(tmp_path):
    _, _, _, state, _ = port_setup(4)
    path = save_checkpoint(str(tmp_path), state)
    _, _, _, other, _ = port_setup(1)
    with pytest.raises(ValueError, match="optimizer layout"):
        load_checkpoint(path, target=other)
    _, _, _, bf16, _ = port_setup(4, mu_dtype="bfloat16")
    with pytest.raises(ValueError, match="does not fit"):
        load_checkpoint(path, target=bf16)


def test_async_save_snapshots_the_state_at_the_call(tmp_path):
    """Counterpart of tests/test_training.py:221: the manager's async save
    restores bit-equal, and a step taken before ``wait()`` does not reach
    the checkpoint (the snapshot is taken at the call)."""
    cfg, targs, model, state, step = port_setup(1)
    batches = np_batches(2, seed=5)
    state, _ = step(state, torch_batch(batches[0]), 0)
    want = state_tree(state, lambda t: t.clone())
    mgr = CheckpointManager(str(tmp_path), model_args=cfg, training_args=targs,
                            async_save=True)
    saved = mgr.maybe_save(state, val_loss=1.0, force_regular=True)
    assert saved["best"] is not None and saved["regular"] is not None
    state, _ = step(state, torch_batch(batches[1]), 1)  # in place, before the write ends
    mgr.wait()
    for path in (saved["best"], saved["regular"]):
        _, _, _, fresh, _ = port_setup(1, seed=2)
        restored, meta_ = load_checkpoint(path, target=fresh)
        assert meta_["loss"] == 1.0
        assert_trees_equal(want, state_tree(restored))
    # no improvement: nothing but the forced regular save
    again = mgr.maybe_save(state, val_loss=2.0)
    assert again == {"best": None, "regular": None}
    mgr.close()


@pytest.mark.parametrize("async_save", [False, True])
def test_a_round_writes_the_state_once(tmp_path, async_save):
    """A round that saves best and regular writes one file: the regular
    name is a hard link to ``best_model``, each with its own meta.  The
    next improvement replaces ``best_model`` with a new file and leaves the
    earlier regular checkpoint as it was (bit-equal to its round's state)."""
    cfg, targs, model, state, step = port_setup(1)
    batches = np_batches(2, seed=6)
    mgr = CheckpointManager(str(tmp_path), model_args=cfg, training_args=targs,
                            async_save=async_save)
    state, _ = step(state, torch_batch(batches[0]), 0)
    want = state_tree(state, lambda t: t.clone())
    first = mgr.maybe_save(state, val_loss=1.0, force_regular=True)
    mgr.wait()
    assert os.path.samefile(first["best"], first["regular"])
    with open(first["best"] + ".meta.json") as f, \
            open(first["regular"] + ".meta.json") as g:
        assert (json.load(f)["is_best"], json.load(g)["is_best"]) == (True, False)
    state, _ = step(state, torch_batch(batches[1]), 1)
    second = mgr.maybe_save(state, val_loss=0.5, force_regular=True)
    mgr.close()
    assert second["best"] == first["best"] and second["regular"] != first["regular"]
    assert os.path.samefile(second["best"], second["regular"])
    assert not os.path.samefile(first["best"], first["regular"])
    assert sorted(p for p in os.listdir(tmp_path) if not p.endswith(".meta.json")) == \
        sorted(os.path.basename(p) for p in (first["best"], first["regular"],
                                            second["regular"]))
    _, _, _, fresh, _ = port_setup(1, seed=2)
    restored, meta_ = load_checkpoint(first["regular"], target=fresh)
    assert meta_["loss"] == 1.0
    assert_trees_equal(want, state_tree(restored))


# --- schema agreement with vats_tpu -----------------------------------------------


def jax_setup(accum, mu_dtype=None):
    jcfg = j_nlp_xsmall(**MODEL_KW)
    jt = JTrainingArgs(grad_accum_steps=accum, adam_mu_dtype=mu_dtype)
    jm = JTextLM(jcfg)
    js = j_create_train_state(jm, j_create_optimizer(jt, 10), jax.random.PRNGKey(0),
                              jnp.zeros((1, 8), jnp.int32))
    return jcfg, jt, jm, js, j_make_train_step(jm, jt)


@pytest.mark.parametrize("is_best", [True, False])
def test_meta_schema_and_names_equal_jax(tmp_path, is_best):
    jcfg, jt, _, js, _ = jax_setup(4)
    cfg, targs, _, state, _ = port_setup(4)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jpath = j_save_checkpoint(str(jdir), js, model_args=jcfg, training_args=jt, loss=0.25,
                              is_best=is_best, step_key=12)
    tpath = save_checkpoint(str(tdir), state, model_args=cfg, training_args=targs,
                            loss=0.25, is_best=is_best, step_key=12)
    assert os.path.basename(jpath) == os.path.basename(tpath)
    with open(jpath + ".meta.json") as f:
        jmeta = json.load(f)
    with open(tpath + ".meta.json") as f:
        tmeta = json.load(f)
    assert set(jmeta) == set(tmeta) == META_KEYS
    assert jmeta == tmeta
    assert ModelArgs.from_dict(jmeta["model_args"]) == cfg
    assert dataclasses.asdict(ModelArgs.from_dict(jmeta["model_args"])) == \
        dataclasses.asdict(jcfg)


# --- JAX checkpoint -> port ---------------------------------------------------------


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, meta.unbox(tree))


def jax_opt_trees(js, accum):
    """(adam state, acc_grads or None) of a JAX TrainState."""
    if accum > 1:
        return js.opt_state.inner_opt_state.inner_state[0], js.opt_state.acc_grads
    return js.opt_state[0], None


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
def test_jax_checkpoint_carried_into_the_port(tmp_path, accum, mu_dtype):
    jcfg, jt, jm, js, jstep = jax_setup(accum, mu_dtype)
    batches = np_batches(2, seed=11)
    js, _ = jstep(js, jax.tree_util.tree_map(jnp.asarray, batches[0]),
                  jax.random.PRNGKey(0))
    host = jax.device_get(js)
    path = j_save_checkpoint(str(tmp_path), js, model_args=jcfg, training_args=jt,
                             loss=3.0)
    restored, jmeta = j_load_checkpoint(path, target=host)

    cfg = ModelArgs.from_dict(jmeta["model_args"])
    targs = TrainingArgs(grad_accum_steps=accum, adam_mu_dtype=mu_dtype)
    model = TextLM(cfg, device="cpu", seed=5)
    tx = create_optimizer(targs, 10)
    state = train_state_from_jax(restored, model, targs, tx)

    # carried exactly: params, moments, accumulator, counters
    for n, w in params_from_jax(_np(restored.params), cfg).items():
        assert torch.equal(state.params[n].detach(), w), n
    adam, acc = jax_opt_trees(restored, accum)
    port_adam = state.opt_state.inner_opt_state.inner_state if accum > 1 else state.opt_state
    mu_t = torch.bfloat16 if mu_dtype else torch.float32
    for tree, got in ((adam.mu, port_adam.mu), (adam.nu, port_adam.nu)) + (
            ((acc, state.opt_state.acc_grads),) if acc is not None else ()):
        want = params_from_jax(_np(tree), cfg, dtype=next(iter(got.values())).dtype)
        for n, w in want.items():
            assert torch.equal(got[n], w), n
    assert port_adam.mu["token_embed.weight"].dtype == mu_t
    assert int(port_adam.count) == int(adam.count)
    if accum > 1:
        assert state.opt_state.mini_step == int(restored.opt_state.mini_step) == 1
        assert int(state.opt_state.gradient_step) == 0
    for name in ("step", "tokens_seen", "skipped_steps"):
        assert int(getattr(state, name)) == int(getattr(restored, name))

    # the same logits
    rs = np.random.RandomState(3)
    ids = rs.randint(1, 512, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), bool)
    mask[1, 12:] = False
    ids = np.where(mask, ids, 0)
    jl, _, _ = jm.apply({"params": restored.params}, jnp.asarray(ids),
                        padding_mask=jnp.asarray(mask))
    with torch.no_grad():
        tl, _, _ = model.eval()(torch.from_numpy(ids), padding_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)

    # one more step in both: the params move (the boundary at accum 2) alike
    model.train()
    step = make_train_step(model, targs)
    before = {n: p.detach().clone() for n, p in state.params.items()}
    js2, jm_ = jstep(restored.replace(apply_fn=jm.apply),
                     jax.tree_util.tree_map(jnp.asarray, batches[1]), jax.random.PRNGKey(1))
    state, tm_ = step(state, torch_batch(batches[1]), 1)
    np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]), rtol=1e-5)
    got = model.state_dict()
    for n, w in params_from_jax(_np(js2.params), cfg).items():
        np.testing.assert_allclose(got[n].numpy(), w.numpy(), err_msg=n,
                                   **PARAM_TOL[mu_dtype])
    for n in ("token_embed.weight", "layers.1.attn_block.attn.w_qkv.weight",
              "layers.0.moe_block.moe.experts.w_down"):
        assert not torch.equal(got[n], before[n]), n
    assert int(state.step) == int(js2.step) and int(state.tokens_seen) == int(js2.tokens_seen)


def test_layout_mismatch_raises():
    _, _, _, js, _ = jax_setup(2)
    cfg = nlp_xsmall(**MODEL_KW)
    targs = TrainingArgs(grad_accum_steps=1)
    with pytest.raises(ValueError, match="layout"):
        train_state_from_jax(jax.device_get(js), TextLM(cfg, device="cpu"), targs,
                             create_optimizer(targs, 10))
    _, _, _, js1, _ = jax_setup(1)
    targs = TrainingArgs(grad_accum_steps=1, adam_mu_dtype="bfloat16")
    with pytest.raises(ValueError, match="adam_mu_dtype"):
        train_state_from_jax(jax.device_get(js1), TextLM(cfg, device="cpu"), targs,
                             create_optimizer(targs, 10))
