"""The training programs the JAX package jits, as the port runs them through
its graph sets (``vats_tpu_torch/train/step_graphs.py``), on the CPU, where
each key's body runs eagerly over its static buffers:

  * the dropout masks, a counter-based hash of a seed (int or device
    tensor), a layer and a site: each changes the mask, the kept share is
    binomial (within 5 standard deviations), two masks agree as independent
    ones do, and the remat recompute draws the same mask
    (``test_torch_training.py::test_remat_policies_with_dropout_give_the_same_grads``);
  * the optimizer states updated in place: every counter and norm keeps its
    ``data_ptr``; values against optax over three applied updates (params
    rtol 1e-5, atol 1e-7; counters and norms exactly / rtol 1e-6);
  * the ``where`` chooser (over the mask-based cutmix, whose core
    ``test_torch_vision_data.py`` holds to JAX's) against
    ``vats_tpu/data/augmentations.py``'s ``random_augmentation`` given JAX's
    own draws (images atol 1e-6, labels and lam exactly);
  * the LM train (with accumulation) and eval steps, the ViT-2D step at two
    accumulation positions, the image-gen trainer's step and eval, and both
    video trainers, against ``vats_tpu``'s jitted steps at dropout 0 with
    the existing tolerances (loss rtol 1e-5, params as
    ``test_torch_training.py``), each from one entry per key.
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.linen import meta

from vats_tpu.data import augmentations as JA
from vats_tpu.train import make_eval_step as j_make_eval_step
from vats_tpu.train.optimizer import create_optimizer as j_create_optimizer
from vats_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
from vats_tpu_torch.configs import TrainingArgs
from vats_tpu_torch.data import augmentations as TA
from vats_tpu_torch.nn import dropout as D
from vats_tpu_torch.train import (
    create_optimizer,
    create_train_state,
    create_vision_optimizer,
    make_eval_step,
    make_train_step,
    make_train_step_fn,
    train,
    validate,
)
from vats_tpu_torch.train.step_graphs import state_tensors
from vats_tpu_torch.train.vision import VisionTrainingArgs

from test_torch_training import PARAM_TOL, assert_params_equal, both, np_batches

torch.set_num_threads(1)


def t(x):
    return torch.from_numpy(np.array(x))


def torch_batch(nb):
    return {k: torch.from_numpy(v.copy()) for k, v in nb.items()}


# --- the dropout masks --------------------------------------------------------


def keep(seed, layer=0, site=D.SITE_ATTN, shape=(64, 96), rate=0.5):
    x = torch.ones(shape)
    return D.dropout(x, rate, deterministic=False, seed=seed, layer=layer, site=site) != 0


def test_mask_is_a_function_of_seed_layer_and_site():
    base = keep(5)
    assert torch.equal(base, keep(5)) and torch.equal(base, keep(torch.tensor(5)))
    for other in (keep(6), keep(5, layer=1), keep(5, site=D.SITE_FFN_BLOCK),
                  keep(torch.tensor(5 + (1 << 40)))):
        assert not torch.equal(base, other)
    # the seed's high word counts: 2^32 apart is another mask
    assert not torch.equal(keep(1), keep(1 + (1 << 32)))
    x = torch.randn(8, 40)
    out = D.dropout(x, 0.25, deterministic=False, seed=3, layer=2, site=1)
    kept = out != 0
    torch.testing.assert_close(out[kept], x[kept] / 0.75, rtol=0, atol=0)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_kept_share_is_binomial_and_masks_independent(rate):
    """n = 512 x 384 elements: the kept share within 5 sigma of 1 - rate,
    per mask; two masks (another site, another seed) both keep a position
    with probability (1 - rate)^2, within 5 sigma; no row or column keeps
    all or nothing more often than chance allows."""
    shape = (512, 384)
    n, p = shape[0] * shape[1], 1.0 - rate
    masks = [keep(s, layer=3, site=site, shape=shape, rate=rate)
             for s, site in ((11, 1), (11, 4), (12, 1))]
    for m in masks:
        assert abs(float(m.float().mean()) - p) <= 5 * math.sqrt(p * (1 - p) / n)
    for a, b in ((0, 1), (0, 2), (1, 2)):
        both_kept = float((masks[a] & masks[b]).float().mean())
        q = p * p
        assert abs(both_kept - q) <= 5 * math.sqrt(q * (1 - q) / n), (a, b)
    rows = masks[0].float().mean(1)
    assert float(rows.std()) <= 2 * math.sqrt(p * (1 - p) / shape[1])


def test_hash_is_exact_in_int64_and_python():
    xs = [0, 1, 2, 12345, (1 << 31) - 1, 1 << 31, (1 << 32) - 2, (1 << 32) - 1]
    got = D.mix32(torch.tensor(xs, dtype=torch.int64)).tolist()
    assert got == [D.mix32(x) for x in xs]
    assert all(0 <= v < (1 << 32) for v in got) and len(set(got)) == len(xs)
    u = D.uniform(torch.tensor(9), (4, 1000), layer=-2, site=2, device="cpu")
    assert u.dtype == torch.float32 and float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.02


def test_the_graph_sets_step_draws_the_masks_of_its_seed():
    """Dropout 0.1, remat 'dots': the step through its graph set (a tensor
    seed in a static buffer) equals the raw step given the same int seed,
    bit for bit, and another seed gives another loss."""
    from vats_tpu_torch.configs import nlp_xsmall
    from vats_tpu_torch.data import synthetic_lm_batches
    from vats_tpu_torch.models import TextLM

    cfg = nlp_xsmall(num_layers=2, dropout=0.1, dtype="float32",
                     gradient_checkpointing=True, remat_policy="dots")
    ta = TrainingArgs(grad_accum_steps=1, fused_ce_chunk=8)
    batch = next(synthetic_lm_batches(torch.Generator().manual_seed(2), vocab_size=512,
                                      batch_size=2, seq_len=24))
    out = {}
    for name in ("graph", "raw", "other"):
        model = TextLM(cfg, device="cpu", seed=0)
        state = create_train_state(model, create_optimizer(ta, 100))
        step = make_train_step_fn(model, ta) if name == "raw" else make_train_step(model, ta)
        _, m = step(state, batch, 99 if name == "other" else 1234)
        out[name] = (float(m["loss"]), {n: p.detach().clone()
                                        for n, p in model.named_parameters()})
    assert out["graph"][0] == out["raw"][0] != out["other"][0]
    for n, p in out["graph"][1].items():
        assert torch.equal(p, out["raw"][1][n]), n


# --- the optimizer states in place ---------------------------------------------


def _ptrs(opt_state):
    return [x.data_ptr() for x in state_tensors(opt_state)]


@pytest.mark.parametrize("kind", ["lm_accumulated", "vision_accumulated"])
def test_optimizer_states_update_in_place_and_match_optax(kind):
    """Two mini-steps a window, three windows, then a NaN window: every
    tensor of the state keeps its address; params, the boundary count, the
    last norm and (LM) the non-finite count match optax's."""
    rs = np.random.RandomState(1)
    shapes = {"a": (5, 7), "b": (11,)}
    params = {n: rs.randn(*s).astype(np.float32) for n, s in shapes.items()}
    if kind == "lm_accumulated":
        from vats_tpu.configs import TrainingArgs as JTrainingArgs

        kw = dict(grad_accum_steps=2, learning_rate=1e-2, adam_mu_dtype=None)
        jtx, tx = j_create_optimizer(JTrainingArgs(**kw), 10), create_optimizer(
            TrainingArgs(**kw), 10)
    else:
        from vats_tpu.train.vision import VisionTrainingArgs as JArgs
        from vats_tpu.train.vision import create_vision_optimizer as j_create_opt

        kw = dict(learning_rate=1e-2, warmup_epochs=1, epochs=4, grad_accum_steps=2)
        jtx, tx = j_create_opt(JArgs(**kw), steps_per_epoch=1), create_vision_optimizer(
            VisionTrainingArgs(**kw), 1)
    jp = {n: jnp.asarray(p) for n, p in params.items()}
    jst = jtx.init(jp)
    tp = {n: t(p) for n, p in params.items()}
    st = tx.init(tp)
    ptrs = _ptrs(st)
    grads = [{n: (rs.randn(*s) * (0.2 + i)).astype(np.float32) for n, s in shapes.items()}
             for i in range(6)]
    nan = {n: np.full(s, np.nan, np.float32) for n, s in shapes.items()}
    for i, g in enumerate(grads + ([nan, nan] if kind == "lm_accumulated" else [])):
        upd, jst = jtx.update({n: jnp.asarray(x) for n, x in g.items()}, jst, jp)
        jp = optax.apply_updates(jp, upd)
        with torch.no_grad():
            assert tx.update_(tp, {n: t(x) for n, x in g.items()}, st) is st
        assert _ptrs(st) == ptrs, i
        for n in shapes:
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]), rtol=1e-5, atol=1e-7,
                                       err_msg=f"{i} {n}")
        assert st.mini_step == int(jst.mini_step)
        assert int(st.gradient_step) == int(jst.gradient_step)
        if kind == "lm_accumulated":  # optax's plain clip keeps no norm
            np.testing.assert_allclose(float(st.inner_opt_state.last_grad_norm),
                                       float(jst.inner_opt_state.last_grad_norm), rtol=1e-6)
    if kind == "lm_accumulated":  # the NaN window skipped, and counted
        assert int(st.inner_opt_state.notfinite_count) == int(
            jst.inner_opt_state.notfinite_count) == 1
        assert int(st.inner_opt_state.inner_state.count) == 3


# --- the mask-based cutmix and the where chooser -------------------------------


def _images(seed, b=6, dtype=np.float32):
    rs = np.random.RandomState(seed)
    return rs.randn(b, 3, 12, 10).astype(dtype), np.arange(10, 10 + b, dtype=np.int32)


def jax_draws(key, b, h, w, alpha, cutmix_alpha):
    """JAX's random_augmentation draws, replayed on its keys."""
    rng_choice, rng_aug = jax.random.split(key)
    m_lam, m_perm = jax.random.split(rng_aug)
    c_lam, c_perm, c_x, c_y = jax.random.split(rng_aug, 4)
    d = {"choice": jax.random.randint(rng_choice, (), 0, 3),
         "mix_lam": jax.random.beta(m_lam, alpha, alpha),
         "mix_index": jax.random.permutation(m_perm, b),
         "cut_lam0": jax.random.beta(c_lam, cutmix_alpha, cutmix_alpha),
         "cut_index": jax.random.permutation(c_perm, b),
         "cx": jax.random.randint(c_x, (), 0, w), "cy": jax.random.randint(c_y, (), 0, h)}
    return {k: torch.from_numpy(np.array(v)).to(torch.int64 if k in ("choice", "cx", "cy",
                                                                       "mix_index",
                                                                       "cut_index")
                                                 else torch.float32) for k, v in d.items()}


@pytest.mark.parametrize("seed", range(8))
def test_where_chooser_matches_jax_random_augmentation(seed):
    x, y = _images(seed)
    key = jax.random.PRNGKey(seed)
    want = JA.random_augmentation(key, jnp.asarray(x), jnp.asarray(y), 0.8, cutmix_alpha=1.0)
    draws = jax_draws(key, 6, 12, 10, 0.8, 1.0)
    got = TA.augment_given(t(x), t(y), draws)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-6)
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert float(got[3]) == float(want[3])


def test_host_draws_keep_the_identity_at_alpha_zero():
    x, y = _images(3)
    d = TA.draw_augmentation(torch.Generator().manual_seed(0), 6, 12, 10, 0.0, 0.0)
    for choice in range(3):
        d["choice"] = torch.tensor(choice)
        m, ta, tb, lam = TA.augment_given(t(x), t(y), d)
        assert torch.equal(m, t(x)) and torch.equal(tb, t(y)) and float(lam) == 1.0


# --- the LM steps through their graph sets -------------------------------------


def test_lm_train_steps_with_accumulation_use_one_entry_a_position():
    """grad_accum_steps=2 over four mini-steps against JAX's jitted step:
    two entries (one a window position) with the same batch shape, the
    state's tensors at their addresses, ``state.step`` one a call."""
    (jm, js, jstep, _), (tm, ts, tstep, _) = both(
        dict(attention_impl="xla"), dict(grad_accum_steps=2, adam_mu_dtype="bfloat16"))
    ptrs = [x.data_ptr() for x in state_tensors(ts)]
    for i, nb in enumerate(np_batches(4, seed=3)):
        js, jmet = jstep(js, jax.tree_util.tree_map(jnp.asarray, nb), jax.random.PRNGKey(i))
        ts, tmet = tstep(ts, torch_batch(nb), i)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]),
                                   rtol=1e-5)
        assert_params_equal(js, tm, tm.cfg, **PARAM_TOL["bfloat16"])
        assert int(ts.step) == i + 1 and ts.opt_state.mini_step == (i + 1) % 2
    assert [x.data_ptr() for x in state_tensors(ts)] == ptrs
    keys = list(tstep.graphs.entries)
    assert len(keys) == 2 and sorted(k[1] for k in keys) == [0, 1]
    assert int(ts.opt_state.gradient_step) == 2


def test_one_gradient_buffer_a_parameter_for_every_key():
    """grad_accum_steps=2 over two batch shapes: four entries, and each
    parameter's ``.grad`` is one buffer for all of them, which each call
    zeroes before its backward adds into it: after a call it holds that
    call's gradient, equal to the eager step's from a copy of the state
    (exactly: 0 + g is g)."""
    (_, _, _, _), (tm, ts, tstep, tt) = both(dict(attention_impl="xla"),
                                             dict(grad_accum_steps=2))
    batches = [torch_batch(nb) for nb in np_batches(2, seed=9) + np_batches(2, seed=10, b=3)]
    ptrs = None
    for i, batch in enumerate(batches):
        cm, cs = copy.deepcopy((tm, ts))
        make_train_step_fn(cm, tt)(cs, batch, i)
        tstep(ts, batch, i)
        grads = [p.grad for p in tm.parameters()]
        ptrs = ptrs or [g.data_ptr() for g in grads]
        assert [g.data_ptr() for g in grads] == ptrs, i
        for (n, p), q in zip(tm.named_parameters(), cm.parameters()):
            want = q.grad if q.grad is not None else torch.zeros_like(q)
            assert torch.equal(p.grad, want), (i, n)
    assert len(tstep.graphs.entries) == 4


def test_a_routing_record_refuses_the_capture_and_records_eagerly():
    """``MoELayer.record_routing`` keeps a Python attribute, which a replay
    cannot update: graphs on the card refuse such a model before any
    capture or warm-up; the step run eagerly (here, on the CPU) records
    its routing."""
    from vats_tpu_torch.nn.moe import MoELayer
    from vats_tpu_torch.train.step_graphs import TrainGraphs

    (_, _, _, _), (tm, ts, tstep, tt) = both(
        dict(attention_impl="xla", num_experts=4, top_k=2), dict(grad_accum_steps=1))
    layers = [m for m in tm.modules() if isinstance(m, MoELayer)]
    assert layers
    for m in layers:
        m.record_routing = True
    on_card = TrainGraphs("cuda", tm)

    def build():
        raise AssertionError("built")

    with pytest.raises(RuntimeError, match="record_routing"):
        on_card("k", build, params=tm.parameters(), state=state_tensors(ts))
    nb = np_batches(1, seed=11)[0]
    tstep(ts, torch_batch(nb), 0)
    n = nb["input_ids"].size
    for m in layers:
        experts = m.routing["experts"]
        assert experts.shape == (n, 2) and 0 <= int(experts.min()) <= int(experts.max()) < 4
    assert int(ts.step) == 1


def test_lm_eval_step_matches_jax_one_entry_a_batch_shape():
    (jm, js, _, jt), (tm, ts, _, tt) = both(dict(attention_impl="xla"),
                                            dict(grad_accum_steps=1))
    jeval, teval = j_make_eval_step(jm, jt), make_eval_step(tm, tt)
    batches = np_batches(2, seed=4) + np_batches(1, seed=5, b=3)
    for nb in batches + batches[:1]:
        jmet = jeval(js.params, jax.tree_util.tree_map(jnp.asarray, nb))
        tmet = teval(ts.params, torch_batch(nb))
        for k in ("loss", "lm_loss", "aux_loss"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5, atol=1e-7)
        assert int(tmet["tokens"]) == int(jmet["tokens"])
    assert len(teval.graphs.entries) == 2


def test_a_load_in_place_keeps_the_entries_and_new_tensors_rebuild(tmp_path):
    """load_checkpoint(target=state) restores in place: the same entry
    serves the next call and steps from the loaded values (the step after
    the load equals the step after the save); a state of other tensors
    drops the entries."""
    (_, _, _, _), (tm, ts, tstep, tt) = both(dict(attention_impl="xla"),
                                             dict(grad_accum_steps=1))
    batches = [torch_batch(nb) for nb in np_batches(3, seed=6)]
    tstep(ts, batches[0], 0)
    path = save_checkpoint(str(tmp_path), ts)
    entry = tstep.graphs.entries[next(iter(tstep.graphs.entries))]
    _, m1 = tstep(ts, batches[1], 1)
    after = {n: p.detach().clone() for n, p in tm.named_parameters()}
    load_checkpoint(path, target=ts)
    assert tstep.graphs.entries[next(iter(tstep.graphs.entries))] is entry
    _, m1b = tstep(ts, batches[1], 1)
    assert float(m1b["loss"]) == float(m1["loss"]) and int(ts.step) == 2
    for n, p in tm.named_parameters():
        assert torch.equal(p, after[n]), n
    fresh = create_train_state(tm, create_optimizer(tt, 20))
    tstep(fresh, batches[2], 2)
    assert tstep.graphs.entries[next(iter(tstep.graphs.entries))] is not entry


def test_train_and_validate_loops_through_the_graph_sets():
    (_, _, _, _), (tm, ts, tstep, tt) = both(dict(attention_impl="xla"),
                                             dict(grad_accum_steps=1, logging_steps=2))
    ev = make_eval_step(tm, tt)
    seen = []
    ts, summary = train(tm, ts, iter([torch_batch(nb) for nb in np_batches(4, seed=7)]),
                        tt, rng=3, train_step_fn=tstep,
                        callbacks={"on_step": lambda s, m, i: seen.append(float(m["loss"]))})
    assert summary["steps"] == 4 and len(set(seen)) == 4 and all(map(np.isfinite, seen))
    v1 = validate(tm, ts, iter([torch_batch(nb) for nb in np_batches(2, seed=8)]), tt,
                  eval_step_fn=ev)
    v2 = validate(tm, ts, iter([torch_batch(nb) for nb in np_batches(2, seed=8)]), tt,
                  eval_step_fn=ev)
    assert v1 == v2 and v1["batches"] == 2 and len(ev.graphs.entries) == 1


# --- vision, image-gen and video steps -----------------------------------------


def test_vision_train_step_one_entry_an_accumulation_position():
    """ViT-2D, grad_accum_steps=2, augmentation off, four micro-steps against
    JAX's jitted step: two entries, params to the existing tolerance."""
    import test_torch_vision_train as V
    from vats_tpu.configs.vit2d import vit2d_xsmall as j_vit2d_xsmall
    from vats_tpu.models.vit2d import ImageEncoder as JImageEncoder
    from vats_tpu.train.state import TrainState as JTrainState
    from vats_tpu.train.vision import VisionTrainingArgs as JArgs
    from vats_tpu.train.vision import create_vision_optimizer as j_create_opt
    from vats_tpu.train.vision import make_vision_train_step as j_train_step
    from vats_tpu_torch.configs import vit2d_xsmall
    from vats_tpu_torch.models import ImageEncoder
    from vats_tpu_torch.train import make_vision_train_step
    from vats_tpu_torch.utils.convert import params_from_jax

    kw = dict(target_size=32, patch_size=8, num_classes=V.NUM_CLASSES, dtype="float32",
              attention_impl="xla")
    jm = JImageEncoder(j_vit2d_xsmall(**kw))
    jparams = meta.unbox(jm.init(jax.random.PRNGKey(0),
                                 jnp.zeros((2, 3, 32, 32), jnp.float32))["params"])
    args = dict(grad_accum_steps=2, epochs=4, warmup_epochs=1, learning_rate=1e-3,
                use_augmentation=False)
    jstate = JTrainState.create(apply_fn=jm.apply, params=jparams,
                                tx=j_create_opt(JArgs(**args), steps_per_epoch=1))
    jstep = j_train_step(jm, JArgs(**args), V.NUM_CLASSES)
    model = ImageEncoder(vit2d_xsmall(**kw), device="cpu")
    targs = VisionTrainingArgs(**args)
    state = create_train_state(model, create_vision_optimizer(targs, 1),
                               params=params_from_jax(jax.device_get(jparams), model.cfg))
    step = make_vision_train_step(model, targs, V.NUM_CLASSES)
    for i in range(4):
        b = V.batch(seed=30 + i)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                             jax.random.PRNGKey(i))
        state, met = step(state, b, i)
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=1e-5)
        V.compare_params(model, jstate)
    assert len(step.graphs.entries) == 2 and int(state.step) == 4


def test_vision_step_with_the_chooser_and_battery_is_deterministic_in_its_seed():
    """The augmentation on (host draws as static inputs, the battery's
    uniforms from the device seed): the same seed from one state gives the
    same step, bit for bit; the static draws hold the call's draws."""
    import test_torch_vision_train as V
    from vats_tpu_torch.configs import vit2d_xsmall
    from vats_tpu_torch.models import ImageEncoder
    from vats_tpu_torch.train import make_vision_train_step

    cfg = vit2d_xsmall(target_size=32, patch_size=8, num_classes=V.NUM_CLASSES,
                       dtype="float32", dropout=0.1)
    args = VisionTrainingArgs(grad_accum_steps=1, pixel_augs_on_device=True, epochs=2,
                              warmup_epochs=1)
    rs = np.random.RandomState(5)
    b = {"images": rs.rand(4, 3, 32, 32).astype(np.float32),
         "labels": rs.randint(0, V.NUM_CLASSES, 4).astype(np.int32)}
    runs = []
    for _ in range(2):
        model = ImageEncoder(cfg, device="cpu", seed=1)
        state = create_train_state(model, create_vision_optimizer(args, 1))
        step = make_vision_train_step(model, args, V.NUM_CLASSES)
        _, m = step(state, b, 77)
        runs.append((float(m["loss"]), float(m["lam"]),
                     {n: p.detach().clone() for n, p in model.named_parameters()}))
        bufs = step.graphs.entries[next(iter(step.graphs.entries))].buffers
        assert int(bufs["seed"]) == 77 and set(bufs) >= {"choice", "mix_lam", "cut_index"}
    assert runs[0][:2] == runs[1][:2]
    for n, p in runs[0][2].items():
        assert torch.equal(p, runs[1][2][n]), n


def test_image_gen_trainer_step_and_eval_one_entry_each():
    import test_torch_image_gen as IG

    jt, tt, jb, batch, cfg = IG.trainers(True)
    for _ in range(2):
        jm, tm = jt.train_step(jb), tt.train_step(batch)
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, err_msg=k)
    jev = jt.evaluate(iter([jb]), max_batches=1)
    ev = tt.evaluate(iter([batch]), max_batches=1)
    for k in ("loss", "vq_loss", "recon_loss"):
        np.testing.assert_allclose(ev[k], jev[k], atol=1e-5, rtol=1e-4, err_msg=k)
    assert len(tt.graphs.entries) == 1 and len(tt.eval_graphs.entries) == 1
    assert int(tt.state.step) == 2


def test_video_trainers_one_entry_each():
    import test_torch_video_gen as VG
    from vats_tpu.train.video_gen import VideoGenTrainingArgs as JArgs
    from vats_tpu.train.video_gen import VideoTokenTrainer as JTokenTrainer
    from vats_tpu.train.video_gen import VQVAE3DTrainer as JVQTrainer
    from vats_tpu_torch.train import VideoGenTrainingArgs, VideoTokenTrainer, VQVAE3DTrainer
    from vats_tpu_torch.utils.convert import params_from_jax

    jcfg, cfg = VG.cfgs()
    x = VG.videos(14)
    jt = JVQTrainer(jcfg, JArgs(learning_rate=VG.LR), jnp.asarray(x), num_training_steps=10)
    tt = VQVAE3DTrainer(cfg, VideoGenTrainingArgs(learning_rate=VG.LR), num_training_steps=10,
                        variables=params_from_jax(
                            {"params": meta.unbox(jax.device_get(jt.params)),
                             "batch_stats": jax.device_get(jt.batch_stats)}, cfg),
                        device="cpu")
    for _ in range(2):
        np.testing.assert_allclose(tt.train_step(t(x)), jt.train_step(jnp.asarray(x)),
                                   rtol=1e-5)
    assert len(tt.graphs.entries) == 1
    idx, text, tmask = VG.data(15)
    jb = {"indices": jnp.asarray(idx), "text_embeddings": jnp.asarray(text),
          "text_mask": jnp.asarray(tmask)}
    jt = JTokenTrainer(jcfg, JArgs(learning_rate=VG.LR), jb, num_training_steps=10)
    tt = VideoTokenTrainer(cfg, VideoGenTrainingArgs(learning_rate=VG.LR),
                           num_training_steps=10,
                           params=params_from_jax(meta.unbox(jax.device_get(jt.params)), cfg),
                           device="cpu")
    batch = {"indices": t(idx), "text_embeddings": t(text), "text_mask": t(tmask)}
    for _ in range(2):
        np.testing.assert_allclose(tt.train_step(batch), jt.train_step(jb), rtol=1e-5)
    assert len(tt.graphs.entries) == 1
    unmasked = copy.copy(batch)
    del unmasked["text_mask"]
    assert np.isfinite(tt.train_step(unmasked)) and len(tt.graphs.entries) == 2
