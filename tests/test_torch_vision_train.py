"""The port's vision training against ``vats_tpu.train.vision``.

  * the epoch schedule at a list of steps: rtol 1e-6;
  * ``create_vision_optimizer`` (plain clip -> AdamW -> MultiSteps) over
    three updates with ``grad_accum_steps=2`` against optax, the clip
    engaged: params rtol 1e-5, atol 1e-7 (Adam normalises each update to
    ~lr, fp32 noise moves a param by ~1e-9); a NaN gradient reaches the
    params, as optax's clip has no skip;
  * ``smoothed_ce``: rtol 1e-6;
  * one train step of ViT-2D xsmall with its classifier (fp32, dropout 0)
    from the same weights and batch, with the augmentation off, and with
    mixup given JAX's own draws (the test replays ``jax.random`` on the
    step's keys and hands the port's step the same lam and permutation):
    loss rtol 1e-5, params after the step atol 5e-6, rtol 1e-5; the eval
    step: loss rtol 1e-5;
  * two train steps of ViT-3D ``vit3d_tiny_test`` with its classifier
    (fp32, dropout 0, no augmentation) from the same weights and clips:
    loss rtol 1e-5, params after each step atol 5e-6, rtol 1e-5; the eval
    step: loss rtol 1e-5;
  * the eval step of both models over batches whose last is smaller (one
    entry, on the card one graph, a batch shape): loss rtol 1e-5, acc exact;
  * the port alone: a step with the on-card pixel battery, and
    ``train_epoch`` / ``validate_epoch`` over ``array_batches``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.linen import meta

from vats_tpu.configs.vit2d import vit2d_xsmall as j_vit2d_xsmall
from vats_tpu.configs.vit3d import vit3d_tiny_test as j_vit3d_tiny
from vats_tpu.data.augmentations import mixup_data as j_mixup
from vats_tpu.models.vit2d import ImageEncoder as JImageEncoder
from vats_tpu.models.vit3d import VideoTransformer as JVideoTransformer
from vats_tpu.train.state import TrainState as JTrainState
from vats_tpu.train.vision import VisionTrainingArgs as JArgs
from vats_tpu.train.vision import create_vision_optimizer as j_create_opt
from vats_tpu.train.vision import make_vision_eval_step as j_eval_step
from vats_tpu.train.vision import make_vision_train_step as j_train_step
from vats_tpu.train.vision import smoothed_ce as j_ce
from vats_tpu.train.vision import warmup_cosine_epoch_schedule as j_schedule
from vats_tpu_torch.configs import vit2d_xsmall, vit3d_tiny_test
from vats_tpu_torch.data import array_batches
from vats_tpu_torch.data.augmentations import mixup_blend
from vats_tpu_torch.models import ImageEncoder, VideoTransformer
from vats_tpu_torch.train import create_train_state
from vats_tpu_torch.train import vision as tv
from vats_tpu_torch.train.vision import (
    VisionTrainingArgs,
    create_vision_optimizer,
    make_vision_eval_step,
    make_vision_train_step,
    smoothed_ce,
    train_epoch,
    validate_epoch,
    warmup_cosine_epoch_schedule,
)
from vats_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

PARAM_TOL = dict(atol=5e-6, rtol=1e-5)
NUM_CLASSES = 6


def t(x):
    return torch.from_numpy(np.array(x))


def test_vision_training_args_fields_match():
    import dataclasses

    fields = lambda c: [(f.name, f.default) for f in dataclasses.fields(c)]  # noqa: E731
    assert fields(VisionTrainingArgs) == fields(JArgs)


def test_epoch_schedule_matches_jax():
    args = (3e-4, 5, 12, 6e-7, 3)
    steps = [0, 1, 2, 3, 14, 15, 16, 20, 34, 35, 100]
    got = [float(warmup_cosine_epoch_schedule(*args)(s)) for s in steps]
    want = [float(j_schedule(*args)(s)) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == pytest.approx(3e-4 / 5) and got[3] == pytest.approx(2 * 3e-4 / 5)
    dev_step = torch.tensor(16, dtype=torch.int32)  # a device counter works too
    assert float(warmup_cosine_epoch_schedule(*args)(dev_step)) == pytest.approx(got[6])


def test_vision_optimizer_matches_optax_with_accumulation():
    rs = np.random.RandomState(0)
    shapes = {"a": (4, 3), "b": (5,)}
    params = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    args = dict(learning_rate=1e-2, warmup_epochs=1, epochs=4, grad_accum_steps=2,
                max_norm=1.0)
    jtx = j_create_opt(JArgs(**args), steps_per_epoch=1)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jst = jtx.init(jp)
    tx = create_vision_optimizer(VisionTrainingArgs(**args), steps_per_epoch=1)
    tp = {k: t(v) for k, v in params.items()}
    st = tx.init(tp)
    for i in range(6):  # three applied updates; norms from ~0.3 to ~6
        g = {k: (rs.randn(*s) * (0.1 + i)).astype(np.float32) for k, s in shapes.items()}
        upd, jst = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, jst, jp)
        jp = optax.apply_updates(jp, upd)
        with torch.no_grad():
            st = tx.update_(tp, {k: t(v) for k, v in g.items()}, st)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), err_msg=f"{i} {k}",
                                       **dict(atol=1e-7, rtol=1e-5))
    assert int(st.inner_opt_state.inner_state.count) == 3
    # the plain clip: a NaN gradient reaches the params at the boundary
    nan = {k: np.full(s, np.nan, np.float32) for k, s in shapes.items()}
    for _ in range(2):
        upd, jst = jtx.update({k: jnp.asarray(v) for k, v in nan.items()}, jst, jp)
        jp = optax.apply_updates(jp, upd)
        with torch.no_grad():
            st = tx.update_(tp, {k: t(v) for k, v in nan.items()}, st)
    assert np.isnan(np.asarray(jp["a"])).all() and bool(torch.isnan(tp["a"]).all())


def test_smoothed_ce_matches_jax():
    rs = np.random.RandomState(1)
    logits = rs.randn(5, NUM_CLASSES).astype(np.float32) * 3
    targets = rs.randint(0, NUM_CLASSES, 5)
    for ls in (0.0, 0.1):
        got = float(smoothed_ce(t(logits), t(targets), ls, NUM_CLASSES))
        want = float(j_ce(jnp.asarray(logits), jnp.asarray(targets), ls, NUM_CLASSES))
        assert got == pytest.approx(want, rel=1e-6)


def both(args_kw):
    """JAX (model, state, step) and port (model, state, step) from the same
    weights: ViT-2D xsmall at 32 px, a 6-class head, fp32, dropout 0."""
    kw = dict(target_size=32, patch_size=8, num_classes=NUM_CLASSES, dtype="float32",
              attention_impl="xla")
    x0 = np.zeros((2, 3, 32, 32), np.float32)
    jm = JImageEncoder(j_vit2d_xsmall(**kw))
    jparams = meta.unbox(jm.init(jax.random.PRNGKey(0), jnp.asarray(x0))["params"])
    args = dict(grad_accum_steps=1, epochs=4, warmup_epochs=1, learning_rate=1e-3,
                **args_kw)
    jtx = j_create_opt(JArgs(**args), steps_per_epoch=1)
    jstate = JTrainState.create(apply_fn=jm.apply, params=jparams, tx=jtx)
    cfg = vit2d_xsmall(**kw)
    model = ImageEncoder(cfg, device="cpu")
    targs = VisionTrainingArgs(**args)
    state = create_train_state(model, create_vision_optimizer(targs, 1),
                               params=params_from_jax(jax.device_get(jparams), cfg))
    return ((jm, jstate, j_train_step(jm, JArgs(**args), NUM_CLASSES)),
            (model, state, make_vision_train_step(model, targs, NUM_CLASSES)))


def batch(seed=2):
    rs = np.random.RandomState(seed)
    return {"images": rs.randn(4, 3, 40, 36).astype(np.float32),
            "labels": np.array([0, 3, 5, 1], np.int32)}


def compare_params(model, jstate):
    want = params_from_jax(jax.device_get(jstate.params), model.cfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), err_msg=name,
                                   **PARAM_TOL)


def test_train_and_eval_steps_without_augmentation_match_jax():
    (jm, jstate, jstep), (model, state, step) = both(dict(use_augmentation=False))
    b = batch()
    for i in range(2):  # step 0 at lr 1e-3 / 1 (warmup epoch 0), step 1 on the cosine
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                             jax.random.PRNGKey(i))
        state, met = step(state, b, i)
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=1e-5)
        assert float(met["lam"]) == 1.0 and float(met["acc"]) == pytest.approx(float(jmet["acc"]))
        compare_params(model, jstate)
    assert int(state.step) == 2
    jev = j_eval_step(jm, NUM_CLASSES)(jstate.params, {k: jnp.asarray(v) for k, v in b.items()})
    ev = make_vision_eval_step(model, NUM_CLASSES)(state.params, b)
    np.testing.assert_allclose(float(ev["loss"]), float(jev["loss"]), rtol=1e-5)
    assert float(ev["acc"]) == pytest.approx(float(jev["acc"]))


def test_train_step_with_mixup_matches_jax_given_its_draws(monkeypatch):
    (jm, jstate, jstep), (model, state, step) = both(dict(use_augmentation=True))
    b = batch(3)
    # a step key whose chooser picks mixup (choice 0), and that mixup's draws
    for seed in range(100):
        key = jax.random.PRNGKey(seed)
        aug_rng, _ = jax.random.split(key)
        rng_choice, rng_aug = jax.random.split(aug_rng)
        if int(jax.random.randint(rng_choice, (), 0, 3)) == 0:
            break
    rng_lam, rng_perm = jax.random.split(rng_aug)
    lam = float(jax.random.beta(rng_lam, 0.8, 0.8))
    index = np.asarray(jax.random.permutation(rng_perm, 4))
    _, _, jtb, jlam = j_mixup(rng_aug, jnp.asarray(b["images"]), jnp.asarray(b["labels"]), 0.8)
    np.testing.assert_array_equal(np.asarray(jtb), b["labels"][index])
    assert float(jlam) == lam
    monkeypatch.setattr(tv, "augment_given",
                        lambda x, y, draws: mixup_blend(x, y, lam, t(index)))
    jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()}, key)
    state, met = step(state, b, 0)
    assert float(met["lam"]) == pytest.approx(float(jmet["lam"]))
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=1e-5)
    compare_params(model, jstate)


def test_vit3d_train_and_eval_steps_match_jax():
    """ViT-3D tiny with its 10-class head, fp32, dropout 0, no augmentation:
    two steps (warmup, then the cosine) and the eval step."""
    kw = dict(dtype="float32", use_classifier_head=True)
    jcfg, cfg = j_vit3d_tiny(**kw), vit3d_tiny_test(**kw)
    rs = np.random.RandomState(7)
    b = {"images": rs.rand(2, 3, 8, 32, 32).astype(np.float32),
         "labels": np.array([3, 8], np.int32)}
    jm = JVideoTransformer(jcfg)
    jparams = meta.unbox(jm.init(jax.random.PRNGKey(0), jnp.asarray(b["images"]))["params"])
    args = dict(grad_accum_steps=1, epochs=4, warmup_epochs=1, learning_rate=1e-3,
                use_augmentation=False)
    jstate = JTrainState.create(apply_fn=jm.apply, params=jparams,
                                tx=j_create_opt(JArgs(**args), steps_per_epoch=1))
    jstep = j_train_step(jm, JArgs(**args), cfg.num_classes)
    model = VideoTransformer(cfg, device="cpu")
    targs = VisionTrainingArgs(**args)
    state = create_train_state(model, create_vision_optimizer(targs, 1),
                               params=params_from_jax(jax.device_get(jparams), cfg))
    step = make_vision_train_step(model, targs, cfg.num_classes)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    for i in range(2):
        jstate, jmet = jstep(jstate, jb, jax.random.PRNGKey(i))
        state, met = step(state, b, i)
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=1e-5)
        compare_params(model, jstate)
    jev = j_eval_step(jm, cfg.num_classes)(jstate.params, jb)
    ev = make_vision_eval_step(model, cfg.num_classes)(state.params, b)
    np.testing.assert_allclose(float(ev["loss"]), float(jev["loss"]), rtol=1e-5)
    assert float(ev["acc"]) == pytest.approx(float(jev["acc"]))


def vit3d_pair(kw):
    """JAX (model, params) and the port's model, ViT-3D tiny from the same
    weights."""
    jcfg, cfg = j_vit3d_tiny(**kw), vit3d_tiny_test(**kw)
    jm = JVideoTransformer(jcfg)
    x0 = jnp.zeros((1, 3, cfg.max_frames, *cfg.target_size), jnp.float32)
    jparams = meta.unbox(jm.init(jax.random.PRNGKey(0), x0)["params"])
    model = VideoTransformer(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(jparams), cfg))
    return jm, jparams, model


@pytest.mark.parametrize("kind", ["vit2d", "vit3d"])
def test_eval_step_on_a_ragged_last_batch_matches_jax(kind):
    """A validation set whose last batch is smaller: one entry a batch shape
    (a graph each on the card), reused when the shape comes again.  Loss
    rtol 1e-5 (fp32), acc exact."""
    rs = np.random.RandomState(9)
    if kind == "vit2d":
        (jm, jstate, _), (model, state, _) = both(dict(use_augmentation=False))
        jparams, params, n_classes = jstate.params, state.params, NUM_CLASSES
        images = rs.randn(7, 3, 40, 36).astype(np.float32)
        sizes = (4, 3)
    else:
        jm, jparams, model = vit3d_pair(dict(dtype="float32", use_classifier_head=True))
        params, n_classes = dict(model.named_parameters()), model.cfg.num_classes
        images = rs.rand(3, 3, 8, 32, 32).astype(np.float32)
        sizes = (2, 1)
    labels = rs.randint(0, n_classes, len(images)).astype(np.int32)
    cuts = np.cumsum((0,) + sizes)
    batches = [{"images": images[a:b], "labels": labels[a:b]} for a, b in zip(cuts, cuts[1:])]
    jstep, step = j_eval_step(jm, n_classes), make_vision_eval_step(model, n_classes)
    for b in batches + batches[:1]:
        jev = jstep(jparams, {k: jnp.asarray(v) for k, v in b.items()})
        ev = step(params, b)
        np.testing.assert_allclose(float(ev["loss"]), float(jev["loss"]), rtol=1e-5)
        assert float(ev["acc"]) == float(jev["acc"])
    assert len(step.graphs.entries) == 2


def test_train_step_with_pixel_battery_and_epoch_loops():
    """The port alone: the on-card battery on raw [0, 1] images with mixup /
    cutmix and dropout, accumulation over 2; then the epoch loops."""
    cfg = vit2d_xsmall(target_size=32, patch_size=8, num_classes=NUM_CLASSES,
                       dtype="float32", dropout=0.1)
    model = ImageEncoder(cfg, device="cpu", seed=1)
    args = VisionTrainingArgs(grad_accum_steps=2, pixel_augs_on_device=True, epochs=2,
                              warmup_epochs=1)
    state = create_train_state(model, create_vision_optimizer(args, 1))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    rs = np.random.RandomState(4)
    raw = rs.rand(8, 3, 32, 32).astype(np.float32)
    labels = rs.randint(0, NUM_CLASSES, 8).astype(np.int32)
    step = make_vision_train_step(model, args, NUM_CLASSES)
    losses = []
    for i in range(2):
        state, m = step(state, {"images": raw[4 * i:4 * i + 4], "labels": labels[4 * i:4 * i + 4]},
                        10 + i)
        losses.append(float(m["loss"]))
        assert 0.0 <= float(m["lam"]) <= 1.0 and np.isfinite(float(m["grad_norm"]))
    assert all(np.isfinite(losses))
    moved = [n for n, p in model.named_parameters() if not torch.equal(p, before[n])]
    assert len(moved) == len(before)  # the boundary update moved every leaf
    state, em = train_epoch(model, state, array_batches(raw, labels, 4, normalize=False),
                            args, rng=5, num_classes=NUM_CLASSES)
    assert em["batches"] == 2 and np.isfinite(em["epoch_loss"])
    vm = validate_epoch(model, state, array_batches(raw, labels, 4, shuffle=False),
                        num_classes=NUM_CLASSES)
    assert vm["batches"] == 2 and np.isfinite(vm["val_loss"]) and 0 <= vm["val_acc"] <= 100
