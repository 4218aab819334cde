"""The port's training step against ``vats_tpu.train``.

Same weights (``params_from_jax``) and the same numpy batches through
``vats_tpu.train.make_train_step`` and the port's ``make_train_step``, fp32
on both sides, dropout 0 (the two packages draw other dropout bits):

  * loss per step: rtol 1e-5 (fp32 sums in another order);
  * gradients of the first step, leaf by leaf: atol 1e-6, rtol 1e-4;
  * params after each step: rtol 1e-5 and atol 5e-6 with an fp32 first
    moment, 3e-5 with a bf16 one.  Adam normalises each update to ~lr
    (6e-4) per element, so fp32 gradient noise moves a param by ~1e-8.  A
    bf16 moment may round to the neighbouring bf16 value on one side only;
    that ulp (2^-8 relative) stays in the moment and moves every later
    update of that element by up to 2^-8 of |u| <~ 3 lr, ~7e-6 per applied
    step.

Plus the port alone: the schedule, the losses, AdamW against optax,
gradient accumulation against the large batch, and rematerialisation with
dropout on against no rematerialisation."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.linen import meta

from vats_tpu.configs import TrainingArgs as JTrainingArgs
from vats_tpu.configs import nlp_xsmall as j_nlp_xsmall
from vats_tpu.data import synthetic_lm_batches as j_batches
from vats_tpu.models import TextLM as JTextLM
from vats_tpu.train import (
    compute_loss as j_compute_loss,
    cosine_with_warmup_schedule as j_schedule,
    create_optimizer as j_create_optimizer,
    create_train_state as j_create_train_state,
    make_train_step as j_make_train_step,
)
from vats_tpu.train.metrics import fused_linear_cross_entropy as j_fused_ce
from vats_tpu_torch.configs import TrainingArgs, nlp_xsmall
from vats_tpu_torch.data import synthetic_lm_batches
from vats_tpu_torch.models import TextLM
from vats_tpu_torch.train import (
    compute_loss,
    cosine_with_warmup_schedule,
    create_optimizer,
    create_train_state,
    make_train_step,
    train,
    validate,
)
from vats_tpu_torch.train.metrics import IGNORE_INDEX, fused_linear_cross_entropy
from vats_tpu_torch.train.optimizer import AdamW
from vats_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

LOSS_TOL = dict(rtol=1e-5, atol=0.0)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
PARAM_TOL = {None: dict(atol=5e-6, rtol=1e-5), "bfloat16": dict(atol=3e-5, rtol=1e-5)}
B, T = 2, 32


def xsmall_kw(**kw):
    """nlp_xsmall at 2 layers, fp32, dropout 0 (the JAX config differs only
    in its attention_impl name)."""
    base = dict(num_layers=2, dropout=0.0, dtype="float32", gradient_checkpointing=False)
    base.update(kw)
    return base


def both(model_kw, targs_kw, num_training_steps=20):
    """(JAX model, JAX state, JAX step), (port model, port state, port step)
    from the same weights.  20 steps of 5% warmup: step 0 runs at lr 0."""
    jkw = dict(model_kw)
    if jkw.get("attention_impl") == "flash":
        jkw["attention_impl"] = "flash_interpret"
    jcfg = j_nlp_xsmall(**xsmall_kw(**jkw))
    cfg = nlp_xsmall(**xsmall_kw(**model_kw))
    jt, tt = JTrainingArgs(**targs_kw), TrainingArgs(**targs_kw)
    jm = JTextLM(jcfg)
    jstate = j_create_train_state(jm, j_create_optimizer(jt, num_training_steps),
                                  jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tm = TextLM(cfg, device="meta")
    tm.load_state_dict(params_from_jax(_np(jstate.params), cfg), assign=True)
    tstate = create_train_state(tm, create_optimizer(tt, num_training_steps))
    return (jm, jstate, j_make_train_step(jm, jt), jt), (tm, tstate, make_train_step(tm, tt), tt)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, meta.unbox(tree))


def np_batches(n, seed=1, b=B, t=T, pad_fraction=0.3):
    return [jax.tree_util.tree_map(np.asarray, x) for x in
            j_batches(jax.random.PRNGKey(seed), vocab_size=512, batch_size=b, seq_len=t,
                      num_batches=n, pad_fraction=pad_fraction)]


def jax_grads(jm, params, batch, targs):
    """Gradients of the JAX train step's loss (its loss_fn, dropout 0)."""
    cfg = jm.cfg

    def loss_fn(p):
        kw = dict(padding_mask=batch["padding_mask"], deterministic=False,
                  rngs={"dropout": jax.random.PRNGKey(0)})
        if targs.fused_ce_chunk:
            hidden, _, aux = jm.apply({"params": p}, batch["input_ids"],
                                      return_hidden=True, **kw)
            lm = j_fused_ce(hidden, p["token_embed"]["embedding"], batch["labels"],
                            chunk=targs.fused_ce_chunk, compute_dtype=jnp.float32)
            return lm + targs.aux_loss_weight * aux
        logits, _, aux = jm.apply({"params": p}, batch["input_ids"], **kw)
        return j_compute_loss(logits, batch["labels"], aux, targs.aux_loss_weight)[0]

    return _np(jax.grad(loss_fn)(meta.unbox(params)))


def assert_params_equal(jstate, tm, cfg, **tol):
    want = params_from_jax(_np(jstate.params), cfg)
    got = tm.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), err_msg=name, **tol)


STEP_CASES = {
    "xla_classic_ce_fp32_mu": (dict(attention_impl="xla"), dict()),
    "flash_fused_ce_bf16_mu": (dict(attention_impl="flash"),
                               dict(fused_ce_chunk=16, adam_mu_dtype="bfloat16")),
    "moe_top2_aux_loss": (dict(attention_impl="xla", num_experts=4, top_k=2,
                               capacity_factor=1.25), dict(adam_mu_dtype="bfloat16")),
}


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_three_train_steps_match_jax(name):
    model_kw, targs_kw = STEP_CASES[name]
    (jm, js, jstep, jt), (tm, ts, tstep, tt) = both(model_kw, dict(grad_accum_steps=1,
                                                                   **targs_kw))
    batches = np_batches(3)
    want_grads = jax_grads(jm, js.params, batches[0], jt)
    for i, nb in enumerate(batches):
        js, jmet = jstep(js, jax.tree_util.tree_map(jnp.asarray, nb), jax.random.PRNGKey(i))
        ts, tmet = tstep(ts, {k: torch.from_numpy(v.copy()) for k, v in nb.items()}, i)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), **LOSS_TOL)
        np.testing.assert_allclose(float(tmet["aux_loss"]), float(jmet["aux_loss"]),
                                   rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]),
                                   rtol=1e-5)
        if i == 0:
            grads = {n: p.grad for n, p in tm.named_parameters()}
            for n, g in params_from_jax(want_grads, tm.cfg).items():
                np.testing.assert_allclose(grads[n].numpy(), g.numpy(), err_msg=n,
                                           **GRAD_TOL)
        assert_params_equal(js, tm, tm.cfg, **PARAM_TOL[tt.adam_mu_dtype])
        assert int(ts.tokens_seen) == int(js.tokens_seen)
        assert int(ts.step) == int(js.step) == i + 1


def test_grad_accumulation_matches_jax():
    """grad_accum_steps=2 (MultiSteps with clip and skip inside) over four
    mini-steps: params move only at the boundaries, as in JAX."""
    (jm, js, jstep, _), (tm, ts, tstep, _) = both(
        dict(attention_impl="xla"), dict(grad_accum_steps=2, adam_mu_dtype="bfloat16"))
    for i, nb in enumerate(np_batches(4, seed=2)):
        js, jmet = jstep(js, jax.tree_util.tree_map(jnp.asarray, nb), jax.random.PRNGKey(i))
        ts, tmet = tstep(ts, {k: torch.from_numpy(v.copy()) for k, v in nb.items()}, i)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), **LOSS_TOL)
        # the stale boundary norm (0 before the first boundary), as in JAX
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]),
                                   rtol=1e-5)
        assert_params_equal(js, tm, tm.cfg, **PARAM_TOL["bfloat16"])
        assert int(ts.tokens_seen) == int(js.tokens_seen)
    assert int(ts.opt_state.gradient_step) == 2


def test_non_finite_step_is_skipped_like_jax():
    (jm, js, jstep, _), (tm, ts, tstep, _) = both(dict(attention_impl="xla"), dict(
        grad_accum_steps=1, adam_mu_dtype="bfloat16"))
    nb = np_batches(2, seed=9)
    # one good step, so the moments are not zero when the bad one comes
    js, _ = jstep(js, jax.tree_util.tree_map(jnp.asarray, nb[0]), jax.random.PRNGKey(0))
    ts, _ = tstep(ts, {k: torch.from_numpy(v.copy()) for k, v in nb[0].items()}, 0)
    poisoned = jax.tree_util.tree_map(lambda x: x.at[(0,) * x.ndim].set(jnp.nan), js.params)
    js = js.replace(params=poisoned)
    with torch.no_grad():
        for p in ts.params.values():
            p.view(-1)[0] = float("nan")
    before = {n: p.clone() for n, p in tm.state_dict().items()}
    mu_before = {n: m.clone() for n, m in ts.opt_state.mu.items()}
    js, jmet = jstep(js, jax.tree_util.tree_map(jnp.asarray, nb[1]), jax.random.PRNGKey(1))
    ts, tmet = tstep(ts, {k: torch.from_numpy(v.copy()) for k, v in nb[1].items()}, 1)
    assert not math.isfinite(float(tmet["grad_norm"]))
    assert int(ts.skipped_steps) == int(js.skipped_steps) == 1
    assert int(ts.step) == int(js.step) == 2
    assert int(ts.opt_state.count) == 1
    for n, p in tm.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), before[n].numpy(), err_msg=n)
    for n, m in ts.opt_state.mu.items():
        assert torch.equal(m, mu_before[n]), n
    assert_params_equal(js, tm, tm.cfg, **PARAM_TOL["bfloat16"])


def test_schedule_matches_jax_and_starts_at_lr_zero():
    js, ts = j_schedule(6e-4, 10, 110), cosine_with_warmup_schedule(6e-4, 10, 110)
    for step in (0, 1, 5, 9, 10, 11, 60, 109, 110, 200):
        np.testing.assert_allclose(float(ts(step)), float(js(step)), rtol=1e-6, atol=1e-12)
    assert float(ts(0)) == 0.0
    assert float(ts(torch.tensor(5, dtype=torch.int32))) == pytest.approx(3e-4, rel=1e-6)


def test_compute_loss_and_fused_ce_match_jax():
    rs = np.random.RandomState(0)
    b, t, d, v = 2, 40, 16, 50
    hidden = rs.randn(b, t, d).astype(np.float32)
    readout = (0.3 * rs.randn(v, d)).astype(np.float32)
    labels = rs.randint(0, v, (b, t)).astype(np.int32)
    labels[0, -7:] = IGNORE_INDEX
    labels[1, :3] = IGNORE_INDEX
    aux = np.float32(0.37)
    logits = hidden @ readout.T
    jtot, jlm, _ = j_compute_loss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(aux))
    ttot, tlm, _ = compute_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                torch.tensor(aux))
    np.testing.assert_allclose(float(tlm), float(jlm), rtol=1e-6)
    np.testing.assert_allclose(float(ttot), float(jtot), rtol=1e-6)
    zeros = compute_loss(torch.zeros(1, 4, 8), torch.tensor([[1, 2, -100, -100]]))[1]
    np.testing.assert_allclose(float(zeros), np.log(8), rtol=1e-6)

    # fused (chunk 16, a ragged last chunk) against the classic CE and JAX,
    # values and gradients
    th = torch.from_numpy(hidden).requires_grad_()
    tw = torch.from_numpy(readout).requires_grad_()
    fused = fused_linear_cross_entropy(th, tw, torch.from_numpy(labels), chunk=16,
                                       compute_dtype=torch.float32)
    g_fused = torch.autograd.grad(fused, (th, tw))
    classic = compute_loss(th @ tw.T, torch.from_numpy(labels))[1]
    g_classic = torch.autograd.grad(classic, (th, tw))
    np.testing.assert_allclose(fused.item(), classic.item(), rtol=1e-6)
    for a, b_ in zip(g_fused, g_classic):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), atol=1e-7, rtol=1e-5)
    jf = jax.value_and_grad(
        lambda h, w: j_fused_ce(h, w, jnp.asarray(labels), chunk=16,
                                compute_dtype=jnp.float32), argnums=(0, 1))
    jval, jg = jf(jnp.asarray(hidden), jnp.asarray(readout))
    np.testing.assert_allclose(fused.item(), float(jval), rtol=1e-6)
    for a, b_ in zip(g_fused, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), atol=1e-7, rtol=1e-5)


@pytest.mark.parametrize("w_std", [0.2, 0.8])
def test_fused_ce_bf16_product_gives_fp32_logits_like_jax(w_std):
    """compute_dtype=bf16: bf16 operands, fp32 logits, as the JAX version's
    ``preferred_element_type=float32``.  The loss equals JAX's to fp32
    rounding (rtol 1e-6: the same exact products, sums in fp32; measured
    1.4e-7 and 0).  Gradients: both round each to bf16 (the operands are bf16) and
    sum the readout's over chunks in fp32; the port also rounds dlogits to
    bf16 for its two backward products (bf16 GEMMs with fp32 output on the
    card) where JAX keeps them fp32, so the two differ by about one bf16 ulp
    of the largest element: held to 1e-2 * max|g| (measured 4.1e-3 to
    5.8e-3 of it)."""
    rs = np.random.RandomState(4)
    b, t, d, v = 2, 40, 64, 300
    hidden = rs.randn(b, t, d).astype(np.float32)
    readout = (w_std * rs.randn(v, d)).astype(np.float32)
    labels = rs.randint(0, v, (b, t)).astype(np.int32)
    labels[0, -7:] = IGNORE_INDEX
    th = torch.from_numpy(hidden).requires_grad_()
    tw = torch.from_numpy(readout).requires_grad_()
    loss = fused_linear_cross_entropy(th, tw, torch.from_numpy(labels), chunk=16,
                                      compute_dtype=torch.bfloat16)
    grads = torch.autograd.grad(loss, (th, tw))
    jf = jax.value_and_grad(
        lambda h, w: j_fused_ce(h, w, jnp.asarray(labels), chunk=16,
                                compute_dtype=jnp.bfloat16), argnums=(0, 1))
    jval, jgrads = jf(jnp.asarray(hidden), jnp.asarray(readout))
    np.testing.assert_allclose(loss.item(), float(jval), rtol=1e-6)
    for g, jg in zip(grads, jgrads):
        jg = np.asarray(jg)
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=1e-2 * np.abs(jg).max())


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
def test_adamw_matches_optax_over_three_steps(mu_dtype):
    rs = np.random.RandomState(3)
    shapes = {"a": (5, 7), "b": (11,)}
    params = {n: rs.randn(*s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: (0.1 * rs.randn(*s)).astype(np.float32) for n, s in shapes.items()}
             for _ in range(3)]
    grads[1]["b"][:3] = 0.0  # zero gradients: the update is weight decay alone
    sched = j_schedule(1e-2, 1, 10)
    jmu = jnp.bfloat16 if mu_dtype else None
    tx = optax.adamw(sched, b1=0.9, b2=0.95, eps=1e-6, weight_decay=5e-4, mu_dtype=jmu)
    jp = {n: jnp.asarray(p) for n, p in params.items()}
    jst = tx.init(jp)
    opt = AdamW(cosine_with_warmup_schedule(1e-2, 1, 10), b1=0.9, b2=0.95, eps=1e-6,
                weight_decay=5e-4, mu_dtype=torch.bfloat16 if mu_dtype else None)
    tp = {n: torch.from_numpy(p.copy()) for n, p in params.items()}
    tst = opt.init(tp)
    for g in grads:
        upd, jst = tx.update({n: jnp.asarray(x) for n, x in g.items()}, jst, jp)
        jp = optax.apply_updates(jp, upd)
        tst = opt.update_(tp, {n: torch.from_numpy(x) for n, x in g.items()}, tst)
        for n in shapes:
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]), rtol=1e-6,
                                       atol=1e-7)
            np.testing.assert_array_equal(tst.mu[n].float().numpy(),
                                          np.asarray(jst[0].mu[n]).astype(np.float32))
            np.testing.assert_allclose(tst.nu[n].numpy(), np.asarray(jst[0].nu[n]),
                                       rtol=1e-6)
    assert int(tst.count) == 3


def test_grad_accumulation_matches_large_batch():
    """MultiSteps(k=2) over two half-batches == one full-batch step (the
    port's counterpart of tests/test_training.py:128)."""
    cfg = nlp_xsmall(**xsmall_kw())
    states = []
    for accum in (1, 2):
        tm = TextLM(cfg, device="cpu", seed=0)
        ta = TrainingArgs(grad_accum_steps=accum, weight_decay=0.0)
        states.append((tm, create_train_state(tm, create_optimizer(ta, 100)),
                       make_train_step(tm, ta)))
    batch = next(synthetic_lm_batches(torch.Generator().manual_seed(4), vocab_size=512,
                                      batch_size=8, seq_len=16))
    (m_full, s_full, step_full), (m_acc, s_acc, step_acc) = states
    step_full(s_full, batch, 5)
    step_acc(s_acc, {k: v[:4] for k, v in batch.items()}, 5)
    step_acc(s_acc, {k: v[4:] for k, v in batch.items()}, 5)
    for a, b_ in zip(m_full.parameters(), m_acc.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b_.detach().numpy(), rtol=1e-3,
                                   atol=1e-5)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_remat_policies_with_dropout_give_the_same_grads(impl):
    """Dropout 0.1 with one seed: 'full' and 'dots' rematerialisation redraw
    the identical masks in the recompute, so loss and gradients equal those
    of no rematerialisation (to fp32 rounding of the recomputed ops)."""
    batch = next(synthetic_lm_batches(torch.Generator().manual_seed(2), vocab_size=512,
                                      batch_size=2, seq_len=24, pad_fraction=0.3))
    results = {}
    for policy in ("none", "full", "dots"):
        cfg = nlp_xsmall(**xsmall_kw(dropout=0.1, attention_impl=impl,
                                     gradient_checkpointing=policy != "none",
                                     remat_policy="full" if policy == "none" else policy))
        tm = TextLM(cfg, device="cpu", seed=0)
        ta = TrainingArgs(grad_accum_steps=1, fused_ce_chunk=8)
        state = create_train_state(tm, create_optimizer(ta, 100))
        _, met = make_train_step(tm, ta)(state, batch, 1234)
        results[policy] = (float(met["loss"]), {n: p.grad for n, p in tm.named_parameters()})
    loss0, grads0 = results["none"]
    for policy in ("full", "dots"):
        loss, grads = results[policy]
        assert loss == pytest.approx(loss0, rel=1e-6)
        for n, g in grads.items():
            np.testing.assert_allclose(g.numpy(), grads0[n].numpy(), atol=1e-7, rtol=1e-5,
                                       err_msg=f"{policy} {n}")
    # another seed draws other masks
    tm = TextLM(nlp_xsmall(**xsmall_kw(dropout=0.1, attention_impl=impl)), device="cpu",
                seed=0)
    ta = TrainingArgs(grad_accum_steps=1, fused_ce_chunk=8)
    _, met = make_train_step(tm, ta)(create_train_state(tm, create_optimizer(ta, 100)),
                                     batch, 99)
    assert float(met["loss"]) != loss0


def test_train_and_validate_loops_run():
    cfg = nlp_xsmall(**xsmall_kw())
    tm = TextLM(cfg, device="cpu", seed=0)
    ta = TrainingArgs(grad_accum_steps=1, max_train_tokens=10**9)
    state = create_train_state(tm, create_optimizer(ta, 100))
    data = list(synthetic_lm_batches(torch.Generator().manual_seed(1), vocab_size=512,
                                     batch_size=4, seq_len=16, num_batches=3))
    state, summary = train(tm, state, iter(data * 4), ta, rng=2, log_every=4)
    assert summary["steps"] == 12 and int(state.step) == 12
    assert summary["tokens_seen"] == sum(int((b["labels"] != -100).sum()) for b in data) * 4
    assert math.isfinite(summary["avg_loss"])
    metrics = validate(tm, state, iter(data), ta)
    assert metrics["batches"] == 3 and metrics["val_perplexity"] > 1


def test_synthetic_batches_shift_and_ignore_rules():
    gen = torch.Generator().manual_seed(0)
    for batch in synthetic_lm_batches(gen, vocab_size=50, batch_size=4, seq_len=20,
                                      num_batches=2, pad_fraction=0.4):
        ids, labels, mask = batch["input_ids"], batch["labels"], batch["padding_mask"]
        lens = mask.sum(1)
        assert ids.dtype == labels.dtype == torch.int32
        assert int(lens.min()) >= 12 and bool((ids[~mask] == 0).all())
        for r in range(4):
            n = int(lens[r])
            assert torch.equal(labels[r, :n - 1], ids[r, 1:n])
            assert bool((labels[r, n - 1:] == -100).all())
