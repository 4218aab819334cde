"""GPipe pipeline parallelism of the port against ``vats_tpu``'s pipeline
and the sequential models, and the port's counterpart of the two-process
sharded train step of ``tests/test_multihost.py``.

One spawn of 4 gloo ranks (``tests/torch_parallel_ranks.py::pipeline_cases``,
joined through ``initialize_multihost``); the JAX references are computed in
this process (8 CPU devices) while the ranks run:

  * ``ppermute`` of fp32, bf16 and int8 tensors one rank forward: each rank
    receives what the rank behind sent, the int8 tensor carries no
    gradient, and the backward equals the seeded gradient shifted back
    (``shift`` by -1), bit for bit;
  * the tanh MLP of ``tests/test_pipeline.py`` at (S, M) = (4, 4), (2, 8)
    on data=2 x seq=2, (4, 2): the output against JAX's ``pipeline_apply``
    and the sequential loop with JAX's tolerances (rtol 2e-5, atol 2e-6);
    each rank's block of the weight gradients, and the whole input's
    gradient on every rank, against the sequential model's (once, not S
    times); the rejections of bad microbatching, mixed batch sizes and an
    empty state;
  * the TextLM of ``tests/test_pipeline_text_lm.py`` (its ``_cfg()``: d64,
    4 layers, E2 top-1, dense dispatch, fp32; scan layout on the JAX side,
    carried over by ``params_from_jax``; the last 3 positions masked) at
    (S, M) = (2, 4) on a ``stage_model`` and (4, 2) on the whole model:
    logits against JAX's ``pipeline_text_lm_apply`` within ``LOGIT_TOL`` of
    ``tests/test_torch_text_lm.py``, aux within rtol 1e-4, the CE loss
    within rtol 1e-5 of JAX's pipeline and of the sequential models'; the
    same at (2, 4) with sort dispatch at capacity 1.0 against JAX's
    pipeline alone (each microbatch routed with its own capacity, so not
    the sequential model's loss); at (2, 4) and (4, 2) every rank's layer
    gradients and the replicated leaves within ``GRAD_TOL`` of
    ``tests/test_torch_sharded.py`` of the port's sequential gradients, the
    replicated leaves' gradients equal on every rank, and a staged rank's
    resident bytes equal to its stage's;
  * five AdamW steps through the pipe (optax.adamw(3e-3)): the loss falls,
    the first equals JAX's pipeline loss, and the replicated leaves take
    equal updates on every rank;
  * a data=2 x fsdp=2 ``make_sharded_train`` step on the rows that
    ``host_shard_slice`` gives each process (``make_global_batch``'s block):
    one loss on every rank, equal to JAX's single-device step within
    ``LOSS_RTOL``, and exactly one coordinator.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import meta

from torch_parallel_ranks import Ranks, _ce
from vats_tpu.configs import ModelArgs as JModelArgs
from vats_tpu.configs import TrainingArgs as JTrainingArgs
from vats_tpu.configs import nlp_xsmall as j_nlp_xsmall
from vats_tpu.models import TextLM as JTextLM
from vats_tpu.parallel import create_mesh as j_create_mesh
from vats_tpu.parallel.pipeline import pipeline_apply as j_pipeline_apply
from vats_tpu.parallel.pipeline import pipeline_text_lm_apply as j_pipeline_text_lm_apply
from vats_tpu.train import create_optimizer as j_create_optimizer
from vats_tpu.train import create_train_state as j_create_train_state
from vats_tpu.train.loop import make_train_step_fn as j_make_train_step_fn
from vats_tpu_torch.configs import ModelArgs, nlp_xsmall
from vats_tpu_torch.models import TextLM
from vats_tpu_torch.parallel import create_mesh
from vats_tpu_torch.parallel.pipeline import pipeline_apply, pipeline_text_lm_apply
from vats_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

LOGIT_TOL = dict(atol=2e-4, rtol=2e-3)  # tests/test_torch_text_lm.py
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)  # tests/test_torch_sharded.py
LOSS_RTOL = 1e-4  # tests/test_torch_sharded.py: JAX's sharded vs single step
MLP_TOL = dict(rtol=2e-5, atol=2e-6)  # tests/test_pipeline.py
WORLD = 4
MLP_CASES = [(4, 4), (2, 8), (4, 2)]
SORT_CAPACITY = dict(moe_dispatch="sort", capacity_factor=1.0)
#: name: (S, M, stage_model first, config overrides)
LM_CASES = {"s2_m4": (2, 4, True, {}), "s4_m2": (4, 2, False, {}),
            "s2_m4_sort": (2, 4, True, SORT_CAPACITY)}
DENSE_CASES = ["s2_m4", "s4_m2"]

LM_KW = dict(
    d_model=64, num_heads=4, query_groups=2, d_ffn=128, num_layers=4,
    vocab_size=128, dropout=0.0, num_experts=2, top_k=1,
    max_seq_len=64, use_mqa=False, gradient_checkpointing=False,
    scan_layers=True, dtype="float32", param_dtype="float32",
    moe_dispatch="dense",
)  # tests/test_pipeline_text_lm.py::_cfg
MULTIHOST_KW = dict(
    d_model=64, num_heads=4, query_groups=2, d_ffn=128, num_layers=2,
    dropout=0.0, vocab_size=128, max_seq_len=64, left_window=-1,
    num_experts=2, top_k=1, moe_dispatch="dense", dtype="float32",
    gradient_checkpointing=False, use_mqa=False,
)  # tests/multihost_runner.py


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, meta.unbox(tree))


def _mlp_inputs():
    rng = np.random.RandomState(0)  # tests/test_pipeline.py's draws
    ws = (rng.randn(8, 16, 16) * 0.3).astype(np.float32)
    bs = (rng.randn(8, 16) * 0.1).astype(np.float32)
    x = rng.randn(16, 16).astype(np.float32)
    gout = np.random.RandomState(1).randn(16, 16).astype(np.float32)
    return dict(ws=ws, bs=bs, x=x, gout=gout, cases=MLP_CASES)


def _mlp_block(params, h):
    w_stack, b_stack = params

    def body(h, wb):
        w, b = wb
        return jnp.tanh(h @ w + b), None

    h, _ = jax.lax.scan(body, h, (w_stack, b_stack))
    return h


def _mlp_references(p):
    """JAX's pipeline output per case, the sequential output, and the
    sequential gradients of sum(out * gout) from the port's loop."""
    ws, bs, x = (jnp.asarray(p[k]) for k in ("ws", "bs", "x"))
    out = {}
    for stages, m in MLP_CASES:
        mesh = j_create_mesh(data=1, fsdp=1, expert=1, tensor=1, seq=stages,
                             devices=jax.devices()[:stages])
        out[(stages, m)] = np.asarray(j_pipeline_apply(
            _mlp_block, (ws, bs), x, mesh=mesh, axis_name="seq", num_microbatches=m))
    tw, tb, tx = (torch.tensor(p[k]).requires_grad_() for k in ("ws", "bs", "x"))
    h = tx
    for w, b in zip(tw, tb):
        h = torch.tanh(h @ w + b)
    (h * torch.tensor(p["gout"])).sum().backward()
    return dict(jax=out, seq=h.detach().numpy(), gw=tw.grad.numpy(), gb=tb.grad.numpy(),
                gx=tx.grad.numpy())


def _j_ce(logits, labels, mask):
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, labels[..., None], axis=-1)[..., 0]
    return jnp.sum(nll * mask) / jnp.sum(mask)


def _lm_inputs():
    """The JAX test's model, weights (scan layout) and batch; the port's
    config and converted weights."""
    jcfg = j_nlp_xsmall(**LM_KW)
    jm = JTextLM(jcfg)
    b, t = 8, 16
    ids = jax.random.randint(jax.random.PRNGKey(1), (b, t), 1, jcfg.vocab_size)
    labels = jax.random.randint(jax.random.PRNGKey(2), (b, t), 1, jcfg.vocab_size)
    mask = jnp.ones((b, t), dtype=bool).at[:, -3:].set(False)
    variables = jm.init(jax.random.PRNGKey(0), ids)
    cfg = nlp_xsmall(**LM_KW)
    params = {k: v.numpy().copy() for k, v in params_from_jax(_np_tree(variables), cfg).items()}
    return jm, variables, dict(cfg=dataclasses.asdict(cfg), params=params,
                               ids=np.asarray(ids), labels=np.asarray(labels),
                               mask=np.asarray(mask), train_ids=np.asarray(ids),
                               cases=LM_CASES)


def _lm_references(jm, variables, p):
    """JAX's pipeline logits and aux per case, JAX's and the port's
    sequential CE, the port's sequential gradients, JAX's first loss of the
    training case, and each stage's parameter bytes."""
    ids, labels, mask = (jnp.asarray(p[k]) for k in ("ids", "labels", "mask"))
    out = {"jax": {}, "jax_seq_loss": {}}
    for name, (stages, m, _, overrides) in LM_CASES.items():
        jmc = JTextLM(j_nlp_xsmall(**dict(LM_KW, **overrides)))
        mesh = j_create_mesh(data=1, fsdp=1, expert=1, tensor=1, seq=stages,
                             devices=jax.devices()[:stages])
        with mesh:
            logits, aux = jax.jit(lambda v: j_pipeline_text_lm_apply(
                jmc, v, ids, mask, mesh=mesh, axis_name="seq", num_microbatches=m))(variables)
        out["jax"][name] = dict(logits=np.asarray(logits), aux=float(aux),
                                loss=float(_j_ce(logits, labels, mask)))
        logits, _, _ = jmc.apply(variables, ids, padding_mask=mask, deterministic=True)
        out["jax_seq_loss"][name] = float(_j_ce(logits, labels, mask))

    train_ids = jnp.asarray(p["train_ids"])
    mesh = j_create_mesh(data=1, fsdp=1, expert=1, tensor=1, seq=2,
                         devices=jax.devices()[:2])
    with mesh:
        logits, _ = jax.jit(lambda v: j_pipeline_text_lm_apply(
            jm, v, train_ids, None, mesh=mesh, axis_name="seq", num_microbatches=4))(variables)
    logp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
    out["jax_train_loss0"] = float(-jnp.mean(
        jnp.take_along_axis(logp, train_ids[:, 1:, None], axis=-1)))

    model = TextLM(ModelArgs(**p["cfg"]), device="meta")
    model.load_state_dict({k: torch.tensor(v) for k, v in p["params"].items()}, assign=True)
    t_ids, t_labels, t_mask = (torch.tensor(p[k]) for k in ("ids", "labels", "mask"))
    logits, _, _ = model(t_ids, padding_mask=t_mask, deterministic=True)
    loss = _ce(logits, t_labels, t_mask)
    loss.backward()
    out["seq_loss"] = float(loss)
    out["grads"] = {n: q.grad.numpy() for n, q in model.named_parameters()}
    nbytes = {n: q.numel() * q.element_size() for n, q in model.named_parameters()}
    out["stage_bytes"] = {}
    for stages, _, _, _ in LM_CASES.values():
        per = 4 // stages
        for s in range(stages):
            keep = {f"layers.{i}." for i in range(s * per, (s + 1) * per)}
            out["stage_bytes"][(stages, s)] = sum(
                v for n, v in nbytes.items()
                if not n.startswith("layers.") or any(n.startswith(k) for k in keep))
    return out


def _multihost_inputs():
    """The multihost runner's config, batch and JAX-initialized weights, and
    JAX's single-device step loss on them."""
    jcfg = JModelArgs(**MULTIHOST_KW)
    rng = np.random.RandomState(0)
    ids = rng.randint(1, jcfg.vocab_size, size=(8, 32)).astype(np.int32)
    labels = np.concatenate([ids[:, 1:], np.full((8, 1), -100, np.int32)], axis=1)
    batch = {"input_ids": ids, "labels": labels, "padding_mask": np.ones((8, 32), bool)}
    jm = JTextLM(jcfg)
    targs = JTrainingArgs(grad_accum_steps=1)
    jstate = j_create_train_state(jm, j_create_optimizer(targs, 10), jax.random.PRNGKey(1),
                                  jnp.asarray(ids))
    params = {k: v.numpy().copy() for k, v in
              params_from_jax(_np_tree(jstate.params), ModelArgs(**MULTIHOST_KW)).items()}
    return jm, jstate, targs, dict(cfg=MULTIHOST_KW, params=params, batch=batch)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    mlp = _mlp_inputs()
    jm, variables, lm = _lm_inputs()
    mjm, mjstate, mtargs, multihost = _multihost_inputs()
    (tmp / "ranks").mkdir()
    running = Ranks("pipeline_cases", WORLD, tmp / "ranks", dict(
        address=f"file://{tmp}/store", mlp=mlp, lm=lm, multihost=multihost), own_init=True)
    refs = dict(mlp=_mlp_references(mlp), lm=_lm_references(jm, variables, lm))
    _, m = jax.jit(j_make_train_step_fn(mjm, mtargs))(
        mjstate, {k: jnp.asarray(v) for k, v in multihost["batch"].items()},
        jax.random.PRNGKey(2))
    refs["multihost_loss"] = float(m["loss"])
    return dict(refs=refs, ranks=running.results(timeout=240))


def test_ppermute_shifts_forward_and_its_gradient_back(runs):
    ranks = [r["shift"] for r in runs["ranks"]]
    for r, got in enumerate(ranks):
        for out, x in zip(got["outputs"], ranks[(r - 1) % WORLD]["inputs"]):
            np.testing.assert_array_equal(out, x)
        assert got["int_grad"] is False
        # the gradient of what this rank sent: what the rank ahead drew, sent back
        for g, back in zip(got["grads"], got["back"]):
            np.testing.assert_array_equal(g, back)
        # forward: fp32, bf16, int8 packed at 256-byte offsets; backward: the two floats
        assert got["forward_bytes"] == 3 * 256
        assert got["by_axis"] == {"seq": 5 * 256}


@pytest.mark.parametrize("case", MLP_CASES)
def test_mlp_pipeline_matches_jax_and_sequential(runs, case):
    ref = runs["refs"]["mlp"]
    np.testing.assert_allclose(ref["jax"][case], ref["seq"], **MLP_TOL)
    for r in runs["ranks"]:
        got = r["mlp"][case]
        np.testing.assert_allclose(got["out"], ref["jax"][case], **MLP_TOL)
        np.testing.assert_allclose(got["out"], ref["seq"], **MLP_TOL)
        lo, hi = got["layers"]
        np.testing.assert_allclose(got["gw"][lo:hi], ref["gw"][lo:hi], **MLP_TOL)
        np.testing.assert_allclose(got["gb"][lo:hi], ref["gb"][lo:hi], **MLP_TOL)
        assert not got["gw"][:lo].any() and not got["gw"][hi:].any()
        # the input's gradient: stage 0's alone, all-reduced, on every rank
        np.testing.assert_allclose(got["gx"], ref["gx"], **MLP_TOL)


def _mlp_block_torch(params, h):
    for w, b in zip(*params):
        h = torch.tanh(h @ w + b)
    return h


@pytest.mark.parametrize("bad", ["microbatching", "batch_sizes", "empty", "layers"])
def test_pipeline_rejects_bad_inputs(bad):
    """The JAX package's ValueErrors, raised before any collective (a
    seq=2 mesh of ranks, no world)."""
    mesh = create_mesh(data=1, fsdp=1, expert=1, tensor=1, seq=2, devices=range(2))
    ws, bs = torch.zeros(2, 4, 4), torch.zeros(2, 4)
    x = {"microbatching": torch.zeros(5, 4),
         "batch_sizes": {"a": torch.zeros(4, 4), "b": torch.zeros(2, 4)},
         "empty": {}, "layers": torch.zeros(4, 4)}[bad]
    if bad == "layers":
        ws, bs = torch.zeros(3, 4, 4), torch.zeros(3, 4)
    with pytest.raises(ValueError):
        pipeline_apply(_mlp_block_torch, (ws, bs), x, mesh=mesh, axis_name="seq",
                       num_microbatches=3 if bad == "microbatching" else 2)


def test_text_lm_pipeline_rejects_layers_that_do_not_split():
    mesh = create_mesh(data=1, fsdp=1, expert=1, tensor=1, seq=3, devices=range(3))
    model = TextLM(nlp_xsmall(**LM_KW), device="meta")
    with pytest.raises(ValueError, match="divide into 3 stages"):
        pipeline_text_lm_apply(model, torch.ones(6, 4, dtype=torch.int32), mesh=mesh,
                               axis_name="seq", num_microbatches=2)


@pytest.mark.parametrize("case", list(LM_CASES))
def test_text_lm_pipeline_matches_jax_pipeline(runs, case):
    """Logits and aux against JAX's pipeline, the same loss on every rank.
    The aux is 0 on both: the router's load-balancing loss is taken only
    when not deterministic, and the pipe runs deterministically."""
    jref = runs["refs"]["lm"]["jax"][case]
    for r in runs["ranks"]:
        got = r["lm"][case]
        np.testing.assert_allclose(got["logits"], jref["logits"], **LOGIT_TOL)
        np.testing.assert_allclose(got["aux"], jref["aux"], rtol=1e-4)
        np.testing.assert_allclose(got["loss"], jref["loss"], rtol=1e-5)
    assert len({r["lm"][case]["loss"] for r in runs["ranks"]}) == 1


@pytest.mark.parametrize("case", DENSE_CASES)
def test_text_lm_pipeline_loss_matches_sequential(runs, case):
    ref = runs["refs"]["lm"]
    np.testing.assert_allclose(ref["seq_loss"], ref["jax_seq_loss"][case], rtol=1e-5)
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["lm"][case]["loss"], ref["seq_loss"], rtol=1e-5)


def test_text_lm_pipeline_capacity_is_per_microbatch(runs):
    """With sort dispatch at capacity 1.0 a stage routes each microbatch
    with that microbatch's capacity, as JAX's pipeline does: the pipelined
    loss is not the sequential model's (held to JAX's pipeline above)."""
    ref = runs["refs"]["lm"]
    piped = runs["ranks"][0]["lm"]["s2_m4_sort"]["loss"]
    assert abs(piped - ref["jax_seq_loss"]["s2_m4_sort"]) > 1e-3 * abs(piped)


@pytest.mark.parametrize("case", DENSE_CASES)
def test_text_lm_pipeline_gradients_match_sequential_once(runs, case):
    """Each rank's own blocks and the replicated leaves (embedding, final
    norm) hold the sequential gradient: not S times it, not a share."""
    ref = runs["refs"]["lm"]["grads"]
    stages = LM_CASES[case][0]
    per = 4 // stages
    replicated = [n for n in ref if not n.startswith("layers.")]
    for rank, r in enumerate(runs["ranks"]):
        got = r["lm"][case]["grads"]
        s = rank % stages  # create_mesh(data, ..., seq): seq is the fastest axis
        own = {n for n in ref
               if any(n.startswith(f"layers.{i}.") for i in range(s * per, (s + 1) * per))}
        assert set(got) == own | set(replicated)
        for name, g in got.items():
            np.testing.assert_allclose(g, ref[name], err_msg=name, **GRAD_TOL)
    for name in replicated:
        for r in runs["ranks"][1:]:
            np.testing.assert_array_equal(r["lm"][case]["grads"][name],
                                          runs["ranks"][0]["lm"][case]["grads"][name])


def test_staged_rank_holds_only_its_stage(runs):
    stages = LM_CASES["s2_m4"][0]
    want = runs["refs"]["lm"]["stage_bytes"]
    whole = sum(want[(stages, s)] for s in range(stages))
    for rank, r in enumerate(runs["ranks"]):
        got = r["lm"]["s2_m4"]["resident"]
        assert got == want[(stages, rank % stages)]
        assert got < whole


def test_adamw_through_the_pipe_lowers_the_loss(runs):
    ref = runs["refs"]["lm"]
    ranks = [r["train"] for r in runs["ranks"]]
    for got in ranks:
        assert got["losses"][-1] < got["losses"][0], got["losses"]
        np.testing.assert_allclose(got["losses"][0], ref["jax_train_loss0"], rtol=1e-5)
        assert got["losses"] == ranks[0]["losses"]
        for name, g in got["first_grads"].items():
            np.testing.assert_array_equal(g, ranks[0]["first_grads"][name])
        for name, v in got["replicated_after"].items():
            np.testing.assert_array_equal(v, ranks[0]["replicated_after"][name])


def test_two_host_sharded_train_step(runs):
    """tests/test_multihost.py::test_two_process_sharded_train_step's
    counterpart: every rank's loss the same and JAX's single-device one,
    exactly one coordinator, each process's host rows its step's rows."""
    got = [r["multihost"] for r in runs["ranks"]]
    assert len({g["loss"] for g in got}) == 1
    np.testing.assert_allclose(got[0]["loss"], runs["refs"]["multihost_loss"], rtol=LOSS_RTOL)
    assert sorted(g["coordinator"] for g in got) == [False, False, False, True]
    assert [g["slice"] for g in got] == [(0, 2), (2, 4), (4, 6), (6, 8)]
    assert all(g["rows_match"] for g in got)
