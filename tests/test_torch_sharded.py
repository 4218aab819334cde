"""FSDP, tensor and expert sharding of the port's training step against
``vats_tpu``'s sharded step and the port's single-process step.

In this process: each parameter's spec from its logical axes equals what
the JAX package's ``tree_shardings`` gives the same leaf (TextLM fused and
split, ViT-2D xsmall; names and layouts through ``params_from_jax``) on
``choose_mesh_shape(2 | 4 | 8)``.

Two spawns of 4 gloo ranks (``tests/torch_parallel_ranks.py``), each case
from JAX-initialized weights and one seeded batch (d64, 4 heads, 2 groups,
2 layers, vocab 128, E4 top-2, B=8, T=32, fp32, dropout 0):

  * the TextLM step on fsdp=2 x expert=2 (scatter, lossless: the
    counterpart of ``test_sharded_loss_matches_single_device``), fsdp=2 x
    tensor=2 (sort, capacity 1.25, remat 'dots', fused CE), data=2 x
    expert=2 (capacity 1.25, sort and scatter), fsdp=2 x seq=2 (ring,
    capacity 1.25), tensor=2 x seq=2 (ring on each rank's heads) and
    data=2 x tensor=2 (dense, the counterpart of
    ``test_tp_lowers_to_tensor_collectives``: the step all-reduces over
    ``tensor`` and attention sees Hq/2 heads); Ulysses on tensor=2 x seq=2
    refuses a rank's 2 heads and 1 group, naming them.  The loss within rtol 1e-4
    of JAX's single-device step (JAX's own bound between its sharded and
    single steps); every rank's loss the same; the whole gradients and the
    params after the update, gathered from the shards, against the port's
    single-process step leaf by leaf within atol 1e-6, rtol 1e-4 (fp32 sums
    in another order); each rank's resident parameter and optimizer bytes
    equal to what the specs give; where the capacity binds, the reference
    drops assignments and the sharded step keeps exactly its assignments;
  * an E32 top-2 'sort' MoELayer with its experts over expert=4 against
    the dense dispatch (the port's and JAX's), forward and gradient with
    ``tests/test_moe_ep32.py``'s tolerances; its forward sends its tokens by
    all_to_all over ``expert`` and fewer bytes than one rank's experts;
  * the train script through ``--multihost`` (from the environment) and
    ``--mesh fsdp=2,tensor=2`` resuming that run's checkpoint; ViT-2D
    xsmall on fsdp=2 x tensor=2 with a caller's step (the counterpart of
    ``test_sharded_vision_training_step``): the loss against JAX's
    single-device step, the params against the port's single-process step;
    a sharded checkpoint (the counterpart of
    ``test_sharded_checkpoint_resume``) that one process loads bit-equal to
    the gathered params, and that loaded back into the sharded layout steps
    as the unbroken run does, bit for bit; a NaN gradient on one rank's
    shard alone makes every rank skip the step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import meta

from torch_parallel_ranks import Ranks
from vats_tpu.configs import ModelArgs as JModelArgs
from vats_tpu.configs import TrainingArgs as JTrainingArgs
from vats_tpu.configs.vit2d import vit2d_xsmall as j_vit2d_xsmall
from vats_tpu.data import synthetic_lm_batches as j_batches
from vats_tpu.models import TextLM as JTextLM
from vats_tpu.models.vit2d import ImageEncoder as JImageEncoder
from vats_tpu.nn.moe import MoELayer as JMoELayer
from vats_tpu.parallel import create_mesh as j_create_mesh
from vats_tpu.parallel.sharded import tree_shardings as j_tree_shardings
from vats_tpu.train import create_optimizer as j_create_optimizer
from vats_tpu.train import create_train_state as j_create_train_state
from vats_tpu.train.loop import make_train_step_fn as j_make_train_step_fn
from vats_tpu.train.vision import smoothed_ce as j_smoothed_ce
from vats_tpu_torch.checkpoint import load_checkpoint
from vats_tpu_torch.configs import ModelArgs, TrainingArgs
from vats_tpu_torch.configs.vit2d import vit2d_xsmall
from vats_tpu_torch.models import TextLM
from vats_tpu_torch.models.vit2d import ImageEncoder
from vats_tpu_torch.nn.moe import MoELayer
from vats_tpu_torch.parallel import create_mesh
from vats_tpu_torch.parallel.layout import ParamLayout
from vats_tpu_torch.parallel.sharded import choose_mesh_shape
from vats_tpu_torch.train import create_optimizer, create_train_state, make_train_step
from vats_tpu_torch.train.optimizer import clip_scale, global_norm
from vats_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

LOSS_RTOL = 1e-4
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
WORLD = 4

CFG = dict(
    d_model=64, num_heads=4, query_groups=2, d_ffn=128, num_layers=2,
    dropout=0.0, vocab_size=128, max_seq_len=64, left_window=-1,
    num_experts=4, top_k=2, moe_dispatch="scatter", capacity_factor=-1.0,
    dtype="float32", gradient_checkpointing=False, use_mqa=False,
)
SORT_CAP = dict(moe_dispatch="sort", capacity_factor=1.25)
CASES = {
    "fsdp_expert": dict(mesh=dict(data=1, fsdp=2, expert=2, tensor=1, seq=1)),
    "fsdp_tensor": dict(mesh=dict(data=1, fsdp=2, expert=1, tensor=2, seq=1),
                        cfg=dict(SORT_CAP, gradient_checkpointing=True, remat_policy="dots"),
                        targs=dict(fused_ce_chunk=16)),
    "data_expert_sort": dict(mesh=dict(data=2, fsdp=1, expert=2, tensor=1, seq=1),
                             cfg=SORT_CAP),
    "data_expert_scatter": dict(mesh=dict(data=2, fsdp=1, expert=2, tensor=1, seq=1),
                                cfg=dict(moe_dispatch="scatter", capacity_factor=1.25)),
    "fsdp_seq_ring": dict(mesh=dict(data=1, fsdp=2, expert=1, tensor=1, seq=2),
                          cfg=dict(SORT_CAP, context_parallel="ring")),
    "data_tensor": dict(mesh=dict(data=2, fsdp=1, expert=1, tensor=2, seq=1),
                        cfg=dict(moe_dispatch="dense")),
    "tensor_seq_ring": dict(mesh=dict(data=1, fsdp=1, expert=1, tensor=2, seq=2),
                            cfg=dict(SORT_CAP, context_parallel="ring")),
}
#: Ulysses on tensor=2 x seq=2: a rank's 2 heads and 1 KV group do not split
#: over seq's 2 ranks
ULYSSES_TP = dict(mesh=dict(data=1, fsdp=1, expert=1, tensor=2, seq=2),
                  cfg=dict(context_parallel="ulysses"))
CAPACITY_CASES = [n for n, c in CASES.items() if c.get("cfg", {}).get("capacity_factor", -1) > 0]
MOE = dict(d_model=64, d_ffn=128, num_experts=32, top_k=2, capacity_factor=-1.0,
           double_norm=True)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, meta.unbox(tree))


def _lm_batch():
    return _np_tree(next(j_batches(jax.random.PRNGKey(0), vocab_size=128, batch_size=8,
                                   seq_len=32, num_batches=1)))


# --- per-leaf specs against tree_shardings ------------------------------------

PRIMES = (2, 3, 5, 7)  # a leaf's dimensions, told apart after the port's transposes


def _jax_specs_by_port_name(jmodel, sample, cfg, jmesh):
    """{port parameter name: the spec JAX's tree_shardings gives that leaf,
    in the port's layout}."""
    abstract = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), sample))
    shardings = jax.tree_util.tree_leaves(j_tree_shardings(abstract, jmesh)["params"])
    leaves, treedef = jax.tree_util.tree_flatten(meta.unbox(abstract)["params"])
    assert len(shardings) == len(leaves)
    tagged = treedef.unflatten([np.full(PRIMES[:x.ndim], i, np.float32)
                                for i, x in enumerate(leaves)])
    out = {}
    for name, t in params_from_jax({"params": tagged}, cfg).items():
        i = int(t.reshape(-1)[0])
        spec = tuple(shardings[i].spec) + (None,) * leaves[i].ndim
        out[name] = tuple(spec[PRIMES.index(size)] for size in t.shape)
    return out


def _models(kind):
    if kind.startswith("text_lm"):
        kw = dict(CFG, use_qkv_proj=kind == "text_lm")
        return (JTextLM(JModelArgs(**kw)), jnp.zeros((2, 8), jnp.int32), ModelArgs(**kw),
                TextLM(ModelArgs(**kw), device="meta"))
    jcfg, cfg = j_vit2d_xsmall(num_classes=4), vit2d_xsmall(num_classes=4)
    return (JImageEncoder(jcfg), jnp.zeros((1, 3, 64, 64)), cfg,
            ImageEncoder(cfg, device="meta"))


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("kind", ["text_lm", "text_lm_split", "vit2d"])
def test_param_specs_match_jax_tree_shardings(kind, n):
    sizes = choose_mesh_shape(n)
    jmodel, sample, cfg, model = _models(kind)
    want = _jax_specs_by_port_name(jmodel, sample, cfg,
                                   j_create_mesh(**sizes, devices=jax.devices()[:n]))
    layout = ParamLayout(model, create_mesh(**sizes, devices=range(n)))
    got = {name: info.spec for name, info in layout.infos.items()}
    assert got == want
    assert any(a is not None for s in got.values() for a in s)  # something is sharded


# --- the sharded step on 4 ranks -----------------------------------------------


def _jax_loss(cfg, targs, jparams, batch):
    jm = JTextLM(JModelArgs(**cfg))
    jstate = j_create_train_state(jm, j_create_optimizer(targs, 10), jax.random.PRNGKey(1),
                                  jnp.asarray(batch["input_ids"]))
    jstate = jstate.replace(params=jparams)
    _, m = jax.jit(j_make_train_step_fn(jm, targs))(jstate, batch, jax.random.PRNGKey(2))
    return float(m["loss"])


def _single_step(cfg, targs, params, batch):
    """The port's single-process step: (loss, grads, params after, keep
    masks of the MoE layers)."""
    model = TextLM(ModelArgs(**cfg), device="meta")
    model.load_state_dict({k: torch.tensor(v) for k, v in params.items()}, assign=True)
    layers = [m for m in model.modules() if isinstance(m, MoELayer)]
    for m in layers:
        m.record_routing = True
    state = create_train_state(model, create_optimizer(targs, 10))
    _, m = make_train_step(model, targs)(state, {k: torch.tensor(v) for k, v in batch.items()},
                                         2)
    return dict(loss=float(m["loss"]),
                grads={n: p.grad.numpy().copy() for n, p in model.named_parameters()},
                params={n: p.detach().numpy().copy() for n, p in model.named_parameters()},
                keep=[m_.routing and m_.routing["keep"].numpy() for m_ in layers])


def _moe_params_from_jax(v):
    p = _np_tree(v)["params"]
    return {"norm.weight": p["RMSNorm_0"]["weight"],
            "router.router.weight": np.ascontiguousarray(p["TopKRouter_0"]["router"].T),
            "router.router.bias": p["TopKRouter_0"]["router_bias"],
            **{f"experts.{n}": p["ExpertSwiGLU_0"][n] for n in ("w_gate", "w_up", "w_down")}}


def _moe_reference():
    """E32 top-2 at lossless capacity: the input, the port's params, and the
    dense dispatch's output and gradients, from JAX and from the port."""
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (8, 16, 64)))
    jm = JMoELayer(**MOE, dispatch="dense", dtype=jnp.float32, param_dtype=jnp.float32)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))

    def loss(v_):
        out, _ = jm.apply(v_, jnp.asarray(x), deterministic=True)
        return jnp.sum(out ** 2), out

    (_, jout), jgrad = jax.value_and_grad(loss, has_aux=True)(v)
    params = {k: np.array(a, np.float32) for k, a in _moe_params_from_jax(v).items()}
    layer = MoELayer(**MOE, dispatch="dense", device="cpu")
    layer.load_state_dict({k: torch.tensor(a) for k, a in params.items()})
    out, _ = layer(torch.tensor(x))
    (out ** 2).sum().backward()
    return dict(x=x, params=params, jax_out=np.asarray(jout),
                jax_grads=_moe_params_from_jax({"params": jgrad["params"]}),
                out=out.detach().numpy(),
                grads={n: p.grad.numpy() for n, p in layer.named_parameters()})


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """The ranks' sharded steps, and while they run, the references: JAX's
    single-device loss and the port's single-process step for each case."""
    batch = _lm_batch()
    jm = JTextLM(JModelArgs(**CFG))
    jstate = j_create_train_state(jm, j_create_optimizer(JTrainingArgs(grad_accum_steps=1), 10),
                                  jax.random.PRNGKey(1), jnp.asarray(batch["input_ids"]))
    jparams = jstate.params
    params = {k: v.numpy().copy() for k, v in
              params_from_jax(_np_tree(jparams), ModelArgs(**CFG)).items()}
    moe = _moe_reference()
    running = Ranks("sharded_train_cases", WORLD, tmp_path_factory.mktemp("sharded"), dict(
        cfg=CFG, params=params, batch=batch, cases=CASES, ulysses=ULYSSES_TP,
        moe=dict(kw=MOE, params=moe["params"], x=moe["x"])))
    refs = {}
    for name, case in CASES.items():
        cfg = dict(CFG, **case.get("cfg", {}))
        targs = dict(grad_accum_steps=1, **case.get("targs", {}))
        refs[name] = _single_step(cfg, TrainingArgs(**targs), params, batch)
        refs[name]["jax_loss"] = _jax_loss(cfg, JTrainingArgs(**targs), jparams, batch)
    return dict(refs=refs, moe=moe, params=params, ranks=running.results(timeout=240))


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_loss_matches_jax_single_device(steps, case):
    ref = steps["refs"][case]
    losses = [r[case]["loss"] for r in steps["ranks"]]
    assert len(set(losses)) == 1, losses
    np.testing.assert_allclose(losses[0], ref["jax_loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(ref["loss"], ref["jax_loss"], rtol=LOSS_RTOL)
    assert steps["ranks"][0][case]["tokens"] == 8 * 31


def _adamw_after(case, before, grads):
    """The params after the single-process step's clip and AdamW applied to
    ``grads`` (whole arrays) from ``before``."""
    targs = TrainingArgs(grad_accum_steps=1, **CASES[case].get("targs", {}))
    model = TextLM(ModelArgs(**dict(CFG, **CASES[case].get("cfg", {}))), device="meta")
    model.load_state_dict({k: torch.tensor(v) for k, v in before.items()}, assign=True)
    state = create_train_state(model, create_optimizer(targs, 10))
    g = {n: torch.tensor(grads[n]) for n in state.params}
    with torch.no_grad():
        finite, scale = clip_scale(global_norm(g), targs.clip_grad_norm)
        state.tx.update_(state.params, g, state.opt_state, scale=scale, finite=finite)
    return {n: p.detach().numpy() for n, p in state.params.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_gradients_and_update_match_single_process(steps, case):
    """The gradients leaf by leaf within GRAD_TOL of the single step's; the
    update is AdamW's on them, element by element (each rank updates its
    shards as one process would update the whole); and each leaf's change
    within GRAD_TOL's rtol of the single step's in L2 (AdamW divides by
    |g| + eps, so an element whose gradient is near eps = 1e-6 moves by
    lr x its gradient's relative rounding: such elements part by a few
    lr x 1e-3 while the leaf's change agrees)."""
    ref, got = steps["refs"][case], steps["ranks"][0][case]
    assert got["grads"].keys() == ref["grads"].keys()
    adamw = _adamw_after(case, steps["params"], got["grads"])
    for name in ref["grads"]:
        np.testing.assert_allclose(got["grads"][name], ref["grads"][name], err_msg=name,
                                   **GRAD_TOL)
        np.testing.assert_allclose(got["params"][name], adamw[name], rtol=1e-6, atol=1e-9,
                                   err_msg=name)
        before = steps["params"][name]
        d_got, d_want = got["params"][name] - before, ref["params"][name] - before
        assert np.linalg.norm(d_got - d_want) <= GRAD_TOL["rtol"] * np.linalg.norm(d_want), name
    assert any(np.abs(g).max() > 0 for n, g in got["grads"].items() if "router" in n)
    grad_norms = {r[case]["grad_norm"] for r in steps["ranks"]}
    assert len(grad_norms) == 1  # every rank clips by the same norm


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_holds_only_its_shards(steps, case):
    """Resident bytes a rank: params + AdamW's mu and nu at the specs'
    block sizes (fp32) + the count; the specs are the rules' (`fsdp`
    shards `embed`, `tensor` heads / mlp / vocab, `expert` the experts)."""
    mesh = create_mesh(**CASES[case]["mesh"], devices=range(WORLD))
    layout = ParamLayout(TextLM(ModelArgs(**dict(CFG, **CASES[case].get("cfg", {}))),
                                device="meta"), mesh)
    params = sum(i.shard_numel() * 4 for i in layout.infos.values())
    whole = sum(int(np.prod(i.shape)) * 4 for i in layout.infos.values())
    for r in steps["ranks"]:
        got = r[case]
        assert got["resident"] == (params, 2 * params + 4)
        assert got["specs"] == {n: i.spec for n, i in layout.infos.items()}
        for name, info in layout.infos.items():
            assert got["shapes"][name] == tuple(
                s // (mesh.shape[a] if a else 1) for s, a in zip(info.shape, info.spec))
    assert params < whole


@pytest.mark.parametrize("case", CAPACITY_CASES)
def test_sharded_capacity_drops_what_the_single_step_drops(steps, case):
    """The global capacity and slot-major positions: the reference drops
    assignments at capacity 1.25, and the sharded step keeps exactly the
    assignments the single-process step keeps, layer by layer."""
    ref, got = steps["refs"][case], steps["ranks"][0][case]
    assert sum(int((~k).sum()) for k in ref["keep"]) > 0
    for want, keep in zip(ref["keep"], got["keep"]):
        np.testing.assert_array_equal(keep, want)


def test_output_projection_is_row_parallel_over_tensor():
    """The tensor case's layout, read without ranks: w_o ("embed", "heads")
    keeps its input (head) dimension split over tensor."""
    mesh = create_mesh(**CASES["data_tensor"]["mesh"], devices=range(WORLD))
    layout = ParamLayout(TextLM(ModelArgs(**CFG), device="meta"), mesh)
    spec = layout.infos["layers.0.attn_block.attn.w_o.weight"].spec
    assert spec == (None, "tensor")  # row-parallel: ("embed", "heads")


def test_tensor_parallel_step_reduces_over_tensor_on_local_heads(steps):
    for r in steps["ranks"]:
        got = r["data_tensor"]
        assert got["heads"] == [(2, 1)]  # Hq/2 and G/2 a rank
        assert got["by_axis"].get("tensor", 0) > 0
    for case in ("fsdp_expert", "data_expert_sort"):
        assert "tensor" not in steps["ranks"][0][case]["by_axis"]


def test_ulysses_refuses_local_heads_that_seq_does_not_divide(steps):
    for r in steps["ranks"]:
        assert "Hq=2, G=1" in r["ulysses_error"] and "shards=2" in r["ulysses_error"]


def test_expert_parallel_e32_matches_dense(steps):
    """E32 top-2 over expert=4 (8 experts a rank) against the dense
    dispatch, with tests/test_moe_ep32.py's tolerances; the tokens travel,
    the experts do not."""
    ref, moe = steps["moe"], steps["ranks"]
    np.testing.assert_allclose(ref["out"], ref["jax_out"], rtol=5e-5, atol=5e-6)
    for name, g in ref["jax_grads"].items():
        np.testing.assert_allclose(ref["grads"][name], g, rtol=5e-5, atol=5e-6, err_msg=name)
    for r in moe:
        got = r["moe_ep"]
        np.testing.assert_allclose(float((got["out"] ** 2).sum()), float((ref["out"] ** 2).sum()),
                                   rtol=2e-6)
        np.testing.assert_allclose(got["out"], ref["out"], rtol=5e-5, atol=5e-6)
        for name, g in ref["grads"].items():
            np.testing.assert_allclose(got["grads"][name], g, rtol=5e-5, atol=5e-6,
                                       err_msg=name)
        assert got["shapes"]["experts.w_gate"] == (8, 64, 128)
        assert set(got["forward_by_axis"]) == {"expert"}
        assert got["forward_bytes"] < got["expert_bytes"]


# --- the script, ViT-2D and the sharded checkpoint -----------------------------

SCRIPT_ARGV = ["--device", "cpu", "--size", "xsmall", "--batch-size", "4", "--seq-len", "16",
               "--eval-every-steps", "2"]


def _vit_inputs():
    rng = np.random.RandomState(0)
    return {"images": rng.rand(8, 3, 64, 64).astype(np.float32),
            "labels": (np.arange(8) % 4).astype(np.int64)}


def _vit_references(batch):
    """JAX's single-device loss of the caller's step, the port's params
    after the same step in one process, and the params."""
    from vats_tpu_torch.train.vision import VisionTrainingArgs, create_vision_optimizer

    jcfg = j_vit2d_xsmall(dtype="float32", num_classes=4)
    jm = JImageEncoder(jcfg)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(batch["images"]))

    def loss_fn(p):
        logits = jm.apply({"params": p}, jnp.asarray(batch["images"]), deterministic=True)
        return j_smoothed_ce(logits, jnp.asarray(batch["labels"]), 0.0, 4)

    jax_loss = float(loss_fn(v["params"]))
    cfg = vit2d_xsmall(dtype="float32", num_classes=4)
    params = {k: t.numpy().copy() for k, t in params_from_jax(_np_tree(v), cfg).items()}
    model = ImageEncoder(cfg, device="meta")
    model.load_state_dict({k: torch.tensor(a) for k, a in params.items()}, assign=True)
    targs = VisionTrainingArgs(grad_accum_steps=1, use_augmentation=False)
    state = create_train_state(model, create_vision_optimizer(targs, steps_per_epoch=10))
    from torch_parallel_ranks import _vit_step

    t_batch = {k: torch.tensor(a) for k, a in batch.items()}
    _, m = _vit_step(model, 4)(state, t_batch, 1)
    return dict(jax_loss=jax_loss, loss=float(m["loss"]), params=params,
                after={n: p.detach().numpy().copy() for n, p in model.named_parameters()},
                cfg=dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def misc(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_misc")
    batch = _lm_batch()
    m0 = TextLM(ModelArgs(**CFG), device="cpu", seed=3)
    lm_params = {k: v.numpy().copy() for k, v in m0.state_dict().items()}
    vit_batch = _vit_inputs()
    # the references first: the ranks need the ViT weights
    vit = _vit_references(vit_batch)
    (tmp / "ranks").mkdir()
    running = Ranks("sharded_misc", WORLD, tmp / "ranks", dict(
        address=f"file://{tmp}/store",
        script=dict(argv=SCRIPT_ARGV, dirs=[str(tmp / "ckpt_a"), str(tmp / "ckpt_b")]),
        vit=dict(cfg=vit["cfg"], params=vit["params"], batch=vit_batch),
        ckpt=dict(cfg=CFG, params=lm_params, batch=batch, dir=str(tmp / "ckpt_lm"))),
        own_init=True)
    return dict(vit=vit, ranks=running.results(timeout=240))


def test_train_script_trains_sharded_through_multihost_and_mesh(misc):
    for r in misc["ranks"]:
        a, b = r["multihost"], r["mesh"]
        assert a["mesh"] == dict(data=1, fsdp=4, expert=1, tensor=1, seq=1)
        assert a["spec"] == ("fsdp", None) and a["shape"] == (64, 256)  # w_o [d, Hq*hd]
        assert b["mesh"] == dict(data=1, fsdp=2, expert=1, tensor=2, seq=1)
        assert b["spec"] == ("fsdp", "tensor") and b["shape"] == (128, 128)
        assert 100 <= a["tokens_seen"] < b["tokens_seen"]  # the second resumed the first
        assert b["tokens_seen"] >= 200
        for h in (a["history"], b["history"]):
            assert h["train_loss"] and all(np.isfinite(h["train_loss"] + h["val_loss"]))
    for key in ("multihost", "mesh"):
        assert len({(r[key]["tokens_seen"], tuple(r[key]["history"]["val_loss"]))
                    for r in misc["ranks"]}) == 1  # every rank read the same whole batches


def test_sharded_vision_step_matches_jax_and_single_process(misc):
    ref = misc["vit"]
    np.testing.assert_allclose(ref["loss"], ref["jax_loss"], rtol=LOSS_RTOL)
    for r in misc["ranks"]:
        np.testing.assert_allclose(r["vit"]["loss"], ref["jax_loss"], rtol=LOSS_RTOL)
    got = misc["ranks"][0]["vit"]["params"]
    for name, want in ref["after"].items():
        np.testing.assert_allclose(got[name], want, err_msg=name, **GRAD_TOL)


def test_sharded_checkpoint_round_trip(misc):
    got = misc["ranks"][0]["ckpt"]
    saved, _ = load_checkpoint(got["path"])  # one process, no target: whole arrays
    assert saved["params"].keys() == got["saved"].keys()
    for name, want in got["saved"].items():
        np.testing.assert_array_equal(saved["params"][name].numpy(), want)
        np.testing.assert_array_equal(got["restored"][name], want)
    for r in misc["ranks"]:
        c = r["ckpt"]
        assert np.isfinite(c["loss2"]) and c["loss2"] == c["loss"]
        for name, want in c["after"].items():
            np.testing.assert_array_equal(c["after2"][name], want)


def test_sharded_step_skips_a_nonfinite_gradient_on_every_rank(misc):
    """One rank's shard of one expert weight gets a NaN gradient: the
    global norm reaches every rank, every rank skips the step (params and
    moments untouched, skipped_steps 1)."""
    for r in misc["ranks"]:
        skip = r["ckpt"]["nan_skip"]
        assert skip["skipped"] == 1 and skip["unchanged"] and np.isnan(skip["grad_norm"])
