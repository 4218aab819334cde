"""The port's parallel layer against ``vats_tpu.parallel``.

Pure logic in this process: the logical-axis rules and their resolution,
the mesh size rules, ``choose_mesh_shape``, blocks of a batch, and the
context-parallel fallback of ``Attention`` under a mesh.  Spawned gloo
ranks (``tests/torch_parallel_ranks.py``; two spawns here):

  * the sequence-parallel train step of a tiny MoE TextLM (E4 top-2 sort,
    lossless, ragged padding) on a data=2 x seq=2 mesh of 4 ranks, ring and
    Ulysses, and the ring under remat 'dots': the loss within rtol 1e-4 of
    the JAX package's single-device step (JAX's own bound between its
    sharded and single steps); the all-reduced gradients, the same on every
    rank, against the port's single-process step leaf by leaf within atol
    1e-6, rtol 1e-4 (fp32 sums in another order); the same for a
    capacity-limited MoE (capacity 1.25, its global capacity and slot-major
    positions) against JAX's and the port's single steps at that capacity,
    and one step on an fsdp=2 x seq=2 mesh;
  * ``initialize_multihost`` from the environment on 2 ranks, with the
    host-sharded helpers.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import meta

from torch_parallel_ranks import Ranks, spawn
from vats_tpu.configs import ModelArgs as JModelArgs
from vats_tpu.configs import TrainingArgs as JTrainingArgs
from vats_tpu.data import synthetic_lm_batches as j_batches
from vats_tpu.models import TextLM as JTextLM
from vats_tpu.parallel import create_device_mesh as j_create_device_mesh
from vats_tpu.parallel import create_mesh as j_create_mesh
from vats_tpu.parallel import logical_axis_rules as j_logical_axis_rules
from vats_tpu.parallel import logical_to_mesh_spec as j_logical_to_mesh_spec
from vats_tpu.parallel.sharded import choose_mesh_shape as j_choose_mesh_shape
from vats_tpu.train import create_optimizer as j_create_optimizer
from vats_tpu.train import create_train_state as j_create_train_state
from vats_tpu.train.loop import make_train_step_fn as j_make_train_step_fn
from vats_tpu_torch.configs import ModelArgs, TrainingArgs
from vats_tpu_torch.models import TextLM
from vats_tpu_torch.nn import attention as attn_mod
from vats_tpu_torch.parallel import (
    MESH_AXES,
    create_device_mesh,
    create_mesh,
    logical_axis_rules,
    logical_to_mesh_spec,
)
from vats_tpu_torch.parallel.mesh import DEFAULT_LOGICAL_AXIS_RULES, named_sharding
from vats_tpu_torch.parallel.sharded import batch_sharding, choose_mesh_shape
from vats_tpu_torch.train import create_optimizer, create_train_state, make_train_step
from vats_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

LOSS_RTOL = 1e-4
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)

MESH_SHAPES = [
    dict(data=1, fsdp=8, expert=1, tensor=1, seq=1),
    dict(data=2, fsdp=2, expert=2, tensor=1, seq=1),
    dict(data=1, fsdp=2, expert=1, tensor=2, seq=2),
    dict(data=2, fsdp=1, expert=1, tensor=1, seq=4),
    dict(data=8, fsdp=1, expert=1, tensor=1, seq=1),
]
LOGICAL = [
    ("batch", "activation_seq", "activation_embed"),
    ("batch", None, "heads", "head_dim"),
    ("embed", "mlp"),
    ("experts", "embed", "expert_mlp"),
    ("vocab", "embed"),
    ("activation_batch", "activation_seq", "activation_heads", "activation_kv"),
    ("batch", "batch"),  # an axis already used resolves to None the second time
    ("conv_in", "conv_out", "norm", "unknown_name"),
]


@pytest.mark.parametrize("shape", range(len(MESH_SHAPES)))
def test_logical_to_mesh_spec_matches_jax(shape):
    sizes = MESH_SHAPES[shape]
    jmesh = j_create_mesh(**sizes, devices=jax.devices())
    mesh = create_mesh(**sizes, devices=range(8))
    assert mesh.shape == dict(jmesh.shape)
    overrides = [("embed", ("fsdp", "data")), ("mlp", None)]
    for axes in LOGICAL:
        assert logical_to_mesh_spec(axes, mesh=mesh) == tuple(
            j_logical_to_mesh_spec(axes, mesh=jmesh)), axes
        assert logical_to_mesh_spec(axes) == tuple(j_logical_to_mesh_spec(axes)), axes
        rules = logical_axis_rules(overrides)
        assert rules == j_logical_axis_rules(overrides)
        assert logical_to_mesh_spec(axes, rules, mesh) == tuple(
            j_logical_to_mesh_spec(axes, j_logical_axis_rules(overrides), jmesh)), axes
    assert logical_axis_rules() == DEFAULT_LOGICAL_AXIS_RULES == j_logical_axis_rules()


@pytest.mark.parametrize("sizes", [
    dict(data=-1, fsdp=-1),                 # two unknown axes
    dict(data=3, fsdp=-1),                  # 8 ranks do not divide by 3
    dict(data=2, fsdp=2, expert=1, seq=1),  # product 4 != 8
    dict(data=4, fsdp=4),                   # product 16 != 8
])
def test_create_device_mesh_rejects_what_jax_rejects(sizes):
    with pytest.raises(ValueError) as ej:
        j_create_device_mesh(**sizes, devices=jax.devices())
    with pytest.raises(ValueError) as et:
        create_device_mesh(**sizes, devices=range(8))
    assert str(et.value) == str(ej.value)


def test_create_device_mesh_lays_ranks_as_jax_lays_devices():
    for sizes in MESH_SHAPES + [dict(data=2, fsdp=-1, seq=2)]:
        j = j_create_device_mesh(**sizes, devices=jax.devices())
        t = create_device_mesh(**sizes, devices=range(8))
        assert t.shape == j.shape
        assert t.tolist() == np.vectorize(lambda d: d.id)(j).tolist()
    mesh = create_mesh(data=2, fsdp=-1, devices=range(8))
    assert mesh.axis_names == MESH_AXES and mesh.shape["fsdp"] == 4


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 6])
@pytest.mark.parametrize("cp", [False, True])
def test_choose_mesh_shape_matches_jax(n, cp):
    try:
        want = j_choose_mesh_shape(n, context_parallel=cp)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            choose_mesh_shape(n, context_parallel=cp)
        return
    assert choose_mesh_shape(n, context_parallel=cp) == want


def test_batch_sharding_blocks_of_rank_zero():
    """Outside a process group this process is rank 0: its block of a
    batch is the first rows over data x fsdp and the first tokens over
    seq; a dimension the shards do not divide raises."""
    mesh = create_mesh(data=2, fsdp=1, expert=1, tensor=1, seq=4, devices=range(8))
    ids = torch.arange(6 * 16).reshape(6, 16)
    assert batch_sharding(mesh).spec == ("data", "seq")
    assert torch.equal(batch_sharding(mesh).shard(ids), ids[:3, :4])
    assert torch.equal(named_sharding(mesh, "batch").shard(ids), ids[:3])
    with pytest.raises(ValueError):
        batch_sharding(mesh).shard(ids[:, :15])


def test_ambient_mesh_is_seen_from_other_threads():
    """On the card the autograd engine recomputes checkpointed blocks on a
    thread of its own; the mesh (and whether the inputs are sharded) must
    be visible there as in the forward."""
    import threading

    from vats_tpu_torch.parallel import ambient_mesh
    from vats_tpu_torch.parallel.mesh import inputs_sharded

    mesh = create_mesh(data=1, fsdp=1, expert=1, tensor=1, seq=2, devices=range(2))
    seen = []
    read = lambda: seen.append((ambient_mesh(), inputs_sharded()))  # noqa: E731
    with mesh.batch_sharded():
        t = threading.Thread(target=read)
        t.start()
        t.join()
    read()
    assert seen == [(mesh, True), (None, False)]


def test_cp_decode_fallback_warns():
    """Mirror of tests/test_multichip.py::test_cp_decode_fallback_warns: a
    length the seq axis does not divide (whole sequences on every rank)
    falls back to local attention and logs "UNSHARDED"; T = 1 stays
    quiet."""
    mesh = create_mesh(data=1, fsdp=1, expert=1, tensor=1, seq=4, devices=range(4))
    attn = attn_mod.Attention(d_model=32, num_heads=4, query_groups=2,
                              context_parallel="ring", device="cpu")
    records = []

    class Grab(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logger = logging.getLogger("vats_tpu_torch")
    h = Grab()
    for t, loud in ((6, True), (1, False)):
        attn_mod._warned_cp_fallbacks.clear()
        records.clear()
        logger.addHandler(h)
        try:
            with mesh:
                out = attn._maybe_context_parallel(
                    torch.ones((1, t, 4, 8)), torch.ones((1, t, 2, 8)),
                    torch.ones((1, t, 2, 8)), 0.25, True, -1, -1, None, None)
        finally:
            logger.removeHandler(h)
        assert out is None, "an indivisible T must fall back to local attention"
        assert any("UNSHARDED" in m for m in records) == loud, records


def test_context_parallel_modes_are_accepted():
    for mode in ("none", "ring", "ulysses"):
        cfg = ModelArgs(d_model=32, num_heads=4, query_groups=2, d_ffn=64, num_layers=1,
                        vocab_size=64, max_seq_len=16, context_parallel=mode)
        assert TextLM(cfg, device="cpu").layers[0].attn_block.attn.context_parallel == mode
    with pytest.raises(ValueError, match="context_parallel"):
        attn_mod.Attention(d_model=32, num_heads=4, query_groups=2,
                           context_parallel="tree", device="cpu")


# --- the sequence-parallel train step on 4 ranks ------------------------------

SP_CFG = dict(
    d_model=64, num_heads=4, query_groups=2, d_ffn=128, num_layers=2,
    dropout=0.0, vocab_size=128, max_seq_len=64, left_window=-1,
    num_experts=4, top_k=2, moe_dispatch="sort", capacity_factor=-1.0,
    dtype="float32", gradient_checkpointing=False, use_mqa=False,
)
SP_CASES = {
    "ring": dict(context_parallel="ring"),
    "ulysses": dict(context_parallel="ulysses"),
    "ring_remat_dots": dict(context_parallel="ring", gradient_checkpointing=True,
                            remat_policy="dots"),
    # mode 'none' on sharded tokens: K/V gathered, this rank's queries attend
    # the whole sequence (the plain attention, and flash's plain version)
    "none_gathered": dict(context_parallel="none"),
    "none_gathered_flash": dict(context_parallel="none", attention_impl="flash"),
    "capacity": dict(context_parallel="ring", capacity_factor=1.25),
}
STEP_CASES = ["ring", "ulysses", "ring_remat_dots", "none_gathered", "none_gathered_flash"]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, meta.unbox(tree))


@pytest.fixture(scope="module")
def sp(tmp_path_factory):
    """JAX single-device loss, the port's single-process step and the
    4-rank sharded steps, from the same weights and batch (the references
    are computed while the ranks run)."""
    jcfg = JModelArgs(**SP_CFG)
    jm = JTextLM(jcfg)
    batch = _np_tree(next(j_batches(jax.random.PRNGKey(0), vocab_size=128, batch_size=8,
                                    seq_len=32, num_batches=1, pad_fraction=0.3)))
    jargs = JTrainingArgs(grad_accum_steps=1)
    jstate = j_create_train_state(jm, j_create_optimizer(jargs, 10), jax.random.PRNGKey(1),
                                  jnp.asarray(batch["input_ids"]))
    cfg = ModelArgs(**SP_CFG)
    params = {k: v.numpy().copy() for k, v in params_from_jax(_np_tree(jstate.params),
                                                               cfg).items()}
    running = Ranks("sp_train_steps", 4, tmp_path_factory.mktemp("sp"), dict(
        cfg=SP_CFG, params=params, batch=batch, data=2, cases=SP_CASES))
    refs = {}
    for key, overrides in (("lossless", {}), ("capacity", SP_CASES["capacity"])):
        jm = JTextLM(JModelArgs(**dict(SP_CFG, **overrides)))
        _, jm_metrics = jax.jit(j_make_train_step_fn(jm, jargs))(jstate, batch,
                                                                jax.random.PRNGKey(2))
        model = TextLM(ModelArgs(**dict(SP_CFG, **overrides)), device="meta")
        model.load_state_dict({k: torch.tensor(v) for k, v in params.items()}, assign=True)
        targs = TrainingArgs(grad_accum_steps=1)
        state = create_train_state(model, create_optimizer(targs, 10))
        _, m = make_train_step(model, targs)(state, {k: torch.tensor(v)
                                                     for k, v in batch.items()}, 2)
        refs[key] = dict(jax_loss=float(jm_metrics["loss"]), single_loss=float(m["loss"]),
                         single_tokens=int(m["tokens"]),
                         single_grads={n: p.grad.numpy().copy()
                                       for n, p in model.named_parameters()})
    return dict(refs["lossless"], capacity=refs["capacity"], ranks=running.results())


@pytest.mark.parametrize("case", STEP_CASES)
def test_seq_parallel_loss_matches_jax_single_device(sp, case):
    for r in sp["ranks"]:
        np.testing.assert_allclose(r[case]["loss"], sp["jax_loss"], rtol=LOSS_RTOL)
        assert r[case]["tokens"] == sp["single_tokens"]
    np.testing.assert_allclose(sp["single_loss"], sp["jax_loss"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("case", STEP_CASES)
def test_seq_parallel_gradients_match_single_process(sp, case):
    sums = [r[case]["checksum"] for r in sp["ranks"]]
    assert max(sums) == min(sums), f"the ranks' gradients differ: {sums}"
    got = sp["ranks"][0][case]["grads"]
    assert got.keys() == sp["single_grads"].keys()
    for name, want in sp["single_grads"].items():
        np.testing.assert_allclose(got[name], want, err_msg=name, **GRAD_TOL)
    assert any(np.abs(g).max() > 0 for n, g in got.items() if "router" in n)


def test_seq_parallel_refuses_what_is_not_ported(sp):
    """What this slice once refused now trains: a capacity-limited MoE on
    the data x seq mesh (its loss against JAX's single step at capacity
    1.25, its gradients against the port's, leaf by leaf), and an fsdp x
    seq mesh (its loss against JAX's)."""
    ref = sp["capacity"]
    for r in sp["ranks"]:
        np.testing.assert_allclose(r["capacity"]["loss"], ref["jax_loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["fsdp_step"]["loss"], sp["jax_loss"], rtol=LOSS_RTOL)
        assert r["fsdp_step"]["tokens"] == sp["single_tokens"]
    np.testing.assert_allclose(ref["single_loss"], ref["jax_loss"], rtol=LOSS_RTOL)
    assert abs(ref["jax_loss"] - sp["jax_loss"]) > 1e-6  # the capacity drops assignments
    got = sp["ranks"][0]["capacity"]["grads"]
    for name, want in ref["single_grads"].items():
        np.testing.assert_allclose(got[name], want, err_msg=name, **GRAD_TOL)


def test_initialize_multihost_from_the_environment(tmp_path):
    ranks = spawn("multihost_init", 2, tmp_path, dict(
        address=f"file://{tmp_path}/store", total=9), own_init=True)
    assert [r["rank"] for r in ranks] == [0, 1] and {r["world"] for r in ranks} == {2}
    assert [r["slice"] for r in ranks] == [(0, 4), (4, 8)]  # 9 rows, remainder dropped
    assert [r["coordinator"] for r in ranks] == [True, False]
    rows = np.arange(16).reshape(8, 2)
    np.testing.assert_array_equal(ranks[0]["rows"], rows[:4])
    np.testing.assert_array_equal(ranks[1]["rows"], rows[4:])
    assert {r["total"] for r in ranks} == {3.0}
    for r in ranks:  # one 4-byte all-reduce; CPU tensors wait for no device, stage nothing
        t = r["traffic"]
        assert (t["bytes"], t["calls"], t["wait_s"], t["staging_s"]) == (4, 1, 0.0, 0.0)
        assert t["exchange_s"] > 0


def test_initialize_multihost_needs_an_explicit_backend():
    from vats_tpu_torch.parallel.multihost import initialize_multihost

    with pytest.raises(ValueError, match="backend"):
        initialize_multihost("localhost:1", 1, 0)
