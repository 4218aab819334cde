"""Rank bodies of the port's multi-process tests, and the spawner.

``spawn(name, world, tmp_path, payload)`` (or ``Ranks(...)``, whose
``results()`` waits, so the parent can work meanwhile) starts ``world`` processes with
the ``spawn`` start method; each joins a gloo world through a file under
``tmp_path`` (no ports, so parallel test workers never clash), runs the
function ``name`` of this module as ``fn(rank, world, payload)`` and saves
what it returns; the parent gets the list of results in rank order.  A
spawned child imports this module afresh and never runs
``tests/conftest.py``, so this module imports no JAX: the parents compute
the JAX references.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import sys
import traceback

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _entry(rank, world, tmp, name, payload, own_init):
    sys.path.insert(0, REPO)
    torch.set_num_threads(1)
    import torch.distributed as dist

    try:
        if not own_init:
            dist.init_process_group("gloo", init_method=f"file://{tmp}/init",
                                    world_size=world, rank=rank)
        result = globals()[name](rank, world, payload)
        torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class Ranks:
    """Spawned ranks running one function; :meth:`results` waits for them."""

    def __init__(self, name, world, tmp_path, payload, own_init=False):
        self.name, self.tmp = name, str(tmp_path)
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_entry,
                                  args=(r, world, self.tmp, name, payload, own_init))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def results(self, timeout=300):
        """Each rank's result in rank order; raises where a rank failed or
        hung (its traceback in the message)."""
        for p in self.procs:
            p.join(timeout)
        hung = [p for p in self.procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
        errs = [open(os.path.join(self.tmp, f)).read()
                for f in sorted(os.listdir(self.tmp)) if f.endswith(".err")]
        if hung or errs or any(p.exitcode != 0 for p in self.procs):
            raise AssertionError(f"{self.name}: {len(hung)} ranks hung, exit codes "
                                 f"{[p.exitcode for p in self.procs]}\n" + "\n".join(errs))
        return [torch.load(os.path.join(self.tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(len(self.procs))]


def spawn(name, world, tmp_path, payload, own_init=False, timeout=300):
    """Run ``name`` on ``world`` spawned gloo ranks; returns their results."""
    return Ranks(name, world, tmp_path, payload, own_init).results(timeout)


def _seq_mesh(world, data=1):
    from vats_tpu_torch.parallel import create_mesh

    return create_mesh(data=data, fsdp=1, expert=1, tensor=1, seq=world // data)


def _shard(x, r, n):
    if x is None:
        return None
    x = torch.as_tensor(x)
    t = x.shape[1] // n
    return x[:, r * t:(r + 1) * t].contiguous()


def _np(x):
    return None if x is None else x.detach().float().numpy()


def attention_cases(rank, world, cases):
    """Each case: ring (flash or, impl 'ring_xla', blockwise) or Ulysses
    attention over this rank's shard of seeded whole inputs; returns {name:
    {out, dq, dk, dv, calls}} of the rank's shard (gradients where the case
    asks, from ``do``; calls: the collectives the case ran)."""
    from vats_tpu_torch.ops.ring_attention import ring_attention
    from vats_tpu_torch.ops.ulysses import ulysses_attention
    from vats_tpu_torch.parallel import collectives

    mesh = _seq_mesh(world)
    r = mesh.axis_index("seq")
    out = {}
    for c in cases:
        dt = getattr(torch, c["dtype"])
        q, k, v = (_shard(c[x], r, world).to(dt) for x in ("q", "k", "v"))
        kw = dict(c["kw"], mesh=mesh)
        if c.get("valid") is not None:
            kw["kv_valid"] = _shard(c["valid"], r, world)
        if c.get("seg") is not None:
            kw["q_segment_ids"] = kw["kv_segment_ids"] = _shard(c["seg"], r, world)
        fn = ulysses_attention if c["impl"] == "ulysses" else ring_attention
        if c["impl"] == "ring_xla":
            kw["impl"] = "xla"
        n0 = collectives.traffic["calls"]
        if c.get("expect_error"):
            try:
                fn(q, k, v, **kw)
            except (ValueError, NotImplementedError) as e:
                out[c["name"]] = dict(error=str(e), type=type(e).__name__,
                                      calls=collectives.traffic["calls"] - n0)
            else:
                out[c["name"]] = dict(error=None)
            continue
        grad = c.get("do") is not None
        for x in (q, k, v):
            x.requires_grad_(grad)
        o = fn(q, k, v, **kw)
        res = dict(out=_np(o))
        if grad:
            o.backward(_shard(c["do"], r, world).to(dt))
            res.update(dq=_np(q.grad), dk=_np(k.grad), dv=_np(v.grad))
        out[c["name"]] = dict(res, calls=collectives.traffic["calls"] - n0)
    return out


def _lm_batch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def sp_train_steps(rank, world, payload):
    """The sequence-parallel train step of a tiny TextLM on a data x seq
    mesh, one case per (context_parallel, remat, capacity); returns each
    case's metrics and (rank 0) global gradients, with every rank's gradient
    checksum.  Also one step on an fsdp x seq mesh (its metrics)."""
    from vats_tpu_torch.configs import ModelArgs, TrainingArgs
    from vats_tpu_torch.models import TextLM
    from vats_tpu_torch.parallel import create_mesh
    from vats_tpu_torch.parallel.sharded import make_sharded_train

    targs = TrainingArgs(grad_accum_steps=1)
    batch = _lm_batch(payload["batch"])
    params = {k: torch.tensor(v) for k, v in payload["params"].items()}

    def model_of(overrides):
        model = TextLM(ModelArgs(**dict(payload["cfg"], **overrides)), device="meta")
        model.load_state_dict(params, assign=True)
        return model

    mesh = _seq_mesh(world, data=payload["data"])
    out = {}
    for name, overrides in payload["cases"].items():
        model = model_of(overrides)
        init, step, _ = make_sharded_train(model, targs, mesh, batch, num_training_steps=10)
        state, m = step(init(), batch, 2)
        grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
        res = {k: float(v) for k, v in m.items()}
        res["checksum"] = float(sum(g.double().sum() for g in grads.values()))
        if rank == 0:
            res["grads"] = {n: g.numpy() for n, g in grads.items()}
        out[name] = res
    fsdp = create_mesh(data=1, fsdp=2, expert=1, tensor=1, seq=world // 2)
    init, step, _ = make_sharded_train(model_of(dict(context_parallel="ring")), targs, fsdp,
                                       batch, num_training_steps=10)
    _, m = step(init(), batch, 2)
    out["fsdp_step"] = {k: float(v) for k, v in m.items()}
    return out


def multihost_init(rank, world, payload):
    """``initialize_multihost`` from the environment, then the host-sharded
    helpers and one all-reduce over the mesh."""
    from vats_tpu_torch.parallel import collectives, create_mesh
    from vats_tpu_torch.parallel.multihost import (
        host_shard_slice,
        initialize_multihost,
        is_coordinator,
        make_global_batch,
    )

    os.environ.update(COORDINATOR_ADDRESS=payload["address"], NUM_PROCESSES=str(world),
                      PROCESS_ID=str(rank))
    initialize_multihost(backend="gloo")
    initialize_multihost(backend="gloo")  # a second call is a no-op
    import torch.distributed as dist

    mesh = create_mesh(data=world, fsdp=1)
    rows = make_global_batch({"ids": np.arange(16).reshape(8, 2)}, mesh)["ids"]
    collectives.reset_traffic()
    total = collectives.all_reduce(torch.tensor([float(rank + 1)]), mesh, ("data",))
    sl = host_shard_slice(payload["total"])
    return dict(rank=dist.get_rank(), world=dist.get_world_size(),
                slice=(sl.start, sl.stop), coordinator=is_coordinator(),
                rows=rows.numpy(), total=float(total), traffic=dict(collectives.traffic))


def card_ring(rank, world, payload):
    """Ring attention on cuda:0 (gloo, host-staged), forward and backward
    over this rank's shard; returns its out / dq / dk / dv (fp32, on the
    CPU) and its (K2', K5a, K5b) launches."""
    from vats_tpu_torch.ops import flash_attention as fa
    from vats_tpu_torch.ops.ring_attention import ring_attention

    torch.cuda.set_device(0)
    mesh = _seq_mesh(world)
    r = mesh.axis_index("seq")
    q, k, v, do = (_shard(payload[x], r, world).cuda().bfloat16() for x in ("q", "k", "v", "do"))
    for x in (q, k, v):
        x.requires_grad_()
    fns = (fa.flash_attention_lse, fa.flash_bwd_dkv, fa.flash_bwd_dq)
    for fn in fns:
        fn.launches = 0
    o = ring_attention(q, k, v, mesh=mesh, **payload["kw"])
    o.backward(do)
    torch.cuda.synchronize()
    return dict(out=o.detach().float().cpu(), dq=q.grad.float().cpu(),
                dk=k.grad.float().cpu(), dv=v.grad.float().cpu(),
                launches=tuple(fn.launches for fn in fns))


def card_blockwise_ring(rank, world, payload):
    """The blockwise ring (``impl="xla"``) forward and backward on this
    rank's shard, once on cuda:0 and once on the CPU, from the same inputs
    in ``payload["dtype"]``; returns {device: (out, dq, dk, dv)} in fp32 on
    the CPU."""
    from vats_tpu_torch.ops.ring_attention import ring_attention

    torch.cuda.set_device(0)
    mesh = _seq_mesh(world)
    r = mesh.axis_index("seq")
    dt = getattr(torch, payload["dtype"])
    out = {}
    for dev in ("cuda", "cpu"):
        q, k, v, do = (_shard(payload[x], r, world).to(dev, dt) for x in ("q", "k", "v", "do"))
        for x in (q, k, v):
            x.requires_grad_()
        valid = _shard(payload["valid"], r, world).to(dev)
        o = ring_attention(q, k, v, mesh=mesh, impl="xla", kv_valid=valid, **payload["kw"])
        o.backward(do)
        out[dev] = tuple(x.detach().float().cpu() for x in (o, q.grad, k.grad, v.grad))
    return out


# --- FSDP, tensor and expert sharding -----------------------------------------


def _lm(cfg, params):
    from vats_tpu_torch.configs import ModelArgs
    from vats_tpu_torch.models import TextLM

    model = TextLM(ModelArgs(**cfg), device="meta")
    model.load_state_dict({k: torch.tensor(v) for k, v in params.items()}, assign=True)
    return model


def _record_routing(model):
    from vats_tpu_torch.nn.moe import MoELayer

    layers = [m for m in model.modules() if isinstance(m, MoELayer)]
    for m in layers:
        m.record_routing = True
    return layers


def _whole(tensors):
    """{name: whole array} of sharded tensors (a collective on every rank)."""
    from vats_tpu_torch.parallel.layout import whole

    out = {}
    for name, (t, info) in tensors.items():
        t = t.detach()
        out[name] = (whole(t, info) if info is not None else t).numpy().copy()
    return out


def _grads_and_params(model):
    grads = _whole({n: (p.grad if p.grad is not None else torch.zeros_like(p),
                        getattr(p, "shard_info", None)) for n, p in model.named_parameters()})
    params = _whole({n: (p, getattr(p, "shard_info", None))
                     for n, p in model.named_parameters()})
    return grads, params


def sharded_train_cases(rank, world, payload):
    """Each TextLM case: one sharded step over the case's mesh from the
    payload's weights and whole batch; returns the rank's metrics, resident
    bytes, traffic by axis and local head counts, and (rank 0) the whole
    gradients, the whole params after the update and each MoE layer's
    global keep mask.  Then the E32 expert=4 MoE layer case."""
    from vats_tpu_torch.configs import TrainingArgs
    from vats_tpu_torch.nn import attention as attn_mod
    from vats_tpu_torch.parallel import collectives, create_mesh
    from vats_tpu_torch.parallel.layout import tensor_bytes
    from vats_tpu_torch.parallel.sharded import make_sharded_train

    heads = []
    plain = attn_mod.dot_product_attention

    def seen(q, k, v, **kw):  # the heads this rank's attention sees
        heads.append((q.shape[2], k.shape[2]))
        return plain(q, k, v, **kw)

    attn_mod.dot_product_attention = seen
    batch = _lm_batch(payload["batch"])
    out = {}
    for name, case in payload["cases"].items():
        mesh = create_mesh(**case["mesh"])
        model = _lm(dict(payload["cfg"], **case.get("cfg", {})), payload["params"])
        layers = _record_routing(model)
        targs = TrainingArgs(grad_accum_steps=1, **case.get("targs", {}))
        init, step, shardings = make_sharded_train(model, targs, mesh, batch,
                                                   num_training_steps=10)
        state = init()
        heads.clear()
        collectives.reset_traffic()
        state, m = step(state, batch, 2)
        res = {k: float(v) for k, v in m.items()}
        res.update(resident=(tensor_bytes(state.params), tensor_bytes(state.opt_state)),
                   by_axis=dict(collectives.traffic["by_axis"]), heads=sorted(set(heads)),
                   specs={n: s.spec for n, s in shardings["params"].items()},
                   shapes={n: tuple(p.shape) for n, p in model.named_parameters()})
        grads, params = _grads_and_params(model)
        if rank == 0:
            res.update(grads=grads, params=params,
                       keep=[m_.routing and m_.routing["keep"].numpy() for m_ in layers])
        out[name] = res
    attn_mod.dot_product_attention = plain
    case = payload["ulysses"]
    model = _lm(dict(payload["cfg"], **case["cfg"]), payload["params"])
    init, step, _ = make_sharded_train(model, TrainingArgs(grad_accum_steps=1),
                                       create_mesh(**case["mesh"]), batch)
    try:
        step(init(), batch, 2)
    except ValueError as e:
        out["ulysses_error"] = str(e)
    out["moe_ep"] = _moe_ep_case(payload["moe"])
    return out


def _moe_ep_case(p):
    """An E32 top-2 'sort' MoELayer with its experts over expert=4: the
    whole input on every rank, loss sum(out^2); forward traffic and the
    whole gradients."""
    from vats_tpu_torch.nn.moe import MoELayer
    from vats_tpu_torch.parallel import collectives, create_mesh
    from vats_tpu_torch.parallel.layout import ParamLayout

    mesh = create_mesh(data=1, fsdp=1, expert=4, tensor=1, seq=1)
    layer = MoELayer(**p["kw"], dispatch="sort", device="cpu")
    layer.load_state_dict({k: torch.tensor(v) for k, v in p["params"].items()})
    ParamLayout(layer, mesh).shard_(layer)
    expert_bytes = sum(w.numel() * w.element_size() for w in layer.experts.parameters())
    collectives.reset_traffic()
    out, _ = layer(torch.tensor(p["x"]))
    forward = dict(collectives.traffic["by_axis"]), collectives.traffic["bytes"]
    (out.float() ** 2).sum().backward()
    grads, _ = _grads_and_params(layer)
    return dict(out=out.detach().numpy(), grads=grads, forward_by_axis=forward[0],
                forward_bytes=forward[1], expert_bytes=expert_bytes,
                shapes={n: tuple(w.shape) for n, w in layer.named_parameters()})


def sharded_misc(rank, world, payload):
    """Joins the world itself, through the train script's ``--multihost``
    (the environment's coordinator, a default fsdp=-1 mesh); then the
    script with ``--mesh fsdp=2,tensor=2`` resuming that run's checkpoint;
    ViT-2D on fsdp=2 x tensor=2 with a caller's step; a sharded TextLM
    checkpoint saved, loaded back into the sharded layout and stepped
    beside an unbroken run."""
    import torch.distributed as dist

    from vats_tpu_torch.scripts.nlp import train as train_script

    os.environ.update(COORDINATOR_ADDRESS=payload["address"], NUM_PROCESSES=str(world),
                      PROCESS_ID=str(rank))
    out = {}
    script = payload["script"]
    first = train_script.main(script["argv"] + ["--multihost", "--backend", "gloo",
                                                "--max-train-tokens", "100",
                                                "--ckpt-dir", script["dirs"][0]])
    assert dist.is_initialized() and dist.get_world_size() == world
    resume = os.path.join(script["dirs"][0], "best_model")
    second = train_script.main(script["argv"] + ["--mesh", "fsdp=2,tensor=2", "--resume", resume,
                                                 "--max-train-tokens", "200",
                                                 "--ckpt-dir", script["dirs"][1]])
    for key, res in (("multihost", first), ("mesh", second)):
        p = res["state"].params["layers.0.attn_block.attn.w_o.weight"]
        out[key] = dict(history=res["history"], tokens_seen=int(res["state"].tokens_seen),
                        spec=p.shard_info.spec, shape=tuple(p.shape),
                        mesh=dict(p.shard_info.mesh.shape))
    out["vit"] = _vit_case(payload["vit"])
    out["ckpt"] = _checkpoint_case(payload["ckpt"])
    return out


def _vit_step(model, num_classes):
    """The caller's step of the JAX package's sharded vision test: the
    smoothed CE of the rank's rows, backward, ``apply_gradients``."""
    from vats_tpu_torch.train.vision import smoothed_ce

    def step(state, batch, rng):
        for p in state.params.values():
            p.grad = None
        logits = model(batch["images"], deterministic=False, dropout_seed=rng)
        loss = smoothed_ce(logits, batch["labels"], 0.0, num_classes)
        loss.backward()
        state.apply_gradients({n: p.grad for n, p in state.params.items()})
        return state, {"loss": loss.detach()}

    return step


def _vit_case(p):
    from vats_tpu_torch.configs.vit2d import ViT2DArgs
    from vats_tpu_torch.models.vit2d import ImageEncoder
    from vats_tpu_torch.parallel import create_mesh
    from vats_tpu_torch.parallel.layout import tensor_bytes
    from vats_tpu_torch.parallel.sharded import make_sharded_train
    from vats_tpu_torch.train.vision import VisionTrainingArgs, create_vision_optimizer

    cfg = ViT2DArgs(**p["cfg"])
    model = ImageEncoder(cfg, device="meta")
    model.load_state_dict({k: torch.tensor(v) for k, v in p["params"].items()}, assign=True)
    targs = VisionTrainingArgs(grad_accum_steps=1, use_augmentation=False)
    batch = {k: torch.tensor(v) for k, v in p["batch"].items()}
    mesh = create_mesh(data=1, fsdp=2, expert=1, tensor=2, seq=1)
    init, step, _ = make_sharded_train(
        model, targs, mesh, batch, train_step_fn=_vit_step(model, cfg.num_classes),
        tx=create_vision_optimizer(targs, steps_per_epoch=10))
    state = init()
    state, m = step(state, batch, 1)
    _, params = _grads_and_params(model)
    return dict(loss=float(m["loss"]), params=params,
                resident=tensor_bytes(state.params) + tensor_bytes(state.opt_state))


def _checkpoint_case(p):
    from vats_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
    from vats_tpu_torch.configs import TrainingArgs
    from vats_tpu_torch.parallel import create_mesh
    from vats_tpu_torch.parallel.layout import whole_state_dict
    from vats_tpu_torch.parallel.sharded import make_sharded_train

    batch = _lm_batch(p["batch"])
    targs = TrainingArgs(grad_accum_steps=1)
    mesh = create_mesh(data=1, fsdp=2, expert=2, tensor=1, seq=1)
    runs = []
    for _ in range(2):
        model = _lm(p["cfg"], p["params"])
        init, step, _ = make_sharded_train(model, targs, mesh, batch, num_training_steps=10)
        runs.append((model, init(), step))
    (model, state, step), (model2, state2, step2) = runs
    state, _ = step(state, batch, 2)
    path = save_checkpoint(p["dir"], state, loss=2.0, is_best=True)
    saved = {k: v.numpy().copy() for k, v in whole_state_dict(model).items()}
    state2, _ = load_checkpoint(path, target=state2)
    restored = {k: v.numpy().copy() for k, v in whole_state_dict(model2).items()}
    state, m = step(state, batch, 3)
    state2, m2 = step2(state2, batch, 3)
    after = _grads_and_params(model)[1]
    after2 = _grads_and_params(model2)[1]
    # a non-finite gradient on one rank's shard alone: every rank skips
    import torch.distributed as dist

    w = dict(model.named_parameters())["layers.0.moe_block.moe.experts.w_gate"]
    hook = w.register_hook(lambda g: torch.full_like(g, float("nan"))) \
        if dist.get_rank() == 1 else None
    state, m3 = step(state, batch, 4)
    if hook is not None:
        hook.remove()
    unchanged = all(np.array_equal(a, after[n]) for n, a in _grads_and_params(model)[1].items())
    return dict(path=path, saved=saved, restored=restored, loss=float(m["loss"]),
                loss2=float(m2["loss"]), after=after, after2=after2,
                nan_skip=dict(skipped=int(state.skipped_steps), unchanged=unchanged,
                              grad_norm=float(m3["grad_norm"])))


# --- pipeline parallelism ------------------------------------------------------


def _ce(logits, labels, mask):
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    mask = mask.float()
    return (nll * mask).sum() / mask.sum()


def _shift_case():
    """ppermute of fp32, bf16 and int8 tensors one rank forward along seq=4,
    its backward from a seeded gradient, and that gradient shifted back."""
    from vats_tpu_torch.parallel import collectives, create_mesh

    mesh = create_mesh(data=1, fsdp=1, expert=1, tensor=1, seq=4)
    g = torch.Generator().manual_seed(100 + mesh.axis_index("seq"))
    a = torch.randn(3, 5, generator=g).requires_grad_()
    b = torch.randn(2, 4, generator=g).bfloat16().requires_grad_()
    c = torch.randint(-100, 100, (7,), generator=g).to(torch.int8)
    ga, gb = torch.randn(3, 5, generator=g), torch.randn(2, 4, generator=g).bfloat16()
    collectives.reset_traffic()
    (oa, ob, oc), _ = collectives.ppermute([a, b, c], mesh, "seq")
    forward_bytes = collectives.traffic["bytes"]
    ((oa * ga).sum() + (ob.float() * gb.float()).sum()).backward()
    by_axis = dict(collectives.traffic["by_axis"])
    back = collectives.shift([ga, gb], mesh, "seq", -1)
    return dict(inputs=[x.detach().float().numpy() for x in (a, b, c)],
                outputs=[x.detach().float().numpy() for x in (oa, ob, oc)],
                int_grad=oc.requires_grad, grads=[a.grad.numpy(), b.grad.float().numpy()],
                back=[x.float().numpy() for x in back], forward_bytes=forward_bytes,
                by_axis=by_axis)


def _mlp_cases(p):
    """pipeline_apply of the tanh MLP over seq (data x seq = 4 ranks) at
    each (S, M): the output and this rank's block of the gradients of
    sum(out * gout)."""
    from vats_tpu_torch.parallel import create_mesh
    from vats_tpu_torch.parallel.pipeline import pipeline_apply

    def block(params, h):
        for w, b in zip(*params):
            h = torch.tanh(h @ w + b)
        return h

    out = {}
    for stages, m in p["cases"]:
        mesh = create_mesh(data=4 // stages, fsdp=1, expert=1, tensor=1, seq=stages)
        ws, bs = (torch.tensor(p[k]).requires_grad_() for k in ("ws", "bs"))
        x = torch.tensor(p["x"]).requires_grad_()
        y = pipeline_apply(block, (ws, bs), x, mesh=mesh, axis_name="seq", num_microbatches=m)
        (y * torch.tensor(p["gout"])).sum().backward()
        per = ws.shape[0] // stages
        sl = slice(mesh.axis_index("seq") * per, (mesh.axis_index("seq") + 1) * per)
        out[(stages, m)] = dict(out=y.detach().numpy(), layers=(sl.start, sl.stop),
                                gw=ws.grad.numpy(), gb=bs.grad.numpy(), gx=x.grad.numpy())
    return out


def _lm_cases(p):
    """pipeline_text_lm_apply of the tiny TextLM over seq, each case at
    its (S, M) and config overrides: logits, aux, the masked CE and its
    gradients (whole-model names), and the rank's resident parameter bytes.
    ``staged`` cases cut the model with stage_model first; the others pass
    the whole model."""
    from vats_tpu_torch.parallel import create_mesh
    from vats_tpu_torch.parallel.layout import tensor_bytes
    from vats_tpu_torch.parallel.pipeline import pipeline_text_lm_apply, stage_model

    ids, labels, mask = (torch.tensor(p[k]) for k in ("ids", "labels", "mask"))
    out = {}
    for case, (stages, m, staged, overrides) in p["cases"].items():
        mesh = create_mesh(data=4 // stages, fsdp=1, expert=1, tensor=1, seq=stages)
        model = _lm(dict(p["cfg"], **overrides), p["params"])
        lo = 0
        if staged:
            stage_model(model, mesh, "seq")
            lo = model.stage_layers.start
        logits, aux = pipeline_text_lm_apply(model, ids, mask, mesh=mesh, axis_name="seq",
                                             num_microbatches=m)
        loss = _ce(logits, labels, mask)
        loss.backward()
        grads = {}
        for name, prm in model.named_parameters():
            if prm.grad is None:
                continue
            if name.startswith("layers."):
                i, rest = name[len("layers."):].split(".", 1)
                name = f"layers.{int(i) + lo}.{rest}"
            grads[name] = prm.grad.numpy()
        out[case] = dict(logits=logits.detach().numpy(), aux=float(aux), loss=float(loss),
                         grads=grads, resident=tensor_bytes(dict(model.named_parameters())))
    return out


def _pipeline_train(p):
    """Five AdamW steps (optax.adamw(3e-3)'s arithmetic) through the pipe
    on data=2 x seq=2, M=4, the next-token loss of the JAX test: the losses,
    the replicated leaves' first gradients and their values after."""
    from vats_tpu_torch.parallel import create_mesh
    from vats_tpu_torch.parallel.pipeline import pipeline_text_lm_apply, stage_model
    from vats_tpu_torch.train.optimizer import AdamW

    mesh = create_mesh(data=2, fsdp=1, expert=1, tensor=1, seq=2)
    model = stage_model(_lm(p["cfg"], p["params"]), mesh, "seq")
    params = dict(model.named_parameters())
    tx = AdamW(lambda count: torch.tensor(3e-3), weight_decay=1e-4)
    opt = tx.init(params)
    ids = torch.tensor(p["train_ids"])
    losses, first = [], None
    for _ in range(5):
        for prm in params.values():
            prm.grad = None
        logits, _ = pipeline_text_lm_apply(model, ids, mesh=mesh, axis_name="seq",
                                           num_microbatches=4)
        loss = _ce(logits[:, :-1], ids[:, 1:], torch.ones_like(ids[:, 1:]))
        loss.backward()
        if first is None:
            first = {n: q.grad.numpy().copy() for n, q in params.items()
                     if not n.startswith("layers.")}
        with torch.no_grad():
            tx.update_(params, {n: q.grad for n, q in params.items()}, opt)
        losses.append(float(loss))
    after = {n: q.detach().numpy().copy() for n, q in params.items()
             if not n.startswith("layers.")}
    return dict(losses=losses, first_grads=first, replicated_after=after)


def _multihost_step(p):
    """The counterpart of tests/multihost_runner.py: this process's rows by
    host_shard_slice, the rank's block of the batch by make_global_batch,
    one make_sharded_train step on data=2 x fsdp=2."""
    from vats_tpu_torch.configs import TrainingArgs
    from vats_tpu_torch.parallel import create_mesh
    from vats_tpu_torch.parallel.multihost import (
        host_shard_slice,
        is_coordinator,
        make_global_batch,
    )
    from vats_tpu_torch.parallel.sharded import make_sharded_train

    mesh = create_mesh(data=2, fsdp=2, expert=1, tensor=1, seq=1)
    batch = {k: np.asarray(v) for k, v in p["batch"].items()}
    sl = host_shard_slice(len(batch["input_ids"]))
    block = make_global_batch(batch, mesh)
    rows_match = all(np.array_equal(block[k].numpy(), v[sl]) for k, v in batch.items())
    model = _lm(p["cfg"], p["params"])
    init, step, _ = make_sharded_train(model, TrainingArgs(grad_accum_steps=1), mesh, batch,
                                       num_training_steps=10)
    _, m = step(init(), batch, 2)
    return dict(loss=float(m["loss"]), coordinator=is_coordinator(),
                slice=(sl.start, sl.stop), rows_match=rows_match)


def pipeline_cases(rank, world, payload):
    """Joins the world through initialize_multihost, then: the ppermute
    case, the MLP and TextLM pipelines, five AdamW steps through the pipe,
    and the multihost sharded step."""
    from vats_tpu_torch.parallel.multihost import initialize_multihost

    initialize_multihost(payload["address"], world, rank, backend="gloo")
    out = dict(shift=_shift_case(), mlp=_mlp_cases(payload["mlp"]))
    out["lm"] = _lm_cases(payload["lm"])
    out["train"] = _pipeline_train(payload["lm"])
    out["multihost"] = _multihost_step(payload["multihost"])
    return out
