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
    """Each case: ring or Ulysses attention over this rank's
    shard of seeded whole inputs; returns {name: {out, dq, dk, dv}} of the
    rank's shard (gradients where the case asks, from ``do``)."""
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
        if c.get("expect_error"):
            n0 = collectives.traffic["calls"]
            try:
                fn(q, k, v, **kw)
            except ValueError as e:
                out[c["name"]] = dict(error=str(e), calls=collectives.traffic["calls"] - n0)
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
        out[c["name"]] = res
    return out


def _lm_batch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def sp_train_steps(rank, world, payload):
    """The sequence-parallel train step of a tiny TextLM on a data x seq
    mesh, one case per (context_parallel, remat); returns each case's
    metrics and (rank 0) global gradients, with every rank's gradient
    checksum.  Also the errors that a capacity-limited MoE and an FSDP mesh
    must raise."""
    from vats_tpu_torch.configs import ModelArgs, TrainingArgs
    from vats_tpu_torch.models import TextLM
    from vats_tpu_torch.parallel import create_mesh
    from vats_tpu_torch.parallel.sharded import make_sharded_train

    targs = TrainingArgs(grad_accum_steps=1)
    batch = _lm_batch(payload["batch"])
    mesh = _seq_mesh(world, data=payload["data"])
    out = {}
    for name, overrides in payload["cases"].items():
        cfg = ModelArgs(**dict(payload["cfg"], **overrides))
        model = TextLM(cfg, device="meta")
        model.load_state_dict({k: torch.tensor(v) for k, v in payload["params"].items()},
                              assign=True)
        init, step, _ = make_sharded_train(model, targs, mesh, batch, num_training_steps=10)
        state = init()
        if cfg.capacity_factor > 0:
            try:
                step(state, batch, 2)
            except NotImplementedError as e:
                out[name] = dict(error=str(e))
            else:
                out[name] = dict(error=None)
            continue
        state, m = step(state, batch, 2)
        grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
        res = {k: float(v) for k, v in m.items()}
        res["checksum"] = float(sum(g.double().sum() for g in grads.values()))
        if rank == 0:
            res["grads"] = {n: g.numpy() for n, g in grads.items()}
        out[name] = res
    try:
        make_sharded_train(TextLM(ModelArgs(**payload["cfg"]), device="meta"), targs,
                           create_mesh(data=1, fsdp=2, expert=1, tensor=1,
                                       seq=world // 2), batch)
    except NotImplementedError as e:
        out["fsdp_error"] = str(e)
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
