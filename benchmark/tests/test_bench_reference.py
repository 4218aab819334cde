"""The plain reference equals the port's TextLM at a tiny size on the CPU,
in fp32: the forward's logits, and one training step with dropout,
capacity drops, segments, the fused CE, clipping and AdamW (with and
without accumulation)."""

import torch
import pytest

from benchmark import traffic as tr
from benchmark.drivers import train
from benchmark.reference.model import Reference
from benchmark.tests import tiny
from benchmark.weights import make_params


def _port_model(m, seed):
    from vats_tpu_torch.configs.nlp import ModelArgs
    from vats_tpu_torch.models.text_lm import TextLM

    model = TextLM(ModelArgs(**m), device="meta")
    model.load_state_dict(make_params(m, seed, torch.float32, "cpu"), assign=True)
    return model


@pytest.mark.parametrize("capacity", [-1.0, 1.25])
def test_forward_logits_equal_the_port(capacity):
    ctx = tiny.serve_ctx("closed_loop", "medium_e8.decode_heavy")
    m = dict(ctx.config["model"], capacity_factor=capacity)
    seed = 31337
    ids = torch.randint(1, m["vocab_size"], (1, 300), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, _, _ = _port_model(m, seed).eval()(ids)
    got = Reference(m, make_params(m, seed, torch.float32, "cpu")).logits(ids[0])
    torch.testing.assert_close(got, want[0], rtol=1e-4, atol=1e-5)


def test_weights_load_into_the_port_by_name():
    ctx = tiny.train_ctx("lm_rows", "medium_moe.train_short_512")
    m = ctx.config["model"]
    model = _port_model(m, 5)
    assert {n for n, _ in model.named_parameters()} == set(make_params(m, 5, torch.float32, "cpu"))


@pytest.mark.parametrize("kind,cell", [("lm_rows", "medium_moe.train_short_512"),
                                       ("lm_packed", "medium_moe.train_packed_2k")])
def test_train_steps_equal_the_port(kind, cell):
    ctx = tiny.train_ctx(kind, cell)
    out = train.run(ctx)
    nums = dict(out["info"]["not_compared"], **{k: v["value"] for k, v in out["checks"].items()})
    assert nums["loss_rel_gap"] < 1e-6, nums
    assert nums["grad_median_leaf_gap"] < 1e-4, nums
    assert nums["change_leaf_gap"] < 1e-3, nums
    assert out["failed"] == 0 and out["attempted"] > 0


def test_reference_drops_what_capacity_drops():
    # a capacity of 8 slots over 32 tokens routed top-2 to 4 experts drops
    # assignments: the reference's output differs from the lossless one
    ctx = tiny.train_ctx("lm_rows", "medium_moe.train_short_512")
    m = dict(ctx.config["model"], capacity_factor=0.5)
    p = make_params(m, 9, torch.float32, "cpu")
    x = torch.randn(32, m["d_model"], generator=torch.Generator().manual_seed(0))
    lossy, _ = Reference(m, p).moe(x, 0, train=False)
    full, _ = Reference(dict(m, capacity_factor=-1.0), p).moe(x, 0, train=False)
    assert not torch.allclose(lossy, full)
    assert tr.IGNORE_INDEX == -100


def test_frozen_sampling_rule_equals_the_port():
    # the draw and the set of the port's per-request rule, at the serving
    # cell's knobs and at others, over logits with ties and a flat tail
    from vats_tpu_torch.inference.sampling import keyed_uniform, sample_logits_per_row

    from benchmark.reference import sampling as ref

    g = torch.Generator().manual_seed(3)
    logits = torch.randn(40, 300, generator=g) * 3
    logits[:5, :10] = 1.5  # ties among the top
    pos = torch.arange(1000, 1040)
    for t, k, p in ((0.7, 50, 0.95), (1.0, 0, 0.9), (0.5, 10, 0.0), (1.3, 64, 0.5)):
        for seed in (0, 12345, 2**32 - 1):
            want = sample_logits_per_row(
                None, logits, temperature=torch.full((40,), t), top_k=torch.full((40,), k),
                top_p=torch.full((40,), p), row_seeds=torch.full((40,), seed),
                positions=pos, kmax=64)
            got = ref.draw(logits, t, k, p, 64, seed, pos)
            assert torch.equal(got, want.long())
            floor = ref.set_floor(logits, t, k, p, 64)
            assert (logits.gather(1, got[:, None])[:, 0] >= floor).all()
        assert torch.equal(ref.keyed_uniform(seed, pos, 64),
                           keyed_uniform(torch.full((40,), seed), pos, 64))
