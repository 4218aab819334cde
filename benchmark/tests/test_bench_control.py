"""On the card: the control fails the cell's check, at the cell's own size.

The control of a training cell is the plain reference computed with every
product's operands in fp8 (the nearest precision below the configuration's
bf16); half of every batch left out is a fault the check must catch too.
The control of a serving cell is the same reference held in fp8, put in the
program's place at the positions of the served tokens: its argmax where a
request is greedy, its own draw by the request's rule where it samples.
Each control has to fail at least one of the cell's numbers.  Run with ``python -m pytest -m cuda benchmark/tests``.
"""


import pytest

SEED = 2**31 + 777


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the cell's own size)")


def _fails(nums, limits):
    """One of the numbers the cell compares is over its limit."""
    return any(v > limits[k] for k, v in nums.items() if k in limits)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["medium_moe.train_short_512", "medium_moe.train_packed_2k"])
def test_training_control_and_half_batch_fail(card, workload):
    from benchmark.control import train_readings
    from benchmark.run import make_ctx

    _, ctx = make_ctx(workload, SEED, 0.0)
    row = train_readings(workload, SEED)
    assert _fails(row["fp8"], ctx.limits), row
    assert _fails(row["half_batch"], ctx.limits), row


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["medium_e8.decode_heavy"])
def test_serving_control_fails(card, workload):
    from benchmark.control import serve_readings
    from benchmark.run import make_ctx

    _, ctx = make_ctx(workload, SEED, 10.0)
    row = serve_readings(workload, SEED, 10.0)
    for name in ("mean_logit_gap", "sampled_set_gap"):
        assert row[f"program_{name}"] <= ctx.limits[name], row
    assert _fails({k: row[f"control_{k}"] for k in ctx.limits}, ctx.limits), row
