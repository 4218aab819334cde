"""The routed-row MoE path (``nn/moe.py``'s 'routed' mode over
``ops/moe_grouped.py``) on the CPU, where K7's plain versions run.

The oracle is the scatter dispatch at lossless capacity (every token in
every expert's buffer): the routed path runs the same experts over the
routed rows alone, so the two agree within fp32 rounding.  The JAX
package's lossless layer is the reference besides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import meta

from vats_tpu.nn.moe import MoELayer as JMoELayer
from vats_tpu_torch.nn import MoELayer
from vats_tpu_torch.nn.moe import _sorted_positions
from vats_tpu_torch.ops import moe_grouped as mg


def layer_and_input(n, e, k, d, f, seed=0, skew=False, **kw):
    layer = MoELayer(d, f, e, k, device="cpu", **kw)
    layer.reset_parameters(torch.Generator().manual_seed(seed))
    x = torch.randn((1, n, d), generator=torch.Generator().manual_seed(seed + 1))
    if skew:  # the router's bias sends every token to experts 1..k, the rest get none
        with torch.no_grad():
            layer.router.router.bias[1:k + 1] = 50.0
    return layer, x


# (n tokens, E, k, d, f): decode_heavy's E8 top-2 and code_chat_8k's E64
# top-8 at small widths; one token, a decode step's 64 rows, and 100 (not a
# multiple of K7's 64- or 128-row tiles); 'skew': experts left without rows
ROUTED_CASES = {
    "e8k2_n1": (1, 8, 2, 32, 48, False),
    "e8k2_n64": (64, 8, 2, 32, 48, False),
    "e8k2_n100": (100, 8, 2, 32, 48, False),
    "e8k2_n100_skew": (100, 8, 2, 32, 48, True),
    "e64k8_n1": (1, 64, 8, 16, 24, False),
    "e64k8_n64": (64, 64, 8, 16, 24, False),
    "e64k8_n100": (100, 64, 8, 16, 24, False),
    "e64k8_n100_skew": (100, 64, 8, 16, 24, True),
}


@pytest.mark.parametrize("name", sorted(ROUTED_CASES))
def test_routed_path_equals_the_lossless_scatter_oracle(name):
    n, e, k, d, f, skew = ROUTED_CASES[name]
    layer, x = layer_and_input(n, e, k, d, f, skew=skew)
    with torch.no_grad():
        out, _ = layer(x)
        flat = layer.norm(x).reshape(n, d)
        weights, indices, _ = layer.router(flat)
        want, _ = layer._scatter_dispatch(flat, weights, indices, n, layer.experts)
    assert layer.mode_calls == {"routed": 1}
    counts = torch.bincount(indices.reshape(-1), minlength=e)
    if skew or n == 1:
        assert int((counts == 0).sum()) > 0  # some experts receive no rows
    torch.testing.assert_close(out.reshape(n, d), want, atol=1e-6, rtol=1e-5)


def test_route_plan_is_the_stable_sort_by_expert():
    """Rows expert by expert in slot-major order (``_sorted_positions``'s
    order), each row's token and weight, and ``inv`` the row of each
    slot-major assignment."""
    g = torch.Generator().manual_seed(3)
    n, e, k = 37, 8, 3
    indices = torch.stack([torch.randperm(e, generator=g)[:k] for _ in range(n)])
    weights = torch.rand((n, k), generator=g)
    plan = mg.route_plan(indices, weights, e)
    order, sorted_ids, _ = _sorted_positions(indices.transpose(0, 1).reshape(n * k), e)
    assert torch.equal(plan.row_tok.long(), order % n)
    assert torch.equal(plan.counts.long(), torch.bincount(sorted_ids, minlength=e))
    assert torch.equal(plan.row_w, weights.transpose(0, 1).reshape(n * k)[order])
    assert torch.equal(order[plan.inv.long()], torch.arange(n * k))


def test_grouped_gemm_and_combine_round_once():
    """bf16: K7a's SiLU and product and K7b's weight run on the fp32
    products and round once; the combine sums each token's rows in fp32
    slot by slot and rounds once."""
    g = torch.Generator().manual_seed(4)
    rows = torch.randn((10, 16), generator=g).to(torch.bfloat16)
    counts = torch.tensor([4, 0, 6], dtype=torch.int32)
    wg, wu = (torch.randn((3, 16, 8), generator=g).to(torch.bfloat16) for _ in range(2))
    wd = torch.randn((3, 8, 16), generator=g).to(torch.bfloat16)
    h = mg.moe_grouped_gemm(rows, counts, wg, w_up=wu)
    for s, c, ex in ((0, 4, 0), (4, 6, 2)):
        x32 = rows[s:s + c].float()
        want = torch.nn.functional.silu(x32 @ wg[ex].float()) * (x32 @ wu[ex].float())
        assert torch.equal(h[s:s + c], want.to(torch.bfloat16))
    row_w = torch.rand(10, generator=g)
    y = mg.moe_grouped_gemm(h, counts, wd, row_w=row_w)
    assert torch.equal(y[4:], ((h[4:].float() @ wd[2].float()) * row_w[4:, None]).to(
        torch.bfloat16))
    inv = torch.randperm(10, generator=g).to(torch.int32)
    out = mg.combine_rows(y, inv, 5, 2)
    assert torch.equal(out, (y[inv[:5].long()].float() + y[inv[5:].long()].float()).to(
        torch.bfloat16))
    with pytest.raises(ValueError, match="w_up"):
        mg.moe_grouped_gemm(rows, counts, wg)


def test_auto_resolves_to_routed_only_when_lossless_single_rank_and_grad_free():
    layer, x = layer_and_input(20, 8, 2, 16, 24)
    with torch.no_grad():
        layer(x)  # lossless, one rank, no grad: routed
        layer.capacity_factor = 1.25
        layer(x)  # capacity-limited: the JAX rule ('scatter' at 20 tokens)
        layer.capacity_factor = -1.0
        for mode in ("scatter", "sort", "dense"):
            layer.dispatch = mode
            layer(x)
        layer.dispatch = "auto"
    layer(x)  # gradients on (training): the JAX rule
    assert layer.mode_calls == {"routed": 1, "scatter": 3, "sort": 1, "dense": 1}
    assert layer.resolve_mode(20, x[0]) == "scatter"  # grad on
    with torch.no_grad():
        assert layer.resolve_mode(20, x[0]) == "routed"
        assert layer.resolve_mode(20, x[0], ep=2) == "scatter"
        assert layer.resolve_mode(20, x[0], tok=object()) == "scatter"
    # dispatch_mode keeps the JAX package's rule
    assert layer.dispatch_mode(20) == "scatter"


def test_routed_layer_keeps_its_gradient_free_record():
    layer, x = layer_and_input(12, 8, 2, 16, 24)
    layer.record_routing = True
    with torch.no_grad():
        layer(x)
    assert layer.routing["keep"].shape == (2, 12) and bool(layer.routing["keep"].all())
    assert layer.routing["experts"].shape == (12, 2)


def test_routed_layer_matches_jax_lossless():
    """The lossless layer (JAX's 'auto' at capacity -1) against the port's
    routed path over the same weights, fp32."""
    d, f, e, k, n = 16, 32, 8, 2, 40
    kw = dict(d_model=d, d_ffn=f, num_experts=e, top_k=k, capacity_factor=-1.0)
    x = np.random.RandomState(9).randn(2, n // 2, d).astype(np.float32)
    jl = JMoELayer(**kw)
    params = jl.init(jax.random.PRNGKey(10), jnp.asarray(x))
    ref, _ = jl.apply(params, jnp.asarray(x))
    p = jax.tree_util.tree_map(np.asarray, meta.unbox(params))["params"]
    layer = MoELayer(**kw)
    sd = {
        "norm.weight": p["RMSNorm_0"]["weight"],
        "router.router.weight": p["TopKRouter_0"]["router"].T,
        "router.router.bias": p["TopKRouter_0"]["router_bias"],
        "experts.w_gate": p["ExpertSwiGLU_0"]["w_gate"],
        "experts.w_up": p["ExpertSwiGLU_0"]["w_up"],
        "experts.w_down": p["ExpertSwiGLU_0"]["w_down"],
    }
    layer.load_state_dict({name: torch.tensor(np.array(v)) for name, v in sd.items()})
    with torch.no_grad():
        out, _ = layer(torch.from_numpy(x))
    assert layer.mode_calls == {"routed": 1}
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)
