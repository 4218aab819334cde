"""Port nn core against vats_tpu: RMSNorm, L2 norm, RoPE, the plain attention
(``ops/attention_ref`` vs ``ops/attention_xla``) and the MoE layer.

Inputs are made from a seed with numpy and fed to both packages in fp32.
Tolerances: 1e-5 for elementwise fp32 math (the same operations in another
library), 2e-5 absolute for attention and MoE outputs (fp32 sums of up to a
few hundred terms taken in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import meta

from vats_tpu.nn import RMSNorm as JRMSNorm
from vats_tpu.nn import apply_rope_1d as j_rope
from vats_tpu.nn import l2_normalize as j_l2
from vats_tpu.nn.moe import MoELayer as JMoELayer
from vats_tpu.ops import attention_xla as jattn
from vats_tpu_torch.nn import MoELayer, RMSNorm, apply_rope_1d, l2_normalize
from vats_tpu_torch.ops import attention_ref as tattn

torch.set_num_threads(1)


def t(x):
    return torch.from_numpy(np.asarray(x))


def test_rms_norm_matches_formula_and_jax():
    d = 32
    x = np.random.RandomState(0).randn(2, 5, d).astype(np.float32)
    w = np.random.RandomState(1).rand(d).astype(np.float32) + 0.5
    layer = RMSNorm(d, eps=1e-7)
    with torch.no_grad():
        layer.weight.copy_(t(w))
        out = layer(t(x)).numpy()
    expected = w * x / np.sqrt((x**2).mean(-1, keepdims=True) + 1e-7)
    np.testing.assert_allclose(out, expected, rtol=1e-5, atol=1e-5)
    jl = JRMSNorm(features=d, eps=1e-7)
    jout = jl.apply({"params": {"weight": jnp.asarray(w)}}, jnp.asarray(x))
    np.testing.assert_allclose(out, np.asarray(jout), rtol=1e-5, atol=1e-6)


def test_rope_preserves_norm_position0_identity_and_matches_jax():
    x = np.random.RandomState(2).randn(2, 6, 4, 8).astype(np.float32)
    out = apply_rope_1d(t(x), torch.arange(6), theta=10000.0).numpy()
    np.testing.assert_allclose(
        np.linalg.norm(out, axis=-1), np.linalg.norm(x, axis=-1), rtol=1e-5
    )
    np.testing.assert_allclose(out[:, 0], x[:, 0], rtol=1e-6, atol=1e-6)
    jout = j_rope(jnp.asarray(x), jnp.arange(6), 10000.0)
    np.testing.assert_allclose(out, np.asarray(jout), rtol=1e-5, atol=1e-5)
    # per-row [B, T] positions (ragged paged decode)
    pos = np.array([[3, 4, 5, 6, 7, 8], [0, 1, 2, 3, 4, 5]])
    out2 = apply_rope_1d(t(x), t(pos), theta=500.0).numpy()
    jout2 = j_rope(jnp.asarray(x), jnp.asarray(pos), 500.0)
    np.testing.assert_allclose(out2, np.asarray(jout2), rtol=1e-5, atol=1e-5)


def test_rope_relative_positions():
    rs = np.random.RandomState(3)
    q = t(rs.randn(1, 1, 1, 8).astype(np.float32))
    k = t(rs.randn(1, 1, 1, 8).astype(np.float32))

    def score(qi, kj):
        qq = apply_rope_1d(q, torch.tensor([qi]), 100.0)
        kk = apply_rope_1d(k, torch.tensor([kj]), 100.0)
        return float((qq * kk).sum())

    assert abs(score(5, 3) - score(7, 5)) < 1e-4
    assert abs(score(2, 2) - score(9, 9)) < 1e-4


def test_l2_normalize_matches_jax_including_zero_vectors():
    x = np.random.RandomState(4).randn(2, 3, 4, 8).astype(np.float32)
    x[0, 0, 0] = 0.0
    out = l2_normalize(t(x)).numpy()
    np.testing.assert_allclose(np.linalg.norm(out[1], axis=-1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(out, np.asarray(j_l2(jnp.asarray(x))), rtol=1e-6,
                               atol=1e-7)


ATTN_CASES = [
    dict(causal=True),
    dict(causal=True, left_window=3),
    dict(causal=False, left_window=2, right_window=1),
    dict(causal=False, valid=True),
    dict(causal=True, segments=True),
    dict(causal=True, valid=True, dead_row=True),  # a row with no valid key
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_dot_product_attention_matches_jax(case):
    rs = np.random.RandomState(5)
    b, tq, hq, g, hd = 2, 9, 4, 2, 12
    q = rs.randn(b, tq, hq, hd).astype(np.float32)
    k = rs.randn(b, tq, g, hd).astype(np.float32)
    v = rs.randn(b, tq, g, hd).astype(np.float32)
    kw = dict(scale=0.3, causal=case["causal"],
              left_window=case.get("left_window", -1),
              right_window=case.get("right_window", -1))
    jkw, tkw = dict(kw), dict(kw)
    if case.get("valid"):
        valid = rs.rand(b, tq) > 0.3
        if case.get("dead_row"):
            valid[1] = False
        jkw["kv_valid"], tkw["kv_valid"] = jnp.asarray(valid), t(valid)
    if case.get("segments"):
        seg = np.array([[0] * 4 + [1] * 5, [0] * 2 + [1] * 7], np.int32)
        for d, f in ((jkw, jnp.asarray), (tkw, t)):
            d["q_segment_ids"] = d["kv_segment_ids"] = f(seg)
    ref = jattn.dot_product_attention(*map(jnp.asarray, (q, k, v)), **jkw)
    out = tattn.dot_product_attention(t(q), t(k), t(v), **tkw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)


def test_cached_decode_attention_and_mask_match_jax():
    rs = np.random.RandomState(6)
    b, tq, hq, g, hd, s = 2, 3, 4, 2, 16, 20
    q = rs.randn(b, tq, hq, hd).astype(np.float32)
    kt = rs.randn(b, g, hd, s).astype(np.float32)
    vt = rs.randn(b, g, hd, s).astype(np.float32)
    qpos = np.array([[7, 8, 9], [4, 5, 6]])
    valid = np.arange(s)[None, :] < np.array([[10], [7]])
    kw = dict(scale=0.25, causal=True, left_window=5)
    ref = jattn.cached_decode_attention(
        *map(jnp.asarray, (q, kt, vt)), q_positions=jnp.asarray(qpos),
        kv_positions=jnp.arange(s), kv_valid=jnp.asarray(valid), **kw)
    out = tattn.cached_decode_attention(
        t(q), t(kt), t(vt), q_positions=t(qpos), kv_positions=torch.arange(s),
        kv_valid=t(valid), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)
    jm = jattn.make_attention_mask(jnp.asarray(qpos), jnp.arange(s), causal=False,
                                   left_window=2, right_window=3,
                                   kv_valid=jnp.asarray(valid))
    tm = tattn.make_attention_mask(t(qpos), torch.arange(s), causal=False,
                                   left_window=2, right_window=3, kv_valid=t(valid))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def _port_moe_from_jax(jparams, **kw):
    p = jax.tree_util.tree_map(np.asarray, meta.unbox(jparams))["params"]
    layer = MoELayer(**kw)
    sd = {
        "norm.weight": p["RMSNorm_0"]["weight"],
        "router.router.weight": p["TopKRouter_0"]["router"].T,
        "router.router.bias": p["TopKRouter_0"]["router_bias"],
        "experts.w_gate": p["ExpertSwiGLU_0"]["w_gate"],
        "experts.w_up": p["ExpertSwiGLU_0"]["w_up"],
        "experts.w_down": p["ExpertSwiGLU_0"]["w_down"],
    }
    layer.load_state_dict({k: torch.tensor(np.array(v)) for k, v in sd.items()})
    return layer


@pytest.mark.parametrize(
    "dispatch,n_tok,cf",
    [
        ("dense", 24, 1.25),
        ("scatter", 24, 1.25),
        ("sort", 24, 1.25),
        ("scatter", 40, 0.5),  # capacity binds hard: many drops
        ("sort", 40, 0.5),
        ("auto", 2048, 1.25),  # past 2^24 one-hot elements: 'sort'
    ],
)
def test_moe_layer_matches_jax_with_capacity(dispatch, n_tok, cf):
    d, f, e, k = 16, 32, 4, 2
    kw = dict(d_model=d, d_ffn=f, num_experts=e, top_k=k, capacity_factor=cf,
              dispatch=dispatch)
    x = np.random.RandomState(7).randn(1, n_tok, d).astype(np.float32)
    jl = JMoELayer(**kw)
    params = jl.init(jax.random.PRNGKey(8), jnp.asarray(x))
    ref, _ = jl.apply(params, jnp.asarray(x))
    layer = _port_moe_from_jax(params, **kw)
    if dispatch == "auto":
        assert layer.dispatch_mode(n_tok) == "sort"
    with torch.no_grad():
        out, aux = layer(t(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)
    # capacity binding really dropped assignments in the hard case
    if cf < 1.0:
        assert layer._capacity(n_tok) < n_tok * k / e


def test_moe_auto_mode_selection_mirrors_jax_rule():
    layer = MoELayer(d_model=8, d_ffn=8, num_experts=8, top_k=2,
                     capacity_factor=1.25)
    assert MoELayer(d_model=8, d_ffn=8, num_experts=2, top_k=1).dispatch_mode(99) == "dense"
    assert layer.dispatch_mode(16) == "scatter"  # one decode step, B=16
    assert layer.dispatch_mode(16 * 512) == "sort"  # the B=16 x 512 prefill
    assert layer._capacity(16) == 8 and layer._capacity(8192) == 2560
