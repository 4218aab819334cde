"""K2' and K5: the port's plain LSE forward and flash backward against the
JAX kernels run in interpret mode, and the port's flash autograd against
``jax.grad`` of the JAX flash attention.

fp32 on both sides.  Outputs, logsumexps and gradients: atol 5e-5, rtol
5e-4, as tests/test_flash_attention.py holds the JAX flash gradients to its
oracle (online vs two-pass softmax, sums in another order)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vats_tpu.ops.flash_attention import (
    _flash_bwd_kernels,
    _flash_forward,
    flash_attention as j_flash,
)
from vats_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_lse,
    flash_attention_lse_ref,
)

torch.set_num_threads(1)

TOL = dict(atol=5e-5, rtol=5e-4)

CASES = {
    "causal_gqa3": dict(causal=True),
    "causal_window": dict(causal=True, left_window=11),
    "bidirectional_window": dict(causal=False, left_window=9, right_window=4),
    "padding_dead_rows": dict(causal=True, valid=True),
    "segments": dict(causal=True, segments=True),
    "q_offset": dict(causal=True, q_pos_offset=16, s=64),
    "mqa_no_mask": dict(causal=False, g=1),
}


def _inputs(name, case):
    rs = np.random.RandomState(sum(map(ord, name)))
    b, t, hq, hd = 2, 48, 6, 60
    g = case.get("g", 2)
    s = case.get("s", t)
    arr = lambda *shape: rs.randn(*shape).astype(np.float32)  # noqa: E731
    q, k, v, do = arr(b, t, hq, hd), arr(b, s, g, hd), arr(b, s, g, hd), arr(b, t, hq, hd)
    kw = dict(scale=hd**-0.5, causal=case["causal"],
              left_window=case.get("left_window", -1),
              right_window=case.get("right_window", -1),
              q_pos_offset=case.get("q_pos_offset", 0))
    valid = np.ones((b, s), bool)
    q_seg, kv_seg = np.zeros((b, t), np.int32), np.zeros((b, s), np.int32)
    if case.get("valid"):
        valid = rs.rand(b, s) > 0.25
        valid[1, :5] = False  # causal rows 0..4 of batch row 1 attend nothing
    if case.get("segments"):
        q_seg = kv_seg = np.repeat(np.array([[0, 1, 2], [0, 0, 1]]), 16, axis=1).astype(np.int32)
    return (q, k, v, do), kw, valid, q_seg, kv_seg


def _jax_layout(x):  # [B, T, H, D] -> [B, H, T, D]
    return jnp.asarray(np.transpose(x, (0, 2, 1, 3)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_lse_forward_and_backward_match_jax_kernels_interpret(name):
    case = CASES[name]
    (q, k, v, do), kw, valid, q_seg, kv_seg = _inputs(name, case)
    use_segids = bool(case.get("segments"))
    t = q.shape[1]
    jargs = (_jax_layout(q), _jax_layout(k), _jax_layout(v), jnp.asarray(valid, jnp.int32),
             jnp.asarray(q_seg), jnp.asarray(kv_seg))
    jo, jlse = _flash_forward(
        *jargs, kw["scale"], kw["causal"], kw["left_window"], kw["right_window"],
        16, 16, True, use_segids, return_lse=True, q_pos_offset=kw["q_pos_offset"])
    tseg = dict(q_segment_ids=torch.from_numpy(q_seg), kv_segment_ids=torch.from_numpy(kv_seg)) \
        if use_segids else {}
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    tvalid = torch.from_numpy(valid)
    o, lse = flash_attention_lse_ref(tq, tk, tv, kv_valid=tvalid, **tseg, **kw)
    np.testing.assert_allclose(o.numpy(), np.transpose(np.asarray(jo), (0, 2, 1, 3)), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :, 0, :t], **TOL)
    if case.get("valid"):
        np.testing.assert_array_equal(lse.numpy()[1, :, :5], np.float32(1e30))
        np.testing.assert_array_equal(o.numpy()[1, :5], 0.0)
    # the public K2' entry is the plain version on CPU tensors
    o2, lse2 = flash_attention_lse(tq, tk, tv, kv_valid=tvalid, **tseg, **kw)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)

    di = (tdo * o).sum(-1).transpose(1, 2).contiguous()  # [B, Hq, T]
    jdq, jdk, jdv = _flash_bwd_kernels(
        jargs[0], jargs[1], jargs[2], _jax_layout(do), jnp.asarray(lse.numpy()),
        jnp.asarray(di.numpy()), *jargs[3:], scale=kw["scale"], causal=kw["causal"],
        left_window=kw["left_window"], right_window=kw["right_window"],
        block_q=16, block_k=16, interpret=True, use_segids=use_segids,
        q_pos_offset=kw["q_pos_offset"])
    segs = (tseg.get("q_segment_ids"), tseg.get("kv_segment_ids"))
    dq, dk, dv = flash_attention_bwd_ref(tq, tk, tv, tdo, lse, di, tvalid, *segs, **kw)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.transpose(np.asarray(want), (0, 2, 1, 3)),
                                   **TOL)
    got2 = flash_attention_bwd(tq, tk, tv, tdo, lse, di, tvalid, *segs, **kw)
    for a, b_ in zip(got2, (dq, dk, dv)):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_bf16_backward_matches_jax_kernels_interpret(name):
    """bf16 inputs: the plain backward follows the JAX kernels' arithmetic
    (bf16 products summed in fp32, ds from the fp32 p, p rounded to bf16
    before dV and ds before dK and dQ).  Both sides round the same fp32
    values, so they differ where a sum taken in another order flips one
    rounding: one bf16 ulp (2^-8) of a p or ds times an input of |x| <= ~4.
    Tolerance 3e-3 absolute, 1e-3 relative (measured up to 2.4e-3, most
    cases ~1e-6), and a mean error of 2e-5 for the rounding as a whole.
    Without the rounding the plain backward sits 2.9e-3 to 1.2e-2 from the
    JAX kernels (mean ~1e-3)."""
    case = CASES[name]
    (q, k, v, do), kw, valid, q_seg, kv_seg = _inputs(name, case)
    use_segids = bool(case.get("segments"))
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do))
    tvalid = torch.from_numpy(valid)
    tseg = dict(q_segment_ids=torch.from_numpy(q_seg), kv_segment_ids=torch.from_numpy(kv_seg)) \
        if use_segids else {}
    o, lse = flash_attention_lse_ref(tq, tk, tv, kv_valid=tvalid, **tseg, **kw)
    di = (tdo.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    jq, jk, jv, jdo = (jnp.asarray(_jax_layout(x.float().numpy()), dtype=jnp.bfloat16)
                       for x in (tq, tk, tv, tdo))
    jgrads = _flash_bwd_kernels(
        jq, jk, jv, jdo, jnp.asarray(lse.numpy()), jnp.asarray(di.numpy()),
        jnp.asarray(valid, jnp.int32), jnp.asarray(q_seg), jnp.asarray(kv_seg),
        scale=kw["scale"], causal=kw["causal"], left_window=kw["left_window"],
        right_window=kw["right_window"], block_q=16, block_k=16, interpret=True,
        use_segids=use_segids, q_pos_offset=kw["q_pos_offset"])
    segs = (tseg.get("q_segment_ids"), tseg.get("kv_segment_ids"))
    got = flash_attention_bwd_ref(tq, tk, tv, tdo, lse, di, tvalid, *segs, **kw)
    for a, want in zip(got, jgrads):
        assert a.dtype == torch.float32
        want = np.transpose(np.asarray(want, dtype=np.float32), (0, 2, 1, 3))
        np.testing.assert_allclose(a.numpy(), want, atol=3e-3, rtol=1e-3)
        assert float(np.abs(a.numpy() - want).mean()) <= 2e-5


def _grads_both(q, k, v, jax_kw, torch_kw, jax_fn):
    def loss(q_, k_, v_):
        return jnp.sum(jax_fn(q_, k_, v_, **jax_kw) ** 2)

    jg = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(tq, tk, tv, **torch_kw)
    tg = torch.autograd.grad((out ** 2).sum(), (tq, tk, tv))
    return jg, tg


GRAD_CASES = {
    # tests/test_flash_attention.py:88 (causal + window, GQA)
    "causal_window": (1, 32, 32, 4, 2, dict(causal=True, left_window=9), False),
    # tests/test_flash_attention.py:187 (segments)
    "segments": (1, 32, 32, 4, 1, dict(causal=True), True),
    # head dim 60: padded to 64 outside the autograd Function
    "head_dim_60": (2, 40, 60, 4, 2, dict(causal=True, left_window=17), False),
    # tests/test_flash_attention.py:210 (no mask at all, one long row block)
    "bidirectional": (1, 96, 32, 2, 1, dict(causal=False), False),
}


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_flash_autograd_matches_jax_grad(name):
    b, t, d, hq, g, kw, segments = GRAD_CASES[name]
    rs = np.random.RandomState(len(name))
    q = rs.randn(b, t, hq, d).astype(np.float32)
    k = rs.randn(b, t, g, d).astype(np.float32)
    v = rs.randn(b, t, g, d).astype(np.float32)
    kw = dict(scale=1.0 / np.sqrt(d), **kw)
    jkw, tkw = dict(kw), dict(kw)
    if segments:
        seg = np.concatenate([np.zeros(13), np.ones(t - 13)])[None].astype(np.int32)
        jkw["q_segment_ids"] = jkw["kv_segment_ids"] = jnp.asarray(seg)
        tkw["q_segment_ids"] = tkw["kv_segment_ids"] = torch.from_numpy(seg)
    jfn = functools.partial(j_flash, interpret=True, block_q=16, block_k=16)
    jg, tg = _grads_both(q, k, v, jkw, tkw, jfn)
    for a, b_ in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), **TOL)
