"""K2's plain version against the JAX flash kernel run in interpret mode.

Covers causal, sliding windows, key padding (with a row that attends no key,
which the kernel outputs as 0), segment ids, head dim 60 (the medium tier's,
zero-padded inside the JAX kernel) and q_pos_offset.  fp32 on both sides;
tolerance 2e-5 absolute (online vs two-pass softmax, sums in another
order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vats_tpu.ops.flash_attention import flash_attention as j_flash
from vats_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref

torch.set_num_threads(1)

CASES = {
    "causal": dict(causal=True),
    "causal_window": dict(causal=True, left_window=17),
    "bidirectional_window": dict(causal=False, left_window=9, right_window=4),
    "padding_dead_row": dict(causal=True, valid=True),
    "segments": dict(causal=True, segments=True),
    "q_offset": dict(causal=True, q_pos_offset=24, s=96),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_flash_matches_jax_kernel_interpret(name):
    case = CASES[name]
    rs = np.random.RandomState(len(name))
    b, t, hq, g, hd = 2, 72, 6, 2, 60
    s = case.get("s", t)
    q = rs.randn(b, t, hq, hd).astype(np.float32)
    k = rs.randn(b, s, g, hd).astype(np.float32)
    v = rs.randn(b, s, g, hd).astype(np.float32)
    kw = dict(scale=hd**-0.5, causal=case["causal"],
              left_window=case.get("left_window", -1),
              right_window=case.get("right_window", -1),
              q_pos_offset=case.get("q_pos_offset", 0))
    jkw, tkw = dict(kw), dict(kw)
    if case.get("valid"):
        valid = rs.rand(b, s) > 0.25
        valid[1, :5] = False  # queries 0..4 of row 1 attend nothing causally
        jkw["kv_valid"], tkw["kv_valid"] = jnp.asarray(valid), torch.from_numpy(valid)
    if case.get("segments"):
        seg = np.repeat(np.array([[0, 1, 2], [0, 0, 1]]), 24, axis=1).astype(np.int32)
        for d, f in ((jkw, jnp.asarray), (tkw, torch.from_numpy)):
            d["q_segment_ids"] = d["kv_segment_ids"] = f(seg)
    ref = np.asarray(j_flash(*map(jnp.asarray, (q, k, v)), interpret=True, **jkw))
    out = flash_attention_ref(*map(torch.from_numpy, (q, k, v)), **tkw).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-5)
    if case.get("valid"):
        np.testing.assert_array_equal(out[1, :5], 0.0)
    # on CPU tensors the public entry point is the plain version
    out2 = flash_attention(*map(torch.from_numpy, (q, k, v)), **tkw).numpy()
    np.testing.assert_array_equal(out2, out)


BF16_CASES = {
    "causal": dict(causal=True),
    "causal_window": dict(causal=True, left_window=45),
    "padding_dead_row": dict(causal=True, valid=True),
}


@pytest.mark.parametrize("name", sorted(BF16_CASES))
def test_plain_flash_bf16_matches_jax_kernel_interpret(name):
    """bf16 inputs: the plain version follows the JAX kernel's arithmetic
    (bf16 q.k summed in fp32, fp32 statistics, the normaliser from the fp32
    p, p rounded to bf16 before p.v).  The JAX kernel runs 64-key blocks, so
    it rounds p against a running max where the plain version uses the
    row's final one.  Tolerance 5e-3 absolute, 1e-2 relative: two bf16
    roundings of the output (2^-8 relative each) plus p's rounding averaged
    over the row's keys (max |err| 2e-3 to 3.9e-3 here; 7.8e-3 without the
    rounding of p)."""
    case = BF16_CASES[name]
    rs = np.random.RandomState(100 + len(name))
    b, t, hq, g, hd = 2, 200, 6, 2, 60
    q, k, v = (rs.randn(b, t, h, hd).astype(np.float32) for h in (hq, g, g))
    kw = dict(scale=hd**-0.5, causal=case["causal"],
              left_window=case.get("left_window", -1))
    jkw, tkw = dict(kw), dict(kw)
    if case.get("valid"):
        valid = rs.rand(b, t) > 0.25
        valid[1, :5] = False  # queries 0..4 of row 1 attend nothing causally
        jkw["kv_valid"], tkw["kv_valid"] = jnp.asarray(valid), torch.from_numpy(valid)
    jq, jk, jv = (jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v))
    ref = j_flash(jq, jk, jv, interpret=True, block_q=64, block_k=64, **jkw)
    assert ref.dtype == jnp.bfloat16
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    out = flash_attention_ref(tq, tk, tv, **tkw)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, dtype=np.float32),
                               atol=5e-3, rtol=1e-2)
    if case.get("valid"):
        np.testing.assert_array_equal(out[1, :5].float().numpy(), 0.0)
