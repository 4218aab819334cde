"""The port's top-k and ``approx_top_k`` sampling against ``vats_tpu``.

Off the TPU, XLA computes ``jax.lax.approx_max_k`` exactly, so
``sample_logits(..., approx_top_k=True)`` in JAX samples from the exact
top-k, re-sorted stably by value.  The port's ``exact_top_k`` returns the
same (values, indices) bit for bit, equal values in index order, and the
flag selects it too.  Logits come from a seed with numpy: distinct fp32
values, bf16 values upcast to fp32 (ties by the dozen at a vocabulary of
50000) and integers (ties everywhere).  Tolerances: none; every comparison
is exact (values, indices and drawn tokens).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vats_tpu.inference.sampling import exact_top_k as j_exact_top_k
from vats_tpu_torch.inference.sampling import (
    exact_top_k,
    sample_logits,
    sample_logits_per_row,
)

torch.set_num_threads(1)


def _logits(kind, b, v, seed):
    x = np.random.RandomState(seed).randn(b, v).astype(np.float32) * 3
    if kind == "bf16":
        return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    if kind == "integers":
        return np.round(x).astype(np.float32)
    return x


def _jax_approx_sorted(x, k):
    """The JAX package's approx_top_k subspace (sampling.py:160-165)."""
    vals, idx = jax.lax.approx_max_k(jnp.asarray(x), k)
    order = jnp.argsort(-vals, axis=-1)
    return (np.asarray(jnp.take_along_axis(vals, order, axis=-1)),
            np.asarray(jnp.take_along_axis(idx, order, axis=-1)))


@pytest.mark.parametrize("kind", ["distinct", "bf16", "integers"])
@pytest.mark.parametrize("v,k", [(50000, 50), (4096, 64), (300, 1), (97, 20)])
def test_exact_top_k_equals_lax_top_k_ties_included(kind, v, k):
    """Against ``lax.top_k`` and the JAX package's chunked ``exact_top_k``
    (4096 = 16 chunks of 256): equal values come in index order, and the
    lowest indices of a tie at the k-th value make the k.  (That is
    ``lax.top_k``'s documented order; XLA's CPU top-k keeps it for the k
    that sampling takes, up to about a third of V, and not past ~0.4 V,
    where it sorts the whole row without keeping ties in order.)"""
    x = _logits(kind, 4, v, seed=v + k)
    got_v, got_i = exact_top_k(torch.from_numpy(x), k)
    for want_v, want_i in (jax.lax.top_k(jnp.asarray(x), k),
                           j_exact_top_k(jnp.asarray(x), k)):
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("kind", ["distinct", "bf16", "integers"])
@pytest.mark.parametrize("k", [20, 50])
def test_approx_top_k_subspace_equals_jax_approx_max_k(kind, k):
    """The sorted top-k subspace the approx path samples in: JAX's
    ``approx_max_k`` + stable ``argsort(-vals)`` against the port's."""
    x = _logits(kind, 4, 50000, seed=k)
    want_v, want_i = _jax_approx_sorted(x, k)
    got_v, got_i = exact_top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_i.numpy(), want_i)


@pytest.mark.parametrize("kw", [dict(temperature=0.8, top_k=50, top_p=0.9),
                                dict(temperature=1.3, top_k=7),
                                dict(top_k=20, repetition_penalty=1.2)])
@pytest.mark.parametrize("kind", ["distinct", "bf16"])
def test_approx_top_k_draws_the_exact_top_k_tokens(kw, kind):
    """One generator seed, the flag on and off: the same tokens."""
    x = torch.from_numpy(_logits(kind, 16, 5000, seed=3))
    if "repetition_penalty" in kw:
        kw = dict(kw, generated_ids=torch.randint(0, 5000, (16, 12),
                                                  generator=torch.Generator().manual_seed(4)),
                  generated_valid=torch.ones((16, 12), dtype=torch.bool))
    for seed in range(5):
        draws = [sample_logits(torch.Generator().manual_seed(seed), x, approx_top_k=a, **kw)
                 for a in (True, False)]
        assert torch.equal(draws[0], draws[1])


def test_approx_top_k_support():
    """The port's counterpart of ``tests/test_generate.py``'s
    ``test_approx_top_k_support``: the approx path's tokens sit in the top-2k
    set (JAX's bound for TPU recall ~0.95), here in the exact top-k."""
    logits = np.asarray(jax.random.normal(jax.random.PRNGKey(9), (2, 256))) * 4.0
    exact_top = np.asarray(jax.lax.top_k(jnp.asarray(logits), 40)[1])
    gen = torch.Generator().manual_seed(0)
    for _ in range(10):
        tok = sample_logits(gen, torch.from_numpy(logits), temperature=0.8, top_k=20,
                            do_sample=True, approx_top_k=True)
        for b in range(2):
            assert int(tok[b]) in exact_top[b]
            assert int(tok[b]) in exact_top[b][:20]


def test_per_row_sampling_greedy_rows_take_the_first_index_of_a_tie():
    """``sample_logits_per_row``'s greedy rows read index 0 of the sorted
    subspace: with every logit tied, that is token 0, as ``lax.top_k`` puts it."""
    logits = torch.zeros((3, 300))
    got = sample_logits_per_row(
        None, logits, temperature=torch.zeros(3), top_k=torch.tensor([0, 1, 5]),
        top_p=torch.ones(3), row_seeds=torch.arange(3), positions=torch.zeros(3))
    assert got.tolist() == [0, 0, 0]
