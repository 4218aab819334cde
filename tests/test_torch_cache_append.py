"""K3's plain version and the dense KVCache (ring mode included) against
vats_tpu.  Buffers keep the JAX layout [L, B, G, hd_pad, S] and are compared
bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vats_tpu.nn.kv_cache import KVCache as JKVCache
from vats_tpu.ops.cache_append import append_token_inplace as j_append
from vats_tpu_torch.nn.kv_cache import KVCache, ring_slots_for_window
from vats_tpu_torch.ops.cache_append import append_token_inplace

torch.set_num_threads(1)


@pytest.mark.parametrize("pos", [0, 1, 127, 128, 255, 256 + 9])  # last clamps
def test_plain_append_matches_jax_kernel_interpret(pos):
    rs = np.random.RandomState(pos)
    l, b, g, hd, s = 2, 3, 2, 16, 256
    k = rs.randn(l, b, g, hd, s).astype(np.float32)
    v = rs.randn(l, b, g, hd, s).astype(np.float32)
    kn = rs.randn(b, g, hd).astype(np.float32)
    vn = rs.randn(b, g, hd).astype(np.float32)
    jk, jv = j_append(*map(jnp.asarray, (k, v)), 1, jnp.asarray(kn),
                      jnp.asarray(vn), jnp.asarray(pos, jnp.int32), interpret=True)
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    append_token_inplace(tk, tv, 1, torch.from_numpy(kn), torch.from_numpy(vn),
                         torch.tensor(pos, dtype=torch.int32))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("ring,s,prefill", [(False, 40, 7), (True, 128, 150),
                                            (True, 128, 20)])
def test_kv_cache_update_matches_jax(ring, s, prefill):
    """Prefill then three decode steps; S=40 is not a multiple of 128 (the
    JAX package's TPU kernel rule), and the 150-token ring prefill keeps only
    the most recent 128 positions."""
    rs = np.random.RandomState(s + prefill)
    l, b, g, hd = 2, 2, 2, 12
    jc = JKVCache.create(l, b, s, g, hd, dtype=jnp.float32, ring=ring)
    tc = KVCache.create(l, b, s, g, hd, dtype=torch.float32, ring=ring, device="cpu")
    for t in (prefill, 1, 1, 1):
        for layer in range(l):
            kn = rs.randn(b, t, g, hd).astype(np.float32)
            vn = rs.randn(b, t, g, hd).astype(np.float32)
            jc = jc.update_layer(layer, jnp.asarray(kn), jnp.asarray(vn))
            tc.update_layer(layer, torch.from_numpy(kn), torch.from_numpy(vn))
        jc, _ = jc.advance(t), tc.advance(t)
        np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
        np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))
        assert int(tc.length) == int(jc.length)
        np.testing.assert_array_equal(tc.slot_positions(extra=1).numpy(),
                                      np.asarray(jc.slot_positions(extra=1)))
        np.testing.assert_array_equal(tc.valid_mask(b, extra=1).numpy(),
                                      np.asarray(jc.valid_mask(b, extra=1)))


def test_ring_slots_for_window_matches_jax():
    from vats_tpu.nn.kv_cache import ring_slots_for_window as j_slots

    for w in (0, 1, 127, 128, 384, 1000):
        assert ring_slots_for_window(w) == j_slots(w)
