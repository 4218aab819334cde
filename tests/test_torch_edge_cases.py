"""The counterparts of ``tests/test_ring_cache.py`` (the generation cases)
and ``tests/test_edge_cases.py``: the port against ``vats_tpu`` on the same
converted weights, fp32 on the CPU, one JAX run a case.

  * ring generation past the wrap (window 48 -> 128 slots, 224 tokens):
    greedy, the port's tokens equal JAX's, and the first 128 equal the
    port's own dense-cache run; sampled (the packages draw other bits from
    their generators), the port's ring equals its dense cache for one seed,
    as the JAX test holds JAX's;
  * a 200-token prompt into the 128-slot ring, 32 greedy tokens: equal to
    JAX's;
  * forwards at batch 1, 3 and 8, float token ids, a sequence past
    ``max_seq_len`` and a fully padded row (the valid row's logits): logits
    within 1e-5 of JAX's (the two run the same fp32 math in another order;
    the largest difference seen is 3.2e-7);
  * a bf16 forward: fp32 logits, finite, within 0.1 of JAX's bf16 forward
    (bf16 rounds activations to 2^-8 relative at other places);
  * ViT-3D tiny with more frames than ``max_frames`` (cut) and with one
    frame (padded, the frame mask covers the pads): features within 1e-5 of
    JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import meta

from vats_tpu.configs import ModelArgs as JArgs
from vats_tpu.configs.vit3d import vit3d_tiny_test as j_vit3d_tiny
from vats_tpu.inference.generate import generate as j_generate
from vats_tpu.models import TextLM as JTextLM
from vats_tpu.models.vit3d import VideoTransformer as JVideoTransformer
from vats_tpu_torch.configs import ModelArgs, vit3d_tiny_test
from vats_tpu_torch.inference import generate
from vats_tpu_torch.models import TextLM, VideoTransformer
from vats_tpu_torch.nn.kv_cache import ring_slots_for_window
from vats_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

LOGIT_ATOL = 1e-5
BF16_ATOL = 0.1


def both(seed=0, **kw):
    """(JAX model, JAX params, port model) with the same weights."""
    jm = JTextLM(JArgs(**kw))
    params = jm.init(jax.random.PRNGKey(seed), jnp.ones((1, 8), jnp.int32))
    cfg = ModelArgs(**kw)
    tm = TextLM(cfg, device="meta")
    pnp = jax.tree_util.tree_map(np.asarray, meta.unbox(params))
    tm.load_state_dict(params_from_jax(pnp, cfg), assign=True)
    return jm, params, tm.eval()


def ring_cfg(**kw):
    """``tests/test_ring_cache.py``'s model."""
    base = dict(d_model=64, num_heads=4, query_groups=2, d_ffn=128, num_layers=2,
                vocab_size=128, dropout=0.0, num_experts=1, top_k=1, max_seq_len=512,
                use_mqa=False, gradient_checkpointing=False, dtype="float32",
                param_dtype="float32", left_window=48)
    base.update(kw)
    return base


def edge_cfg(**kw):
    """``tests/test_edge_cases.py``'s model."""
    base = dict(d_model=64, num_heads=4, query_groups=2, d_ffn=128, num_layers=2,
                dropout=0.0, vocab_size=97, max_seq_len=32, left_window=-1,
                dtype="float32", gradient_checkpointing=False)
    base.update(kw)
    return base


def ids(shape, seed, lo=1, hi=97):
    return np.random.RandomState(seed).randint(lo, hi, shape).astype(np.int32)


def port_generate(model, prompt, seed, **kw):
    gen = torch.Generator().manual_seed(seed)
    toks, lengths = generate(model, torch.from_numpy(prompt), None, gen, pad_token_id=0,
                             eos_token_id=None, **kw)
    return toks.numpy(), lengths.numpy()


@pytest.mark.parametrize("do_sample", [False, True], ids=["greedy", "sampled"])
def test_ring_generate_past_the_wrap(do_sample):
    jm, params, tm = both(**ring_cfg())
    assert ring_slots_for_window(48) == 128
    prompt = ids((2, 24), 1, hi=128)
    sample = dict(do_sample=do_sample, temperature=0.8 if do_sample else 0.0,
                  top_k=20 if do_sample else None)
    ring, ring_len = port_generate(tm, prompt, 2, total_len=224, max_new_tokens=200,
                                   **sample)
    dense, _ = port_generate(tm, prompt, 2, total_len=128, max_new_tokens=104, **sample)
    np.testing.assert_array_equal(ring[:, :128], dense)
    assert list(ring_len) == [224, 224]
    if not do_sample:
        want, want_len = j_generate(jm, params, jnp.asarray(prompt), None,
                                    jax.random.PRNGKey(2), total_len=224,
                                    max_new_tokens=200, pad_token_id=0,
                                    eos_token_id=None, **sample)
        np.testing.assert_array_equal(ring, np.asarray(want))
        np.testing.assert_array_equal(ring_len, np.asarray(want_len))


def test_ring_prefill_longer_than_ring_equals_jax():
    jm, params, tm = both(**ring_cfg(max_seq_len=1024))
    prompt = ids((1, 200), 3, hi=128)
    kw = dict(total_len=512, max_new_tokens=32, do_sample=False, temperature=0.0)
    got, _ = port_generate(tm, prompt, 2, **kw)
    want, _ = j_generate(jm, params, jnp.asarray(prompt), None, jax.random.PRNGKey(2),
                         pad_token_id=0, eos_token_id=None, **kw)
    np.testing.assert_array_equal(got[:, :232], np.asarray(want)[:, :232])
    assert not np.array_equal(got[:, 200:232], np.zeros((1, 32)))


def logits_both(jm, params, tm, x, mask=None):
    jl, _, _ = jm.apply(params, jnp.asarray(x),
                        padding_mask=None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        tl, _, _ = tm(torch.from_numpy(np.asarray(x)),
                      padding_mask=None if mask is None else torch.from_numpy(mask))
    return np.asarray(jl), tl.numpy()


@pytest.mark.parametrize("batch", [1, 3, 8])
def test_variable_batch_sizes_equal_jax(batch):
    want, got = logits_both(*both(1, **edge_cfg()), ids((batch, 8), batch))
    assert got.shape == (batch, 8, 97)
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)


def test_float_input_ids_equal_jax():
    x = np.asarray([[1.0, 5.0, 9.0, 2.0]], np.float32)
    want, got = logits_both(*both(2, **edge_cfg()), x)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)


def test_bf16_forward_finite_and_near_jax():
    want, got = logits_both(*both(4, **edge_cfg(dtype="bfloat16")), ids((2, 16), 3))
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)


def test_sequence_longer_than_max_seq_len_equals_jax():
    want, got = logits_both(*both(6, **edge_cfg(max_seq_len=16)), ids((1, 24), 5))
    assert got.shape == (1, 24, 97)
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)


def test_fully_padded_row_leaves_the_other_row_equal_to_jax():
    mask = np.asarray([[True] * 8, [False] * 8])
    want, got = logits_both(*both(12, **edge_cfg()), ids((2, 8), 11), mask)
    assert np.isfinite(got[0]).all()
    np.testing.assert_allclose(got[0], want[0], atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("frames", [20, 1], ids=["more_than_max_frames", "one_frame"])
def test_vit3d_frame_counts_equal_jax(frames):
    jcfg, cfg = j_vit3d_tiny(dtype="float32"), vit3d_tiny_test(dtype="float32")
    x = np.random.RandomState(frames).randn(1, 3, frames, 32, 32).astype(np.float32)
    jm = JVideoTransformer(jcfg)
    params = jm.init(jax.random.PRNGKey(8), jnp.asarray(x))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = VideoTransformer(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(jax.device_get(meta.unbox(params["params"])), cfg))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    gt, gh, gw = cfg.grid_size
    assert got.shape == (1, gt * gh * gw, cfg.d_model) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
