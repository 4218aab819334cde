"""TextLM weights carried across from vats_tpu: the port's logits equal the
JAX logits for the same converted weights.

fp32 on both sides.  Tolerance atol 2e-4, rtol 2e-3, as
tests/test_paged_generate.py uses for logits: fp32 sums over d_model and
the vocab taken in another order, through two layers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import meta

from vats_tpu.configs import ModelArgs as JArgs
from vats_tpu.models import TextLM as JTextLM
from vats_tpu.ops.decode_attention import PagedKVCache as JPaged
from vats_tpu_torch.configs import ModelArgs
from vats_tpu_torch.models import TextLM
from vats_tpu_torch.ops.decode_attention import PagedKVCache
from vats_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

LOGIT_TOL = dict(atol=2e-4, rtol=2e-3)


def tiny(**kw):
    base = dict(
        d_model=64, num_heads=4, query_groups=2, d_ffn=128, num_layers=2,
        dropout=0.0, vocab_size=97, max_seq_len=64, left_window=-1,
        num_experts=1, top_k=1, dtype="float32", gradient_checkpointing=False,
        max_batch_size=8,
    )
    base.update(kw)
    return base


def both_models(seed=0, **kw):
    jm = JTextLM(JArgs(**tiny(**kw)))
    cfg = ModelArgs(**tiny(**kw))
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))
    pnp = jax.tree_util.tree_map(np.asarray, meta.unbox(params))
    tm = TextLM(cfg, device="meta")
    tm.load_state_dict(params_from_jax(pnp, cfg), assign=True)
    return jm, params, tm.eval()


def ids_and_mask(b=2, t=12, seed=1):
    rs = np.random.RandomState(seed)
    ids = rs.randint(1, 97, (b, t)).astype(np.int32)
    mask = np.ones((b, t), bool)
    mask[1, t - 4:] = False
    return np.where(mask, ids, 0), mask


MODEL_CASES = {
    "E1_tied": dict(),
    "E1_untied_split_qkv_bias": dict(tie_weights=False, use_qkv_proj=False,
                                     use_proj_bias=True),
    "E4_top2_dense": dict(num_experts=4, top_k=2, capacity_factor=1.25,
                          moe_dispatch="dense"),
    "E4_top2_scatter": dict(num_experts=4, top_k=2, capacity_factor=1.25,
                            moe_dispatch="scatter"),
    "E4_top2_sort": dict(num_experts=4, top_k=2, capacity_factor=1.25,
                         moe_dispatch="sort"),
    "E4_top2_capacity_binds": dict(num_experts=4, top_k=2, capacity_factor=0.5,
                                   tie_weights=False),
    "windowed": dict(left_window=5),
}


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_uncached_logits_match_jax(name):
    jm, params, tm = both_models(**MODEL_CASES[name])
    ids, mask = ids_and_mask()
    jl, _, _ = jm.apply(params, jnp.asarray(ids), padding_mask=jnp.asarray(mask))
    with torch.no_grad():
        tl, _, aux = tm(torch.from_numpy(ids), padding_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert float(aux) == 0.0  # deterministic: no aux loss, as in JAX


def test_readout_positions_hidden_and_aux_loss_match_jax():
    jm, params, tm = both_models(num_experts=4, top_k=2, capacity_factor=1.25)
    ids, mask = ids_and_mask()
    pos = np.array([11, 7], np.int32)
    jl, _, _ = jm.apply(params, jnp.asarray(ids), readout_positions=jnp.asarray(pos))
    jh, _, _ = jm.apply(params, jnp.asarray(ids), return_hidden=True)
    _, _, jaux = jm.apply(params, jnp.asarray(ids), deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(0)})
    with torch.no_grad():
        tl, _, _ = tm(torch.from_numpy(ids), readout_positions=torch.from_numpy(pos))
        th, _, _ = tm(torch.from_numpy(ids), return_hidden=True)
        _, _, taux = tm(torch.from_numpy(ids), deterministic=False)
    assert tl.shape == (2, 1, 97)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-4)


def test_scan_mode_params_convert():
    """A tree trained with scan_layers (layers stacked on axis 0) converts to
    the same model as its loop-mode twin."""
    jm, params, tm = both_models()
    p = jax.tree_util.tree_map(np.asarray, meta.unbox(params))["params"]
    stacked = JTextLM.stack_layer_params(p, 2)
    cfg = ModelArgs(**tiny())
    tm2 = TextLM(cfg, device="meta")
    tm2.load_state_dict(params_from_jax({"params": stacked}, cfg), assign=True)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, tm2.state_dict()[k]), k


def test_paged_prefill_fresh_then_history_then_decode_match_jax():
    """Fresh prefill (window attention + whole-page append), a second prefill
    into the cache (append_tokens + gather + masked attention) and decode
    steps (K1's plain version) give the JAX logits."""
    jm, params, tm = both_models(num_experts=4, top_k=2, capacity_factor=1.25)
    ids, mask = ids_and_mask(t=16, seed=3)
    cfg = tm.cfg
    jc = JPaged.create(2, 2, 40, cfg.query_groups, cfg.head_dim, page_size=128,
                       dtype=jnp.float32)
    tc = PagedKVCache.create(2, 2, 40, cfg.query_groups, cfg.head_dim,
                             page_size=128, dtype=torch.float32, device="cpu")
    steps = [(ids[:, :8], mask[:, :8]), (ids[:, 8:12], None), (ids[:, 12:13], None),
             (ids[:, 13:14], None)]
    japply = jax.jit(lambda p, x, c, m: jm.apply(p, x, paged_cache=c, padding_mask=m))
    for chunk, m in steps:
        jl, jc, _ = japply(params, jnp.asarray(chunk), jc,
                           None if m is None else jnp.asarray(m))
        with torch.no_grad():
            tl, tc, _ = tm(torch.from_numpy(chunk), paged_cache=tc,
                           padding_mask=None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
        assert tc.fresh is False and jc.fresh is False


def test_init_distributions():
    """The port's own init draws from the JAX package's distributions."""
    cfg = ModelArgs(**tiny(num_layers=16, num_experts=2, top_k=1, d_model=128,
                           d_ffn=512))
    tm = TextLM(cfg, device="cpu", seed=0)
    sd = tm.state_dict()
    np.testing.assert_allclose(float(sd["token_embed.weight"].std()), 0.02, rtol=0.05)
    depth = 1.0 / np.sqrt(16 / 6.0)
    bound = np.sqrt(6.0 / (128 + 512)) * depth
    w = sd["layers.3.moe_block.moe.experts.w_gate"]
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.95 * bound
    np.testing.assert_allclose(float(sd["layers.0.attn_block.attn.w_o.weight"].std()),
                               0.02 / np.sqrt(32), rtol=0.05)
    assert torch.equal(TextLM(cfg, device="cpu", seed=0).state_dict()["norm.weight"],
                       torch.ones(128))
