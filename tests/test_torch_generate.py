"""The slice as a whole: greedy tokens from the port's ``generate``,
``generate_paged`` and ``TokenGenerator`` equal vats_tpu's for the same
converted weights (exactly), and sampled tokens have the right distribution.

fp32 on the CPU, where the port runs the kernels' plain versions and the
JAX package its own CPU paths (XLA attention, the XLA paged decode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import meta

from vats_tpu.configs import GenerationArgs as JGenArgs
from vats_tpu.configs import ModelArgs as JArgs
from vats_tpu.inference.generate import TokenGenerator as JTokenGenerator
from vats_tpu.inference.generate import generate as j_generate
from vats_tpu.inference.generate import generate_paged as j_generate_paged
from vats_tpu.models import TextLM as JTextLM
from vats_tpu_torch.configs import GenerationArgs, ModelArgs
from vats_tpu_torch.inference import TokenGenerator, generate, generate_paged
from vats_tpu_torch.inference.sampling import sample_logits
from vats_tpu_torch.models import TextLM
from vats_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)


def tiny(**kw):
    base = dict(
        d_model=64, num_heads=4, query_groups=2, d_ffn=128, num_layers=2,
        dropout=0.0, vocab_size=97, max_seq_len=64, left_window=-1,
        num_experts=4, top_k=2, capacity_factor=1.25, dtype="float32",
        gradient_checkpointing=False, max_batch_size=8,
    )
    base.update(kw)
    return base


def both_models(seed=0, jax_kw=None, **kw):
    jm = JTextLM(JArgs(**tiny(**{**kw, **(jax_kw or {})})))
    cfg = ModelArgs(**tiny(**kw))
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))
    pnp = jax.tree_util.tree_map(np.asarray, meta.unbox(params))
    tm = TextLM(cfg, device="meta")
    tm.load_state_dict(params_from_jax(pnp, cfg), assign=True)
    return jm, params, tm.eval()


def prompts(lens, t, seed):
    rs = np.random.RandomState(seed)
    ids = rs.randint(1, 97, (len(lens), t)).astype(np.int32)
    mask = np.arange(t)[None, :] < np.asarray(lens)[:, None]
    return np.where(mask, ids, 0), mask


GREEDY = dict(do_sample=False, temperature=0.0, pad_token_id=0, eos_token_id=None)


def run_both(jm, params, tm, fn_j, fn_t, ids, mask, **kw):
    jt, jl = fn_j(jm, params, jnp.asarray(ids), jnp.asarray(mask),
                  jax.random.PRNGKey(0), **kw)
    tt, tl = fn_t(tm, torch.from_numpy(ids), torch.from_numpy(mask), None, **kw)
    return (np.asarray(jt), np.asarray(jl)), (tt.numpy(), tl.numpy())


@pytest.mark.parametrize(
    "lens,chunk", [([8, 8, 8, 8], None), ([8, 5, 2, 7], None), ([8, 5, 2, 7], 2)]
)
def test_generate_paged_greedy_tokens_equal_jax(lens, chunk):
    jm, params, tm = both_models()
    ids, mask = prompts(lens, 8, seed=sum(lens))
    (jt, jl), (tt, tl) = run_both(
        jm, params, tm, j_generate_paged, generate_paged, ids, mask,
        max_new_tokens=6, total_len=16, page_size=128, prefill_row_chunk=chunk,
        **GREEDY)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tt, jt)


@pytest.mark.parametrize("left_window", [-1, 5])  # 5: the ring cache path
def test_generate_dense_greedy_tokens_equal_jax(left_window):
    jm, params, tm = both_models(left_window=left_window, max_seq_len=200)
    ids, mask = prompts([8, 6], 8, seed=11)
    (jt, jl), (tt, tl) = run_both(
        jm, params, tm, j_generate, generate, ids, mask, max_new_tokens=6,
        total_len=140 if left_window > 0 else 16, **GREEDY)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tt, jt)


def test_long_prompt_takes_the_flash_branch_and_equals_jax():
    """A 260-token fresh prefill: the port runs K2's plain version (its
    'flash' path on the CPU); the JAX package its XLA attention.  The two
    differ only for rows with no valid key, which right-padded causal
    prefill never has."""
    jm, params, tm = both_models(max_seq_len=300, attention_impl="flash",
                                 jax_kw=dict(attention_impl="xla"))
    import vats_tpu_torch.nn.attention as tattn

    calls = []
    real = tattn.flash_attention
    tattn.flash_attention = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        ids, mask = prompts([260, 201], 260, seed=12)
        (jt, jl), (tt, tl) = run_both(
            jm, params, tm, j_generate_paged, generate_paged, ids, mask,
            max_new_tokens=4, total_len=264, page_size=128, **GREEDY)
    finally:
        tattn.flash_attention = real
    assert len(calls) == tm.cfg.num_layers  # one prefill through the flash path
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tt, jt)


class Tok:
    pad_token_id = 0
    eos_token_id = None

    def encode(self, text):
        return [hash(w) % 90 + 1 for w in text.split()]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)


@pytest.mark.parametrize("use_paged", [False, True])
def test_token_generator_text_equals_jax(use_paged):
    args = tiny(num_experts=1, top_k=1)
    jgen = JTokenGenerator(JArgs(**args), seed=0, use_paged=use_paged)
    cfg = ModelArgs(**args)
    pnp = jax.tree_util.tree_map(np.asarray, meta.unbox(jgen.params))
    tgen = TokenGenerator(cfg, params=params_from_jax(pnp, cfg), use_paged=use_paged,
                          device="cpu")
    kw = dict(max_new_tokens=8, temperature=0.0, do_sample=False, top_k=None,
              top_p=None, repetition_penalty=None)
    prompt = "Once upon a time, in a land far away"
    out_j = jgen.generate_tokens(prompt, JGenArgs(**kw), Tok())
    out_t = tgen.generate_tokens(prompt, GenerationArgs(**kw), Tok())
    assert out_t == out_j and len(out_t.split()) == 8
    kw_all = dict(kw, return_only_new_tokens=False)
    assert tgen.generate_tokens(prompt, GenerationArgs(**kw_all), Tok()) == \
        jgen.generate_tokens(prompt, JGenArgs(**kw_all), Tok())
    assert tgen.generate_tokens("  ", GenerationArgs(), Tok()) == \
        "Please enter a valid prompt."


def test_eos_stops_rows_and_pads_like_jax():
    jm, params, tm = both_models(num_experts=1, top_k=1)
    ids, mask = prompts([8, 8], 8, seed=13)
    # the first greedy token of row 0 becomes the EOS: row 0 stops at once
    (jt0, _), _ = run_both(jm, params, tm, j_generate_paged, generate_paged, ids,
                           mask, max_new_tokens=1, total_len=16, page_size=128,
                           **GREEDY)
    kw = dict(GREEDY, eos_token_id=int(jt0[0, 8]))
    for fn_j, fn_t in ((j_generate_paged, generate_paged), (j_generate, generate)):
        extra = dict(page_size=128) if fn_t is generate_paged else {}
        (jt, jl), (tt, tl) = run_both(jm, params, tm, fn_j, fn_t, ids, mask,
                                      max_new_tokens=5, total_len=16, **extra, **kw)
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(tt, jt)


def test_sampling_statistics_match_the_filtered_distribution():
    """Draws follow softmax(top-p(top-k(logits / T))): frequencies over
    20000 draws agree with the target probabilities (JAX's sampler draws
    from the same distribution with other bits)."""
    from vats_tpu.inference.sampling import apply_top_k as j_top_k
    from vats_tpu.inference.sampling import apply_top_p as j_top_p

    logits = np.random.RandomState(14).randn(2, 40).astype(np.float32) * 2.0
    k, p, temp = 8, 0.9, 0.7
    target = np.asarray(jax.nn.softmax(
        j_top_p(j_top_k(jnp.asarray(logits) / temp, k), p), axis=-1))
    n = 20000
    gen = torch.Generator().manual_seed(0)
    draws = sample_logits(gen, torch.from_numpy(logits).repeat_interleave(n, 0),
                          temperature=temp, top_k=k, top_p=p)
    freq = np.stack([np.bincount(draws.numpy().reshape(2, n)[r], minlength=40) / n
                     for r in range(2)])
    assert np.all(freq[target == 0] == 0)  # nothing outside the support
    np.testing.assert_allclose(freq, target, atol=0.015)  # ~4 sigma at n=20000
    # the full-vocab path (no top-k) draws from the same filtered law
    draws2 = sample_logits(gen, torch.from_numpy(logits[:1]).repeat_interleave(n, 0),
                           temperature=temp, top_p=p)
    freq2 = np.bincount(draws2.numpy(), minlength=40) / n
    target2 = np.asarray(jax.nn.softmax(j_top_p(jnp.asarray(logits[:1]) / temp, p)))
    np.testing.assert_allclose(freq2, target2[0], atol=0.015)
