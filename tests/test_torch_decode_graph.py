"""The decode steps that the card captures as CUDA graphs, run eagerly on the
CPU: ``generate``, ``generate_paged`` and the serving engine's decode block
restructured as functions of persistent tensors updated in place
(``inference/graphs.py``), held to ``vats_tpu``.

Tolerance: tokens and lengths exactly equal to the JAX package's, for the
same converted weights, on the CPU (the port's kernels run their plain
versions; the JAX package its XLA attention and XLA paged decode, as its own
CPU tests run them).  The engine's keyed per-row draws are not JAX's bits,
so a sampled stream is held exactly to the port's own single-step engine.

Cases: greedy over a bf16 model (bf16 pages), an fp32 model with fp32 and
int8 pages; an EOS that finishes every row in the middle of a
``FINISH_CHECK_EVERY`` interval, with ``max_new_tokens`` no multiple of it;
a row that runs out of buffer; the ring cache of a windowed model; an engine
stream with 4-step blocks that reaches the 1-step fallback near its context
cap and preempts a row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import meta

from vats_tpu.configs import ModelArgs as JArgs
from vats_tpu.inference.generate import generate as j_generate
from vats_tpu.inference.generate import generate_paged as j_generate_paged
from vats_tpu.inference.serving import ServingEngine as JServingEngine
from vats_tpu.models import TextLM as JTextLM
from vats_tpu_torch.configs import ModelArgs
from vats_tpu_torch.inference import SamplingParams, ServingEngine
from vats_tpu_torch.inference import generate as t_generate
from vats_tpu_torch.inference import generate_paged as t_generate_paged
from vats_tpu_torch.inference.graphs import FINISH_CHECK_EVERY
from vats_tpu_torch.models import TextLM
from vats_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)


def tiny(**kw):
    base = dict(
        d_model=64, num_heads=4, query_groups=2, d_ffn=128, num_layers=2,
        dropout=0.0, vocab_size=97, max_seq_len=256, left_window=-1,
        num_experts=4, top_k=2, capacity_factor=1.25, dtype="float32",
        gradient_checkpointing=False, max_batch_size=8, use_mqa=False,
    )
    base.update(kw)
    return base


def both_models(seed=0, **kw):
    jm = JTextLM(JArgs(**tiny(**kw)))
    cfg = ModelArgs(**tiny(**kw))
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))
    tm = TextLM(cfg, device="meta")
    tm.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        np.asarray, meta.unbox(params)), cfg), assign=True)
    return jm, params, tm.eval()


def prompts(lens, t, seed):
    rs = np.random.RandomState(seed)
    ids = rs.randint(1, 97, (len(lens), t)).astype(np.int32)
    mask = np.arange(t)[None, :] < np.asarray(lens)[:, None]
    return np.where(mask, ids, 0), mask


GREEDY = dict(do_sample=False, temperature=0.0, pad_token_id=0)


def decode_forwards(model):
    """A counter of the model's one-token forwards, and its hook handle."""
    box = {"n": 0}

    def hook(mod, args, kwargs):
        box["n"] += int(args[0].shape[1] == 1)

    return box, model.register_forward_pre_hook(hook, with_kwargs=True)


def run_both(fn, models, ids, mask, **kw):
    jm, params, tm = models
    j_fn, t_fn = {"dense": (j_generate, t_generate),
                  "paged": (j_generate_paged, t_generate_paged)}[fn]
    jt, jl = j_fn(jm, params, jnp.asarray(ids), jnp.asarray(mask),
                  jax.random.PRNGKey(0), **kw)
    box, handle = decode_forwards(tm)
    try:
        tt, tl = t_fn(tm, torch.from_numpy(ids), torch.from_numpy(mask), None, **kw)
    finally:
        handle.remove()
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    return tt.numpy(), tl.numpy(), box["n"]


# (name, path, model kwargs, prompt lengths, prompt width, generate kwargs)
CASES = [
    ("paged bf16 pages", "paged", dict(dtype="bfloat16"), [8, 5, 2, 7], 8,
     dict(max_new_tokens=11, total_len=32)),
    ("paged fp32 pages", "paged", {}, [8, 5, 2, 7], 8,
     dict(max_new_tokens=11, total_len=32)),
    ("paged int8 pages", "paged", {}, [8, 3], 8,
     dict(max_new_tokens=13, total_len=32, kv_quant="int8")),
    # row 0 reaches total_len after 4 tokens, row 1 after 9: both stop short
    ("paged out of buffer", "paged", {}, [8, 3], 8,
     dict(max_new_tokens=11, total_len=12)),
    ("dense", "dense", {}, [8, 6], 8, dict(max_new_tokens=11, total_len=32)),
    # a 128-slot ring for a 5-token window: 124 + 13 positions wrap it
    ("dense ring", "dense", dict(left_window=5), [124, 120], 124,
     dict(max_new_tokens=13, total_len=140)),
]


@pytest.mark.parametrize("name,path,model_kw,lens,t,kw", CASES, ids=[c[0] for c in CASES])
def test_decode_step_tokens_equal_jax(name, path, model_kw, lens, t, kw):
    models = both_models(**model_kw)
    ids, mask = prompts(lens, t, seed=len(name))
    _, tl, forwards = run_both(path, models, ids, mask, **GREEDY, **kw)
    # without an EOS the loop runs every step (a row out of buffer only
    # stops emitting tokens)
    assert forwards == kw["max_new_tokens"] if path == "paged" else min(
        kw["max_new_tokens"], kw["total_len"] - t)
    if name == "paged out of buffer":
        assert list(tl) == [12, 12]


@pytest.mark.parametrize("path", ["paged", "dense"])
def test_eos_mid_interval_equals_jax_and_ends_the_loop_at_the_check(path):
    """Both rows stop at the EOS inside the first FINISH_CHECK_EVERY steps
    (these two prompts emit token 47 first and third), with
    max_new_tokens no multiple of it: the steps until the check change no
    token and no length, and the loop ends at the check."""
    models = both_models(num_experts=1, top_k=1)
    ids, mask = prompts([8] * 8, 8, seed=3)
    ids, mask = ids[[5, 7]], mask[[5, 7]]
    kw = dict(GREEDY, max_new_tokens=2 * FINISH_CHECK_EVERY + 3, total_len=40)
    _, tl, forwards = run_both(path, models, ids, mask, eos_token_id=47, **kw)
    assert list(tl) == [9, 11]
    assert forwards == FINISH_CHECK_EVERY


# ---------------- the engine's decode block ----------------

ENGINE_CFG = dict(vocab_size=128, max_seq_len=512, num_experts=1, top_k=1)


def engine_stream():
    """Two rows, three pages: the long prompt grows into a second page while
    the system-prompt rows hold theirs, so a row is preempted; the last
    request ends near the 200-token context cap, where 4-step blocks fall
    back to single steps."""
    system = [(13 * i) % 120 + 1 for i in range(130)]
    long_b = [(5 * i) % 120 + 1 for i in range(122)]
    near_cap = [(3 * i) % 120 + 1 for i in range(190)]
    return [(system + [3, 1, 4], 12), (long_b, 14), (system + [2, 7, 1, 8], 6),
            (near_cap, 30), ([7, 7, 23, 45], 9)]


ENGINE_KW = dict(max_batch=2, max_context=200, total_pages=1 + 3)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_engine_blocks_of_four_equal_jax_engine(kv_quant):
    jm, params, tm = both_models(**ENGINE_CFG)
    kw = dict(ENGINE_KW, prefix_caching=True, kv_quant=kv_quant, decode_block_steps=4)
    je, te = JServingEngine(jm, params, **kw), ServingEngine(tm, **kw)
    blocks = []
    real = te._decode_block
    te._decode_block = lambda k: blocks.append(k) or real(k)
    j_rids = [je.submit(p, max_new_tokens=n) for p, n in engine_stream()]
    t_rids = [te.submit(p, max_new_tokens=n) for p, n in engine_stream()]
    j_out, t_out = je.run(), te.run()
    assert te.preemptions == je.preemptions >= 1
    assert 1 in blocks and 4 in blocks  # the fallback ran
    assert te.forwards["decode"] == sum(blocks)
    for jr, tr in zip(j_rids, t_rids):
        assert t_out[tr] == [int(x) for x in j_out[jr]], f"request {tr} differs"
    # near the cap: stopped by max_context, not by its budget
    assert len(t_out[t_rids[3]]) == 200 - 190


@pytest.mark.parametrize("overlap", [False, True])
def test_engine_keyed_sampling_blocks_equal_single_steps(overlap):
    """Seeded per-row draws are keyed by (seed, position): 4-step blocks,
    pipelined or not, give the single-step engine's tokens."""
    _, _, tm = both_models(**ENGINE_CFG)
    outs = {}
    for k in (1, 4):
        eng = ServingEngine(tm, **ENGINE_KW, decode_block_steps=k,
                            per_request_sampling=True,
                            overlap_scheduling=overlap and k > 1)
        for i, (p, n) in enumerate(engine_stream()):
            eng.submit(p, max_new_tokens=n, sampling=SamplingParams(
                temperature=0.9, top_k=20, seed=50 + i))
        outs[k] = eng.run()
        assert eng.preemptions >= 1 and eng.allocator.num_used == 0
    assert outs[1] == outs[4]


# ---------------- what capture relies on ----------------


def test_caches_advance_in_place():
    """A captured step reads and writes the same length tensors at every
    replay: the dense and paged caches advance them in place."""
    from vats_tpu_torch.nn.kv_cache import KVCache
    from vats_tpu_torch.ops.decode_attention import PagedKVCache

    dense = KVCache.create(2, 3, 16, 2, 8, dtype=torch.float32, device="cpu")
    ptr = dense.length.data_ptr()
    dense.advance(5).advance(1)
    assert dense.length.data_ptr() == ptr and int(dense.length) == 6
    paged = PagedKVCache.create(2, 3, 256, 2, 8, dtype=torch.float32, device="cpu")
    ptr = paged.lengths.data_ptr()
    paged.advance_by(torch.tensor([3, 0, 7])).advance()
    assert paged.lengths.data_ptr() == ptr
    assert paged.lengths.tolist() == [4, 1, 8] and paged.lengths.dtype == torch.int32


def test_launch_tally_counts_what_a_capture_records(monkeypatch):
    """Outside a capture a launch adds to the wrapper's count; while the
    stream captures, to the innermost tally; a capture with no tally open
    raises."""
    from vats_tpu_torch.ops import kernels

    class Wrapper:
        launches = 0

    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    kernels.count_launch(Wrapper)
    assert Wrapper.launches == 1
    capturing[0] = True
    with pytest.raises(RuntimeError):
        kernels.count_launch(Wrapper)
    with kernels.launch_tally() as tally:
        for _ in range(3):
            kernels.count_launch(Wrapper)
    assert tally == {Wrapper: 3} and Wrapper.launches == 1


def test_moe_sort_dispatch_counts_without_bincount(monkeypatch):
    """dispatch='sort' counts tokens per expert without torch.bincount (a
    host sync on the card, which a capture cannot hold), and still equals
    the scatter dispatch without drops."""
    from vats_tpu_torch.nn.moe import MoELayer

    layer = MoELayer(16, 32, 4, 2, dispatch="sort", capacity_factor=-1.0,
                     dtype=torch.float32, device="cpu")
    layer.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(3, 5, 16, generator=torch.Generator().manual_seed(1))
    want, _ = layer(x)

    def no_bincount(*a, **k):
        raise AssertionError("bincount on the sort path")

    monkeypatch.setattr(torch, "bincount", no_bincount)
    got, _ = layer(x)
    layer.dispatch = "scatter"
    scattered, _ = layer(x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(got, scattered, rtol=1e-5, atol=1e-6)

