"""Ring and Ulysses attention against ``vats_tpu``, on 2 and 4 gloo ranks.

One spawn of 2 ranks and one of 4 (``tests/torch_parallel_ranks.py``) run
every case on the rank's shard of the same seeded inputs; this process
joins the shards and holds them against the JAX package on its fake CPU
mesh.  Tolerances:

  * fp32 outputs against the JAX oracle ``dot_product_attention`` and the
    JAX ring: rtol 2e-4, atol 2e-5; gradients against ``jax.grad`` of the
    oracle: rtol 5e-4, atol 5e-5 (the JAX ring tests' own bounds: sums in
    another order and the per-hop merge);
  * bf16 against the JAX ring-flash (interpret mode), which rounds p and
    each hop's output to bf16 as the port does: 2e-2 absolute plus 2e-2
    relative, a few bf16 ulps of outputs of |o| < ~2 where another order
    of the fp32 sums moves a rounding.

The JAX ring-flash runs in interpret mode (10-16 s a call), so two
composed cases meet it, fp32 at 2 ranks and bf16 at 4, between them every
feature (GQA, windows, the wrapped hops' negative offsets, ragged key
validity, segment ids).  Each feature alone is held against the oracle at
both ring sizes, with gradients.  Plus the pure logic: ``_ring_steps`` and ``_merge`` against
JAX's.

The blockwise ring (``impl="xla"``, the cases named ``blockwise_*``) at
both ring sizes: fp32 outputs against JAX's ``impl="xla"`` ring and the
oracle, gradients against ``jax.grad`` of the oracle (the tolerances
above); several tiles a shard (the q_chunk / k_chunk pairs of
``tests/test_ring_attention.py``'s chunking test, at its T = 64), windows
that bound the hops taken, ragged key validity; bf16 against JAX's bf16
blockwise ring, output at the bf16 tolerance above and gradients against
``jax.grad`` of it within 6e-2 absolute plus 2e-2 relative (JAX rounds each
tile's dq / dk / dv to bf16 and sums them in bf16, the port sums in fp32
and rounds once: a few bf16 ulps of gradients up to |g| ~ 4); the
refusal of segment ids and of an unknown impl before any collective."""

import functools
import importlib
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parallel_ranks import Ranks
from vats_tpu.ops import dot_product_attention as j_attention
from vats_tpu.ops.ulysses import ulysses_attention as j_ulysses
from vats_tpu.parallel import create_mesh as j_create_mesh

j_ring_mod = importlib.import_module("vats_tpu.ops.ring_attention")
ring_mod = importlib.import_module("vats_tpu_torch.ops.ring_attention")

torch.set_num_threads(1)

F32 = dict(rtol=2e-4, atol=2e-5)
F32_GRAD = dict(rtol=5e-4, atol=5e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
BF16_GRAD = dict(rtol=2e-2, atol=6e-2)
B, T, D = 2, 32, 16


def _inputs(seed, hq, g, t=T):
    rng = np.random.RandomState(seed)
    return dict(q=rng.randn(B, t, hq, D).astype(np.float32),
                k=rng.randn(B, t, g, D).astype(np.float32),
                v=rng.randn(B, t, g, D).astype(np.float32),
                do=rng.randn(B, t, hq, D).astype(np.float32))


# every causal row keeps a valid key in its window where a case meets the
# oracle (whose row with no key averages V where the ring gives 0)
VALID = np.arange(T)[None, :] < np.array([[29], [13]])
SEG = np.stack([np.r_[np.zeros(13), np.ones(19)],
                np.r_[np.zeros(20), np.ones(12)]]).astype(np.int32)

# name: (impl, dtype, heads (Hq, G), attention keywords, key validity, segment ids,
#        the JAX reference: 'oracle' (with gradients), 'ring' (flash), 'ring_xla',
#        'ulysses').  impl 'ring' is the port's one ring (on CPU tensors every
#        hop runs the kernels' plain versions); the JAX blockwise ring ('ring_xla')
#        computes the same function, and its chunk sizes (JAX_ONLY) go to it alone.
CASES = {
    "causal_gqa": ("ring", "float32", (4, 2), dict(causal=True), None, None, "oracle"),
    "left_window": ("ring", "float32", (4, 2), dict(causal=True, left_window=10),
                    None, None, "oracle"),
    "noncausal_right_window": ("ring", "float32", (4, 2),
                               dict(causal=False, left_window=10, right_window=6),
                               None, None, "oracle"),
    "noncausal_full": ("ring", "float32", (4, 4), dict(causal=False), None, None,
                       "oracle"),
    "ragged_valid": ("ring", "float32", (4, 2), dict(causal=True), VALID, None, "oracle"),
    "segments": ("ring", "float32", (4, 2), dict(causal=True, left_window=11), None,
                 SEG, "oracle"),
    # a window and ragged validity together
    "plain_ring": ("ring", "float32", (4, 2), dict(causal=True, left_window=20), VALID,
                   None, "oracle"),
    "xla_causal_window": ("ring", "float32", (4, 2),
                          dict(causal=True, left_window=20, q_chunk=4, k_chunk=8), None,
                          None, "ring_xla"),
    "xla_noncausal_valid": ("ring", "float32", (4, 2),
                            dict(causal=False, right_window=6), VALID, None, "ring_xla"),
    "ulysses": ("ulysses", "float32", (8, 4), dict(causal=True, left_window=10), VALID,
                None, "ulysses"),
    # the port's blockwise ring ('ring_xla'), tiles of q_chunk x k_chunk
    "blockwise_chunks_4x8": ("ring_xla", "float32", (4, 2),
                             dict(causal=True, left_window=20, q_chunk=4, k_chunk=8), None,
                             None, "ring_xla"),
    "blockwise_chunks_8x4": ("ring_xla", "float32", (4, 2),
                             dict(causal=True, left_window=20, q_chunk=8, k_chunk=4), None,
                             None, "ring_xla"),
    "blockwise_chunks_16x16": ("ring_xla", "float32", (4, 2),
                               dict(causal=True, left_window=20, q_chunk=16, k_chunk=16),
                               None, None, "ring_xla"),
    "blockwise_window_hops": ("ring_xla", "float32", (4, 2),
                              dict(causal=True, left_window=5, q_chunk=4, k_chunk=4), None,
                              None, "ring_xla"),
    "blockwise_ragged_valid": ("ring_xla", "float32", (4, 2),
                               dict(causal=True, q_chunk=4, k_chunk=4), VALID, None,
                               "ring_xla"),
    "blockwise_noncausal_valid": ("ring_xla", "float32", (4, 2),
                                  dict(causal=False, right_window=6, q_chunk=8, k_chunk=4),
                                  VALID, None, "ring_xla"),
    "blockwise_noncausal_windows": ("ring_xla", "float32", (4, 4),
                                    dict(causal=False, left_window=10, right_window=6), None,
                                    None, "ring_xla"),
    "blockwise_bf16": ("ring_xla", "bfloat16", (4, 2),
                       dict(causal=True, left_window=11, q_chunk=4, k_chunk=8), VALID, None,
                       "ring_xla_grad"),
}
# the chunking cases' sequence length (tests/test_ring_attention.py's T = 64)
CASE_T = {f"blockwise_chunks_{c}": 64 for c in ("4x8", "8x4", "16x16")}
# composed cases held against the JAX ring-flash (seconds a call in interpret
# mode), one per ring size: fp32 at 2 ranks, bf16 at 4
JAX_RING_CASES = {
    2: {"ring_gqa_window_valid_segments": ("ring", "float32", (4, 2),
                                           dict(causal=True, left_window=11), VALID, SEG,
                                           "ring")},
    4: {"ring_noncausal_windows_valid_segments_bf16": (
        "ring", "bfloat16", (4, 2), dict(causal=False, left_window=10, right_window=6),
        VALID, SEG, "ring")},
}


JAX_ONLY = ("q_chunk", "k_chunk")


def _cases(n):
    return dict(CASES, **JAX_RING_CASES[n])


def _payload(n):
    out = []
    for name, (impl, dtype, (hq, g), kw, valid, seg, ref) in sorted(_cases(n).items()):
        # a case's inputs at every n
        x = _inputs(zlib.crc32(name.encode()), hq, g, CASE_T.get(name, T))
        out.append(dict(name=name, impl=impl, dtype=dtype, q=x["q"], k=x["k"], v=x["v"],
                        do=x["do"] if ref != "ring" else None, valid=valid, seg=seg,
                        kw=_kw(kw, JAX_ONLY if impl != "ring_xla" else ())))
    out.append(dict(name="ulysses_indivisible_heads", impl="ulysses", dtype="float32",
                    expect_error=True, kw=dict(scale=0.25),
                    **{k: v for k, v in _inputs(99, 2, 1).items() if k != "do"}))
    x = {k: v for k, v in _inputs(98, 4, 2).items() if k != "do"}
    out.append(dict(name="blockwise_segment_ids", impl="ring_xla", dtype="float32",
                    expect_error=True, seg=SEG, kw=dict(scale=0.25), **x))
    out.append(dict(name="ring_unknown_impl", impl="ring", dtype="float32",
                    expect_error=True, kw=dict(scale=0.25, impl="blocked"), **x))
    return out


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory):
    """(n, {name: case}, each rank's results, {name: JAX reference}): the
    JAX references are computed while the ranks run."""
    n = request.param
    payload = _payload(n)
    running = Ranks("attention_cases", n, tmp_path_factory.mktemp(f"ring{n}"), payload)
    cases = {c["name"]: c for c in payload}
    refs = {name: _references(n, cases[name]) for name in _cases(n)}
    return n, cases, running.results(), refs


def _kw(kw, drop=()):
    return dict({k: v for k, v in kw.items() if k not in drop}, scale=D ** -0.5)


def _joined(got, name, key):
    return np.concatenate([r[name][key] for r in got], axis=1)


def _jax_reference(n, case, kw, valid, seg, ref):
    dt = jnp.bfloat16 if case["dtype"] == "bfloat16" else jnp.float32
    q, k, v = (jnp.asarray(case[x], dt) for x in ("q", "k", "v"))
    kw = dict(kw)
    masks = {}
    if valid is not None:
        masks["kv_valid"] = jnp.asarray(valid)
    if seg is not None:
        masks["q_segment_ids"] = masks["kv_segment_ids"] = jnp.asarray(seg)
    if ref == "oracle":
        return _oracle(case["name"])
    mesh = j_create_mesh(data=1, fsdp=1, expert=1, tensor=1, seq=n,
                         devices=jax.devices()[:n])
    if ref == "ulysses":
        return np.asarray(j_ulysses(q, k, v, mesh=mesh, **kw, **masks)), None
    impl = "xla" if ref.startswith("ring_xla") else "flash"

    def ring(a, b, c):
        return j_ring_mod.ring_attention(a, b, c, mesh=mesh, impl=impl, **kw, **masks)

    out = np.asarray(ring(q, k, v), np.float32)
    if ref != "ring_xla_grad":
        return out, None
    w = jnp.asarray(case["do"], dt)
    grads = jax.grad(lambda a, b, c: jnp.sum((ring(a, b, c) * w).astype(jnp.float32)),
                     argnums=(0, 1, 2))(q, k, v)
    return out, [np.asarray(x, np.float32) for x in grads]


@functools.lru_cache(maxsize=None)
def _oracle(name):
    """The JAX oracle's output and gradients of one case of CASES (the same
    at every ring size)."""
    case = next(c for c in _payload(2) if c["name"] == name)
    _, _, _, _, valid, seg, _ = CASES[name]
    kw = {k: v for k, v in case["kw"].items() if k not in JAX_ONLY}  # no tiles there
    if valid is not None:
        kw["kv_valid"] = jnp.asarray(valid)
    if seg is not None:
        kw["q_segment_ids"] = kw["kv_segment_ids"] = jnp.asarray(seg)
    fn = functools.partial(j_attention, **kw)
    q, k, v, w = (jnp.asarray(case[x]) for x in ("q", "k", "v", "do"))
    out = fn(q, k, v)
    grads = jax.grad(lambda a, b, c: jnp.sum(fn(a, b, c) * w), argnums=(0, 1, 2))(q, k, v)
    return np.asarray(out, np.float32), [np.asarray(x) for x in grads]


def _references(n, case):
    """(JAX output, JAX oracle gradients or None) of one case."""
    _, _, _, kw, valid, seg, ref = _cases(n)[case["name"]]
    want, grads = _jax_reference(n, case, _kw(kw), valid, seg, ref)
    if grads is None and case["do"] is not None:  # xla ring and Ulysses
        grads = _oracle(case["name"])[1]
    return want, grads


def _check(ranks, name):
    n, cases, got, refs = ranks
    impl, dtype = _cases(n)[name][:2]
    want, grads = refs[name]
    bf16 = dtype == "bfloat16"
    out = _joined(got, name, "out")
    np.testing.assert_allclose(out, want, err_msg=name, **(BF16 if bf16 else F32))
    if impl == "ring_xla" and not bf16:  # the blockwise ring: the oracle too
        np.testing.assert_allclose(out, _oracle(name)[0], err_msg=f"{name} oracle", **F32)
    if grads is not None:
        for key, g in zip(("dq", "dk", "dv"), grads):
            np.testing.assert_allclose(_joined(got, name, key), g, err_msg=f"{name} {key}",
                                       **(BF16_GRAD if bf16 else F32_GRAD))


@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_and_ulysses_match_jax(ranks, name):
    _check(ranks, name)


def test_ring_flash_matches_the_jax_ring_flash(ranks):
    (name,) = JAX_RING_CASES[ranks[0]]
    _check(ranks, name)


def test_ulysses_rejects_indivisible_heads_before_any_collective(ranks):
    for r in ranks[2]:
        res = r["ulysses_indivisible_heads"]
        assert res["error"] is not None and "divisible" in res["error"]
        assert res["calls"] == 0


def test_blockwise_ring_refuses_segment_ids_and_unknown_impls(ranks):
    """As JAX's ``ring_attention``: segment ids need the flash ring
    (NotImplementedError), an unknown impl is a ValueError; no collective
    runs first."""
    for r in ranks[2]:
        seg, unknown = r["blockwise_segment_ids"], r["ring_unknown_impl"]
        assert seg["type"] == "NotImplementedError" and "segment ids" in seg["error"]
        assert unknown["type"] == "ValueError" and "blocked" in unknown["error"]
        assert seg["calls"] == unknown["calls"] == 0


def test_blockwise_ring_takes_only_the_window_bounded_hops(ranks):
    """Causal with left_window 5: JAX's trip count 1 + (5 + tl - 1) // tl
    hops (2 of 4 at tl = 8), each rank shifting K/V after every hop but the
    last, and the backward shifting their gradients back as often."""
    n, _, got, _ = ranks
    tl = T // n
    hops = min(n, 1 + (5 + tl - 1) // tl)
    assert hops == 2
    for name in ("blockwise_window_hops", "blockwise_ragged_valid"):
        want = 2 * ((hops if name == "blockwise_window_hops" else n) - 1)
        assert [r[name]["calls"] for r in got] == [want] * n, name


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("tl", [16, 100, 384])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_steps_match_jax(n, tl, causal):
    for lw in (-1, 0, 10, tl - 1, tl, 383, 3 * tl):
        for rw in (-1, 0, 5, tl, 2 * tl + 7):
            kw = dict(axis_name="seq", n_seq=n, t_local=tl, scale=0.1, causal=causal,
                      left_window=lw, right_window=rw, use_segids=False)
            want = j_ring_mod._ring_steps(j_ring_mod._RingCfg(
                block_q=128, block_k=128, bwd_block_q=0, bwd_block_k=0, interpret=True,
                **kw))
            assert ring_mod._ring_steps(ring_mod._RingCfg(**kw)) == want, (lw, rw)


def test_merge_matches_jax():
    """fp32 (o, lse) merge with the kernel's 1e30 sentinel, rows without
    mass on one side or both (-inf), and a bf16 hop output."""
    rng = np.random.RandomState(3)
    b, h, t, d = 2, 3, 5, 8
    o = rng.randn(b, h, t, d).astype(np.float32)
    o_i = rng.randn(b, h, t, d).astype(np.float32)
    lse = rng.randn(b, h, t).astype(np.float32)
    lse_i = rng.randn(b, h, t).astype(np.float32) + 2
    lse[:, :, 0] = -np.inf          # no mass yet
    lse_i[:, :, 1] = 1e30           # the hop's row attends nothing
    lse[:, :, 2], lse_i[:, :, 2] = -np.inf, 1e30  # neither side
    lse_i[0, 1, 3] = 1e30
    for dt in (jnp.float32, jnp.bfloat16):
        jo, jl = j_ring_mod._merge(jnp.asarray(o), jnp.asarray(lse),
                                   jnp.asarray(o_i, dt), jnp.asarray(lse_i))
        to, tl_ = ring_mod._merge(torch.tensor(o).transpose(1, 2), torch.tensor(lse),
                                  torch.tensor(o_i).to(getattr(torch, jnp.dtype(dt).name))
                                  .transpose(1, 2), torch.tensor(lse_i))
        np.testing.assert_allclose(to.transpose(1, 2).numpy(), np.asarray(jo),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(np.isfinite(tl_.numpy()), np.isfinite(np.asarray(jl)))
        np.testing.assert_allclose(tl_.numpy(), np.asarray(jl), rtol=1e-6)
        assert np.all(to.numpy()[:, 2] == 0)
