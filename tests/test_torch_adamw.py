"""K8's host side on the CPU (``ops/adamw.py``): the chunk plan covers every
element of every leaf once (the kernel's walk mirrored in Python), CPU tensors take the plain per-leaf path (and
the optimizers' tallies say so), the checks refuse what the kernel cannot
take on either device, and a leaf table is never built inside a capture.
K8 itself runs on the card only (``tests/test_torch_cuda_kernels.py``,
``-k "adamw or accumulation"``, holds it to the plain path bit for bit)."""

import pytest
import torch

from vats_tpu_torch.ops import adamw as aw
from vats_tpu_torch.train.optimizer import (
    AdamW,
    ClipAndSkipNonFinite,
    MultiSteps,
    cosine_with_warmup_schedule,
)

C = aw.CHUNK


def medium_moe_numels():
    """vats_medium_moe's leaf lengths (the training cells' model: 122
    leaves, the tied 65,536 x 768 embedding down to the routers' 8 biases)."""
    from vats_tpu_torch.configs import nlp_medium
    from vats_tpu_torch.models import TextLM

    cfg = nlp_medium(d_model=768, num_heads=12, query_groups=4, d_ffn=3072, num_layers=12,
                     num_experts=8, top_k=2, left_window=-1, max_seq_len=2048)
    return [p.numel() for p in TextLM(cfg, device="meta").parameters()]


PLANS = {
    "odd": [1, 3, 5 * 7, 0, C, C + 1, C - 1, 2 * C + 6, 4, 2, 768],
    "one_element": [1],
    "empty_leaves_between": [0, 0, 9, 0, C + 3, 0],
    "vats_medium_moe": None,
}


def walk(numels, grid):
    """(leaf, start, vector end, end) of each chunk as K8's CTAs walk them
    over a grid of ``grid`` CTAs, with csrc/adamw.cu's arithmetic: CTA b
    takes chunks b, b + grid, ... and finds each chunk's leaf by walking the
    table forward; 4-element steps up to the vector end, one element a step
    after it."""
    chunk0, n_chunks = aw.chunk_starts(numels)
    for b in range(grid):
        leaf = 0
        for c in range(b, n_chunks, grid):
            while leaf + 1 < len(numels) and chunk0[leaf + 1] <= c:
                leaf += 1
            start = (c - chunk0[leaf]) * C
            end = min(start + C, numels[leaf])
            yield leaf, start, start + ((end - start) & ~3), end


@pytest.mark.parametrize("grid", [1, 7, 528])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_chunk_plan_covers_every_element_once(name, grid):
    """K8's walk over the chunk plan: every element of every leaf exactly
    once; 4-element steps start at multiples of 4 within the leaf, and only
    a leaf's last chunk has a scalar tail (1 to 3 elements)."""
    numels = PLANS[name] or medium_moe_numels()
    if name == "vats_medium_moe":
        assert len(numels) == 122 and sum(numels) == 748_785_504
    assert aw.chunk_starts(numels)[1] == sum(-(-n // C) for n in numels)
    spans = {i: [] for i in range(len(numels))}
    for leaf, start, vend, end in walk(numels, grid):
        assert start % 4 == 0 and (vend - start) % 4 == 0 and start <= vend <= end
        assert end - vend < 4 and (vend == end or end == numels[leaf])
        assert end - start <= C
        spans[leaf].append((start, end))
    for i, n in enumerate(numels):
        at = 0
        for start, end in sorted(spans[i]):
            assert start == at, f"leaf {i}: a gap or an overlap at {at}"
            at = end
        assert at == n, f"leaf {i}: {at} of {n} elements covered"


def test_cpu_leaves_take_the_plain_path_and_the_tallies_say_so():
    """MultiSteps(ClipAndSkipNonFinite(AdamW)) on CPU tensors over a window:
    no K8 launch, every leaf counted plain by the accumulation and the
    update; the window's params equal the plain functions run by hand."""
    g = torch.Generator().manual_seed(0)
    shapes = [(5, 7), (11,), (1,), (2, 4099)]
    params = {i: torch.randn(s, generator=g) for i, s in enumerate(shapes)}
    want = {i: p.clone() for i, p in params.items()}
    adamw = AdamW(cosine_with_warmup_schedule(1e-3, 1, 20), b1=0.9, b2=0.95, eps=1e-6,
                  weight_decay=5e-4, mu_dtype=torch.bfloat16)
    tx = MultiSteps(ClipAndSkipNonFinite(1.0, adamw), 4)
    st = tx.init(params)
    n0 = (aw.adamw_update_.launches, aw.accumulate_.launches)
    accs = [torch.zeros_like(p) for p in want.values()]
    for pos in range(4):
        grads = {i: 1e-2 * torch.randn(s, generator=g) for i, s in enumerate(shapes)}
        tx.update_(params, grads, st)
        aw.accumulate_ref(accs, list(grads.values()), pos + 1)
        assert (tx.leaves_fused, tx.leaves_plain) == (0, len(shapes))
    assert (adamw.leaves_fused, adamw.leaves_plain) == (0, len(shapes))
    assert (aw.adamw_update_.launches, aw.accumulate_.launches) == n0
    assert all(not bool(a.any()) for a in st.acc_grads.values())  # reset by the update
    ref = adamw.init(want)
    gnorm = torch.linalg.vector_norm(torch.stack([a.norm() for a in accs]))
    scale = torch.clamp(1.0 / gnorm, max=1.0)
    flag = torch.ones((), dtype=torch.bool)
    aw.adamw_update_ref(list(want.values()), accs, list(ref.mu.values()),
                        list(ref.nu.values()), adamw.coefficients(ref.count, flag), adamw.eps,
                        adamw.weight_decay, scale, flag)
    for i in params:
        torch.testing.assert_close(params[i], want[i], rtol=1e-6, atol=1e-7)


def _leaves():
    """One (8, 6) leaf: fp32 param, grad and nu, a bf16 mu."""
    return ([torch.zeros(8, 6)], [torch.zeros(8, 6)], [torch.zeros(8, 6, dtype=torch.bfloat16)],
            [torch.zeros(8, 6)])


def _coeffs(device="cpu"):
    return aw.Coeffs(*(torch.ones((), device=device) for _ in aw.Coeffs._fields))


@pytest.mark.parametrize("bad", ["non_contiguous_param", "non_contiguous_grad",
                                 "mixed_devices", "coefficients_elsewhere", "grad_dtype",
                                 "nu_dtype", "int_param", "grad_shape"])
def test_the_wrapper_raises_on_leaves_k8_cannot_take(bad):
    """The checks hold on the CPU as on the card, so a CPU run refuses what
    K8 would: a non-contiguous param or grad, leaves on two devices (the
    meta device beside the CPU stands for the card here), coefficients on
    another device, a grad or nu in another dtype than its param, an int
    param, a grad of another shape.  Nothing is updated."""
    p, g, mu, nu = _leaves()
    k = _coeffs()
    if bad == "non_contiguous_param":
        p = [torch.zeros(6, 8).t()]
    elif bad == "non_contiguous_grad":
        g = [torch.zeros(6, 8).t()]
    elif bad == "mixed_devices":
        g = [torch.zeros(8, 6, device="meta")]
    elif bad == "coefficients_elsewhere":
        k = _coeffs("meta")
    elif bad == "grad_dtype":
        g = [g[0].bfloat16()]
    elif bad == "nu_dtype":
        nu = [nu[0].bfloat16()]
    elif bad == "int_param":
        p, g, nu = ([torch.zeros(8, 6, dtype=torch.int32)] for _ in range(3))
    elif bad == "grad_shape":
        g = [torch.zeros(48)]
    with pytest.raises(ValueError):
        aw.adamw_update_(p, g, mu, nu, k, 1e-6, 0.0, tables=aw.LeafTables())
    if bad in ("non_contiguous_grad", "mixed_devices", "grad_dtype", "grad_shape"):
        with pytest.raises(ValueError):
            aw.accumulate_([torch.zeros(8, 6)], g, 2, tables=aw.LeafTables())


def test_a_leaf_table_is_built_outside_a_capture_and_kept_for_its_replays(monkeypatch):
    """A table is built eagerly (the H2D copy) and found again for the same
    tensors; a capture that finds none raises; a table a capture used
    outlives the next eager build, one only eager calls used does not."""
    tables = aw.LeafTables()
    a = [(torch.zeros(5), torch.zeros(5))]
    b = [(torch.zeros(C + 3), torch.zeros(C + 3))]
    table, chunks = tables.get(a, [0])
    assert chunks == 1 and table.shape == (1, aw.ROW)
    assert table[0, :2].tolist() == [t.data_ptr() for t in a[0]]
    assert table[0, 4:7].tolist() == [5, 0, 0]
    assert tables.get(a, [0])[0] is table
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="before this CUDA graph capture"):
        tables.get(b, [0])
    assert tables.get(a, [0])[0] is table  # a capture reads it: kept
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    tb, chunks_b = tables.get(b, [0])
    assert chunks_b == 2
    c = [(torch.zeros(7), torch.zeros(7))]
    tables.get(c, [0])  # an eager-only table gives way to the next
    assert tables.get(a, [0])[0] is table
    assert tables.get(b, [0])[0] is not tb
