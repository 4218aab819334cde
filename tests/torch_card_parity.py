"""Limits that hold a kernel against its plain version, and a run on the
card against the same run on the CPU.

The card tests in ``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``
(its kernel rows and its multi-rank phases) import these, so both hold a
kernel to one limit; ``tests/test_torch_smoke_parity.py`` shows on the CPU
that the per-leaf checks catch a wrong backward.  No JAX import: they run
where JAX is not installed.
"""

import numpy as np
import torch
import torch.nn.functional as F

from vats_tpu_torch.ops import flash_attention as fa

# Kernel against plain version: fp32 outputs 2e-5 (sums in another order);
# bf16 outputs one bf16 ulp (rtol 1e-2) plus 2e-3 absolute (both accumulate
# in fp32 and round once).  Committed pools and caches must be bit-equal.
TOL = {torch.float32: dict(atol=2e-5, rtol=1e-5),
       torch.bfloat16: dict(atol=2e-3, rtol=1e-2)}
# The bf16 flash backward (fp32 gradients): kernel and plain version round
# the same fp32 p and ds to bf16 before their products; sums in another
# order flip a rounding now and then, one bf16 ulp (2^-8) of a p or ds times
# an input of |x| <= ~5.  A fault in a mask, a tile bound or a descriptor
# gives errors of O(1).
BWD_BF16_TOL = dict(atol=4e-3, rtol=1e-2)
# The decode prologue (K3) against the unfused chain: the same fp32 ops in
# the same order, but for the sum of squares of the QK-norm, whose order
# differs.  bf16 rounds n before the rotation, so a difference shows only
# where it flips that rounding: one bf16 ulp at the pair's magnitude.  fp32
# keeps it: the norm moves by an ulp, each of n1, n2 by up to two, and the
# rotation sums both (4 fp32 ulps at the pair's magnitude).  Without the
# norm the ops are the same: one ulp.
PROLOGUE_ULPS = {(torch.bfloat16, True): 1, (torch.bfloat16, False): 1,
                 (torch.float32, True): 4, (torch.float32, False): 1}


def p_flip_allowance(q, k, v, **kw):
    """Per output element of the bf16 flash forward (K2, K2', K6): how far
    two flipped roundings of p could move it.  Kernel and plain version
    round the same fp32 p to bf16 before P.V, and their fp32 p differ in the
    last bits (exp2 on the special-function unit, sums in another order), so
    now and then a rounding flips: one bf16 ulp, at most 2^-7 p_j, moves the
    output by at most 2^-7 (p_j / l) |v_j|.  The allowance is two such flips
    at the row's largest (p_j / l) |v_j|, dimension by dimension, from the
    plain version's own probabilities: up to 2^-6 |v| in a row over one or
    two keys (a segment's or a window's first queries), where one flip
    exceeds a bf16 ulp of the output, and small in a row over many keys.  A
    key wrongly in or out of the mask moves the output by (p_j / l)
    |v_j - out|: beyond this wherever p_j |v_j - out| exceeds 2^-6 of the
    row's largest p_i |v_i|."""
    b, s, g, d = v.shape
    t, hq = q.shape[1], q.shape[2]
    # the plain version's p_j / l, [B, T, Hq, S]: its output over one-hot
    # values, d keys a call
    probs = torch.empty((b, t, hq, s), device=q.device)
    for c in range(0, s, d):
        w = torch.arange(min(d, s - c), device=v.device)
        onehot = torch.zeros_like(v)
        onehot[:, c + w, :, w] = 1
        probs[..., c:c + len(w)] = fa.flash_attention_ref(q, k, onehot, **kw)[..., :len(w)].float()
    va = v.float().abs()
    top = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    step = max(1, 2**28 // (b * s * d))  # queries a product: <= 1 GiB of fp32
    for h in range(hq):  # max_j (p_j / l) |v_j| per (row, query, dim), a head at a time
        for i in range(0, t, step):
            top[:, i:i + step, h] = (probs[:, i:i + step, h, :, None]
                                     * va[:, None, :, h // (hq // g)]).amax(2)
    return 2.0**-6 * top


def rotated_ulps(got, want, mantissa_bits):
    """|got - want| in ulps of the model dtype at each element's rotated pair
    magnitude sqrt(r1^2 + r2^2): a rounding difference in the normalised
    pair (n1, n2) reaches both rotated elements, however small one is."""
    got, want = got.float(), want.float()
    pm = torch.sqrt(want[..., 0::2] ** 2 + want[..., 1::2] ** 2).repeat_interleave(2, -1)
    ulp = torch.exp2(torch.floor(torch.log2(pm.clamp(min=2.0 ** -126))) - mantissa_bits)
    return (got - want).abs() / ulp


def check_close(label, got, want, limit):
    """Raise unless the kernel's output ``got`` is within ``limit`` of the
    plain version's ``want``: ``"equal"`` (the same values, bit for bit),
    ``dict(atol=, rtol=, extra=None)`` (at every element |got - want| <=
    atol + rtol |want| + extra, where ``extra`` is a per-element allowance
    such as ``p_flip_allowance``), ``dict(ulps=, bits=)`` (``rotated_ulps``
    at a dtype of ``bits`` mantissa bits), or a function (label, got, want)
    that raises.  ``got`` must be finite.  Returns max |got - want|."""
    if callable(limit):
        return limit(label, got, want)
    if got.shape != want.shape:
        raise AssertionError(f"{label}: shape {tuple(got.shape)} where the plain version "
                             f"gives {tuple(want.shape)}")
    err = (got.float() - want.float()).abs()
    worst = float(err.max()) if err.numel() else 0.0
    if limit == "equal":
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: not bit-equal (max |err| {worst:.3e})")
        return worst
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{label}: not finite")
    if "ulps" in limit:
        ulps = float(rotated_ulps(got, want, limit["bits"]).max()) if err.numel() else 0.0
        if not ulps <= limit["ulps"]:
            raise AssertionError(f"{label}: {ulps:.2f} ulps, beyond {limit['ulps']}")
        return worst
    lim = limit["atol"] + limit["rtol"] * want.float().abs()
    if limit.get("extra") is not None:
        lim = lim + limit["extra"]
    if bool((err > lim).any()):
        raise AssertionError(f"{label}: max |err| {worst:.3e} beyond atol {limit['atol']} + "
                             f"rtol {limit['rtol']} * |want|"
                             + (" + the allowance" if limit.get("extra") is not None else ""))
    return worst


def mla_p_allowance(q_abs, pages, table, lengths, scale, v_dim, rows=8):
    """Per output element of K9 (``ops/mla_decode.py``): 2^-7 x the fp32
    softmax's sum of p |v| over l.  K9 rounds each p to bf16 against its
    chunk's running max, the plain version against the row's max: two
    roundings of the same p, each within half a bf16 ulp (2^-8 relative),
    so the p.v sums differ by at most this.  A fault in a mask, a page or a
    tile gives errors of O(|v|)."""
    b, h, w = q_abs.shape
    cap = table.shape[1] * pages.shape[1]
    out = torch.empty((b, h, v_dim), device=q_abs.device)
    pos = torch.arange(cap, device=q_abs.device)
    for r0 in range(0, b, rows):
        r1 = min(b, r0 + rows)
        kv = pages[table[r0:r1].long()].reshape(r1 - r0, cap, w).float()
        s = torch.einsum("bhw,bsw->bhs", q_abs[r0:r1].float(), kv) * scale
        s = torch.where((pos[None, :] < lengths[r0:r1, None])[:, None], s, -torch.inf)
        p = torch.softmax(s, dim=-1).nan_to_num(0.0)
        out[r0:r1] = torch.einsum("bhs,bsv->bhv", p, kv[..., :v_dim].abs())
    return out * 2.0 ** -7


def check_paged_prefill(label, out, want, attends, vmax):
    """K6's output against its plain version (fp32 p, the attention's CPU
    path): a query that attends no key writes 0 (the plain version writes
    the mean of every slot's v there, which nothing reads); every other
    within TOL plus 2^-9 max|v| (K6 rounds each p to bf16 before P V, which
    moves the output by at most 2^-9 max|v|).  ``attends``: bool,
    broadcastable to ``out``.  Returns max |err| where a key is attended."""
    if bool(out.masked_fill(attends, 0).any()):
        raise AssertionError(f"{label}: a query that attends no key is not 0")
    tol = TOL[torch.bfloat16]
    return check_close(label, torch.where(attends, out, 0), torch.where(attends, want, 0),
                       dict(atol=tol["atol"] + 2.0**-9 * vmax, rtol=tol["rtol"]))


def check_routed_experts(label, x, w, idx, wg, wu, wd, n_experts):
    """K7's routed path stage by stage against its plain versions: the
    plan, the gather and the combine bit for bit (integer work; fp32 sums
    over the slots in the same order); K7a and K7b from the same bf16
    operands within TOL (exact bf16 products into fp32 sums in another
    order, the fp32 epilogue rounded once: a flipped rounding, one bf16
    ulp, plus TOL's floor near zero).  Two launches of K7.  Returns max
    |err| of K7a and K7b."""
    from vats_tpu_torch.ops import moe_grouped as mg

    n, k = idx.shape
    plan = mg.route_plan(idx, w, n_experts)
    for name, got, ref in zip(plan._fields, plan, mg.route_plan_ref(idx, w, n_experts)):
        check_close(f"{label} plan {name}", got, ref, "equal")
    rows = mg.gather_rows(x, plan.row_tok)
    check_close(f"{label} gather", rows, x[plan.row_tok.long()], "equal")
    h = mg.moe_grouped_gemm(rows, plan.counts, wg, w_up=wu)
    y = mg.moe_grouped_gemm(h, plan.counts, wd, row_w=plan.row_w)
    tol = TOL[torch.bfloat16]
    err = max(check_close(f"{label} K7a", h,
                          mg.moe_grouped_gemm_ref(rows, plan.counts, wg, w_up=wu), tol),
              check_close(f"{label} K7b", y,
                          mg.moe_grouped_gemm_ref(h, plan.counts, wd, row_w=plan.row_w), tol))
    check_close(f"{label} combine", mg.combine_rows(y, plan.inv, n, k),
                mg.combine_rows_ref(y, plan.inv, n, k), "equal")
    return err


def check_bits(label, got, want):
    """Raise unless each tensor of ``got`` equals its ``want`` bit for bit,
    NaNs too (``torch.equal`` is False on NaN, so the raw bytes are
    compared)."""
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{label}: tensor {i} is {a.dtype} {tuple(a.shape)}, the "
                                 f"plain version's {b.dtype} {tuple(b.shape)}")
        ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        diff = a.detach().reshape(-1).view(ints) != b.detach().reshape(-1).view(ints)
        if bool(diff.any()):
            j = int(diff.nonzero()[0])
            raise AssertionError(
                f"{label}: tensor {i} {tuple(a.shape)} {a.dtype}: {int(diff.sum())} of "
                f"{a.numel()} elements differ from the plain version, the first at {j}: "
                f"{float(a.reshape(-1)[j])!r} against {float(b.reshape(-1)[j])!r}")


def check_adamw(label, opt, count, leaves, scale=None, finite=None, reset_grads=False,
                tables=None):
    """One launch of K8's update (``ops/adamw.adamw_update_``) of ``leaves``
    = (params, grads, mus, nus), four lists updated in place, against the
    plain version run on their clones with the same coefficients (the
    AdamW ``opt``'s at ``count`` applied updates): every tensor bit for bit,
    NaNs too (K8 computes the plain version's operations with its
    roundings)."""
    from vats_tpu_torch.ops import adamw as aw

    flag = finite if finite is not None else torch.ones((), dtype=torch.bool,
                                                        device=count.device)
    k = opt.coefficients(count, flag)
    want = [[t.clone() for t in ts] for ts in leaves]
    aw.adamw_update_ref(*want, k, opt.eps, opt.weight_decay, scale, finite, reset_grads)
    n0 = aw.adamw_update_.launches
    fused = aw.adamw_update_(*leaves, k, opt.eps, opt.weight_decay,
                             tables=tables or aw.LeafTables(), scale=scale, finite=finite,
                             reset_grads=reset_grads)
    if fused != len(leaves[0]) or aw.adamw_update_.launches != n0 + 1:
        raise AssertionError(f"{label}: K8 took {fused} of {len(leaves[0])} leaves in "
                             f"{aw.adamw_update_.launches - n0} launches")
    check_bits(label, [t for ts in leaves for t in ts], [t for ts in want for t in ts])


def check_accumulate(label, accs, grads, count, tables=None):
    """One launch of K8's accumulation step (``ops/adamw.accumulate_``, in
    place) against the plain version on clones of the accumulators: bit
    for bit, NaNs too."""
    from vats_tpu_torch.ops import adamw as aw

    want = [a.clone() for a in accs]
    aw.accumulate_ref(want, grads, count)
    n0 = aw.accumulate_.launches
    fused = aw.accumulate_(accs, grads, count, tables=tables or aw.LeafTables())
    if fused != len(accs) or aw.accumulate_.launches != n0 + 1:
        raise AssertionError(f"{label}: K8 took {fused} of {len(accs)} leaves in "
                             f"{aw.accumulate_.launches - n0} launches")
    check_bits(label, accs, want)


# Train steps, bf16 compute on both sides; the card and the CPU round their
# matmul sums at other places.  The loss is a mean over ~1000 tokens of
# ~ln(65536) = 11.1: 0.02 is 0.2%.  The global norm sums those rounding
# differences over every gradient: 5% relative.  Adam normalises each step
# to at most ~lr per element whatever the gradient's size, so two runs whose
# small gradients differ in sign can part by at most 2 lr per applied step:
# params are held to 2 x (sum of the lr applied so far) + 1e-6.  That bound
# cannot see a wrong gradient; the test is per leaf, before the update: each
# parameter's gradient card against CPU, ||g_card - g_cpu|| / ||g_cpu||, and
# each parameter's change since the start, ||d_card - d_cpu|| / ||d_cpu||.
# The change is ~lr x sign(g) per element after Adam's first step, so it
# moves by 2 lr on each element whose small gradient flips sign; a wrong
# gradient gives ~1.4 (unrelated) to 2 (negated).  Read on an H100 (worst
# leaf): gradients 9.8e-3 (steps 0-1) and 1.6e-2 (step 2, params already
# apart) for medium_dense at 2 layers, 6.5e-3 for ViT-2D; the change 7.2e-2
# and 6.0e-2.  The limits are ~2.5x the worst of them.
PARITY_LOSS_ATOL, PARITY_NORM_RTOL = 0.02, 0.05
PARITY_LEAF_GRAD_RTOL, PARITY_LEAF_CHANGE_RTOL = 0.04, 0.2

# Generation, bf16 on both sides: two layers at full width carry the
# rounding differences to the logits, which are O(1) here (tied readout of
# std-0.02 embeddings over a unit-RMS state).
LOGIT_ATOL = 0.08
# An MoE router picks its top-k experts from fp32 probabilities that the
# card and the CPU compute slightly apart.  Where the k-th and the next
# expert are closer than that, the two sides pick different experts for the
# token, and its logits move by far more than LOGIT_ATOL.  Such a flip is
# excused only as a near tie on both sides: every flipped expert's
# probability within twice the token's own card-CPU probability gap of the
# k-th.  It excuses the logit bound at its row's step and, when it was below
# the last layer (whose K/V carry it), at that row's later steps; at most
# ROUTER_EXCUSED (row, step) pairs may be excused, and the greedy tokens are
# held at every step.
ROUTER_EXCUSED = 1


def leaf_grad(name, p):
    return p.grad if p.grad is not None else p.new_zeros(p.shape)


def leaf_errors(card, cpu, of):
    """{name: ||of(name, a) - of(name, b)|| / ||of(name, b)||} over the two
    models' matching parameters (``of`` picks the gradient or the change),
    in fp32 on the CPU; 0 where both are zero, inf where only the card's is
    not."""
    out = {}
    for (name, a), (_, b) in zip(card.named_parameters(), cpu.named_parameters()):
        a, b = of(name, a).detach().cpu().float(), of(name, b).detach().float()
        d, n = float((a - b).norm()), float(b.norm())
        out[name] = d / n if n > 0 else (0.0 if d == 0 else float("inf"))
    return out


def leaf_report(label, errs, limit):
    """The worst leaf and the median of ``errs``; raises where any leaf is
    beyond ``limit`` (or not a number)."""
    name, worst = max(errs.items(), key=lambda kv: kv[1])
    median = sorted(errs.values())[len(errs) // 2]
    bad = sorted(n for n, e in errs.items() if not e <= limit)
    msg = (f"{label}: worst leaf {name} {worst:.3e}, median {median:.3e} over "
           f"{len(errs)} (limit {limit})")
    if bad:
        raise AssertionError(f"{msg}; beyond it: {bad}")
    return msg


def serve_stream(seed, vocab, n_shared, n_alone, prefix_len, shared_own, alone_own,
                 new_tokens):
    """[(prompt ids, max_new_tokens)], shared-prefix and unshared requests
    interleaved, every length and token drawn from ``seed`` (numpy, so the
    stream is the same on any device)."""
    rs = np.random.RandomState(seed)
    prefix = rs.randint(1, vocab, prefix_len).tolist()
    kinds = [True] * n_shared + [False] * n_alone
    rs.shuffle(kinds)
    out = []
    for shared in kinds:
        lo, hi = shared_own if shared else alone_own
        own = rs.randint(1, vocab, rs.randint(lo, hi + 1)).tolist()
        out.append(((prefix if shared else []) + own,
                    int(rs.randint(new_tokens[0], new_tokens[1] + 1))))
    return out


def router_log(model):
    """Forward hooks on the model's routers: returns (calls, handles); every
    router call appends (experts [tokens, k], probabilities [tokens, E]) on
    the CPU to ``calls``.  The hook recomputes the router's probabilities
    with the router's own expression and checks that they give its experts
    and weights bit for bit."""
    from vats_tpu_torch.nn.moe import TopKRouter

    calls = []

    def hook(mod, args, out):
        probs = torch.softmax(F.linear(args[0].float(), mod.router.weight.float(),
                                       mod.router.bias.float()), dim=-1)
        vals, idx = torch.topk(probs, mod.top_k, dim=-1)
        weights = (vals / vals.sum(dim=-1, keepdim=True)).to(mod.dtype)
        assert torch.equal(idx, out[1]) and torch.equal(weights, out[0]), \
            "router hook: probabilities other than the router's"
        calls.append((out[1].cpu(), probs.cpu()))

    return calls, [m.register_forward_hook(hook) for m in model.modules()
                   if isinstance(m, TopKRouter)]


def router_flips(name, calls_g, calls_c, layers, t, last, steps):
    """The (row, step) pairs a router flip excuses, a report of every flip,
    and the largest card-CPU probability gap at each layer's router.
    Router call j is layer j % layers of forward j // layers (0: the prefill
    of t tokens a row, read out at ``last``; then one decode step a
    forward).  Raises on a flip that is not a near tie on both sides, and on
    more than ROUTER_EXCUSED excused pairs."""
    excused, seen, gap_max = set(), [], [0.0] * layers
    for j, ((eg, pg), (ec, pc)) in enumerate(zip(calls_g, calls_c)):
        step, layer = divmod(j, layers)
        k = eg.shape[1]
        gaps = (pg - pc).abs().amax(dim=-1)  # [tokens]
        gap_max[layer] = max(gap_max[layer], float(gaps.max()))
        for tok in range(eg.shape[0]):
            diff = set(eg[tok].tolist()) ^ set(ec[tok].tolist())
            if not diff:
                continue
            gap = float(gaps[tok])
            for probs in (pg[tok], pc[tok]):
                kth = float(probs.topk(k).values[-1])
                assert all(abs(float(probs[e]) - kth) <= 2 * gap for e in diff), (
                    f"{name}: router call {j} token {tok} picks other experts on the card "
                    f"and the CPU, not a near tie")
            row, pos = divmod(tok, t) if step == 0 else (tok, None)
            seen.append(f"forward {step} layer {layer} row {row}"
                        + (f" position {pos}" if pos is not None else "")
                        + f" (gap {gap:.1e})")
            if step == 0 and pos != int(last[row]):
                continue  # a prefill position the readout does not read
            excused.update((row, s) for s in range(step, steps if layer < layers - 1
                                                    else step + 1))
    assert len(excused) <= ROUTER_EXCUSED, (
        f"{name}: router flips excuse (row, step) {sorted(excused)}, more than "
        f"{ROUTER_EXCUSED}")
    return excused, seen, gap_max


def compare_greedy(name, tok_gpu, tok_cpu, logit_c, logit_g):
    """Greedy tokens on the card against the CPU's, step by step.

    The CPU's tokens are the argmax of its teacher-forced logits (generate
    and stepping the model agree).  Teacher-forced on those tokens, the
    card's argmax must be the CPU's token or a near tie: a token whose CPU
    logit is within 2 * LOGIT_ATOL of the CPU maximum (random-weight logits
    over 65536 ids have top-2 gaps of that order, which bf16 may flip).  The
    card's own free-running tokens must equal the CPU's up to their first
    difference, and that difference must be such a tie.  Returns (equal
    teacher-forced tokens, near ties, equal free-running tokens)."""
    b, steps, _ = logit_c.shape
    top_c = logit_c.max(dim=-1).values
    amax_g = logit_g.argmax(dim=-1)
    exact = ties = free = 0
    for r in range(b):
        for s in range(steps):
            tc, tg = int(tok_cpu[r, s]), int(amax_g[r, s])
            assert int(logit_c[r, s].argmax()) == tc, \
                f"{name}: CPU generate disagrees with its logits"
            if tg == tc:
                exact += 1
            else:
                assert float(logit_c[r, s, tg]) >= float(top_c[r, s]) - 2 * LOGIT_ATOL, (
                    f"{name}: row {r} step {s}: card picks {tg}, CPU {tc}, not a near tie")
                ties += 1
        for s in range(steps):
            tg = int(tok_gpu[r, s])
            if tg != int(tok_cpu[r, s]):
                assert float(logit_c[r, s, tg]) >= float(top_c[r, s]) - 2 * LOGIT_ATOL, (
                    f"{name}: row {r} free-running token {s} differs beyond a near tie")
                break
            free += 1
    return exact, ties, free


def first_difference_is_a_near_tie(name, got, want, gaps):
    """Codes [B, steps] drawn greedily on the card (``got``) and on the CPU
    (``want``) are equal up to the first step where they differ in any row,
    and there the CPU's top-two logit gap ``gaps`` [B, steps] is within
    2 * LOGIT_ATOL in some row.  Returns that step, or None where all are
    equal."""
    same = (got == want).all(0)
    if bool(same.all()):
        return None
    first = int((~same).nonzero()[0])
    assert bool((gaps[:, first] <= 2 * LOGIT_ATOL).any()), (
        f"{name}: codes differ at step {first} beyond a near tie "
        f"(CPU top-2 gap {float(gaps[:, first].min()):.3e})")
    return first
