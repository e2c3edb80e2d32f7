"""Work of one ``post_fit`` call (the post-split fit of every lane), frozen:
`ect_work`, `post_fit_ops` and `post_fit_bytes` as
``misti_tpu_torch/kernels/post_fit.py`` had them at commit 4de6f0d, counted
on the reference's plain solves.  No metric reads them yet: they are kept so
that a reader of the post-split fit's roofline finds the yardstick fixed."""

from __future__ import annotations

import torch

from benchmark.reference.correction import fit_single_pop
from benchmark.reference.likelihood import _POST_OUTERS

_EXPAND_ITERS = 40  # the reference's fit_single_pop's


EXP_OPS = 20  # exp, expm1, log1p: a range reduction and a polynomial
DEV_OPS = 11  # one residual evaluation at its cheaper form
PREFIX_OPS = 2  # a row's T lc and its add to the prefix
WEIGHT_OPS = 2 + 1 + 2 + 2 * EXP_OPS + 1 + 2  # the carries, max, exp(c - max), sum, w / sum
SETUP_OPS = 5 * DEV_OPS + 3 + 3 + 2 + 3 + 2  # te_dev, x0, lower, the 3 tests, hi
STEP_OPS = DEV_OPS + 3  # a residual evaluation, its test and the new bound
HALVING_OPS = STEP_OPS + 2  # and the midpoint
CPFIT_ROW_OPS = 1 + EXP_OPS + 2 * (1 + EXP_OPS) + 4 + EXP_OPS + 1 + 3  # ed, masses, dpnc, lam, nc


def ect_work(nc, lh_post, T_post) -> dict:
    """The work of the ECT rounds on these inputs (`post_fit`'s arguments),
    counted on the plain version's solves (`fit_single_pop`) with each
    round's prefix of T lc summed left to right, as the kernel sums it.
    Per round, (B, n) each: ``solved``, the rows with T != 0 whose prefix
    differs bitwise from the last round's (all of them in the first round;
    a prefix the last round had gives its weights and so its rate again);
    ``tests``, the expansion tests a solve makes (one more than the steps
    that move hi, at most 40); ``halvings``, those up to the first that
    leaves the bracket's bits as they were (60 without one).  And ``lc``
    (B, n, 2), the rates."""
    B, n = nc.shape[0], T_post.shape[1]
    T = T_post.expand(B, n)
    live = T != 0
    t_safe = torch.where(live, T, torch.ones_like(T))
    lh = lh_post.expand(B, n, 2)
    lc = lh.mean(-1)
    work, last = {"solved": [], "tests": [], "halvings": []}, None
    for _ in range(_POST_OUTERS):
        dec = T * lc
        pre = [torch.zeros_like(dec[:, 0])]
        for t in range(1, n):
            pre.append(dec[:, 0] if t == 1 else pre[-1] + dec[:, t - 1])
        pre = torch.stack(pre, 1)
        bits = pre.view(torch.int64)
        work["solved"].append(live if last is None else live & (bits != last))
        last = bits
        c = nc[:, None, :] - pre[..., None]
        w = torch.exp(c - c.max(-1, keepdim=True).values)
        moves, halvings = [], []
        lam = fit_single_pop(lh, t_safe, w, moves=moves, halvings=halvings)
        work["tests"].append(torch.clamp(moves[0] + 1, max=_EXPAND_ITERS))
        work["halvings"].append(halvings[0])
        lc = torch.where(live, lam, torch.ones_like(lam))
    work["lc"] = torch.stack([lc, lc], -1)
    return work


def post_fit_ops(nc, lh_post, T_post, *, cpfit: bool) -> float:
    """FP64 operations one call needs on these inputs (`post_fit`'s
    arguments), counting each of the function's steps on the rows with
    T != 0 (a T == 0 row needs none: its rate is 1 and the carry stays).

    cpfit: per row CPFIT_ROW_OPS (the ratio exp(nc1 - nc0), the two
    expm1 masses, the deviation, -log1p over T, the carry).  ECT
    (`ect_work`): per (lane, round, interval) PREFIX_OPS; per solve whose
    prefix changed WEIGHT_OPS (the two carries, their max, the two weights,
    their normalisation), SETUP_OPS (five residual evaluations: the
    target's two, the upper branch's limit, the lower branch's two ends;
    x0, the lower bound, the tests, the bracket), STEP_OPS for each
    expansion test it needs, HALVING_OPS for each halving up to the
    bracket's fixed point, and the midpoint; per lane the final carry
    (2 n + 2).

    Costs: an add, a product, a division and a comparison each 1; exp,
    expm1 and log1p EXP_OPS; a residual evaluation DEV_OPS, the cheaper of
    the function's two forms (x = lam T, then the Bernoulli series in
    Horner form: x^2, four multiply-adds and a product; the direct form
    1/x - 1/expm1(x) - 1/2 costs 1 + EXP_OPS + 4), so that the bound stays
    a floor."""
    B, n = nc.shape[0], T_post.shape[1]
    live = (T_post != 0).expand(B, n)
    if cpfit or n == 0:
        return float(live.sum()) * CPFIT_ROW_OPS
    work = ect_work(nc, lh_post, T_post)
    ops = float(live.sum()) * len(work["solved"]) * PREFIX_OPS + B * (2 * n + 2)
    for solved, tests, halvings in zip(work["solved"], work["tests"], work["halvings"]):
        ops += (float(solved.sum()) * (WEIGHT_OPS + SETUP_OPS + 2)
                + float(tests[solved].sum()) * STEP_OPS
                + float(halvings[solved].sum()) * HALVING_OPS)
    return ops


def post_fit_bytes(B: int, L: int, n: int, *, itemsize: int = 8) -> int:
    """Bytes a call must move: each input read once (nc, the L tables),
    each output written once (lc_post, nc_fin)."""
    return (2 * B + 3 * L * n + 2 * B * n + 2 * B) * itemsize
