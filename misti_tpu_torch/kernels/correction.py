"""Post-split single-population fit (reference ``FitSinglePop``) and the
forward coalescence rates (``CoalRates``) in torch.

The fit is what the likelihood's ECT post-split sweep needs: the f32-stable
deviation form of the one-population expected coalescence time and a
bracket-expansion + bisection root finder, elementwise over any batch shape.
The reference's raw-rate ``lam > 100`` guard splits the residual into two
decreasing branches; the bracket keeps to the branch that holds the start
x0, as the reference's local solver does.  `coal_rates` is the forward
model's step (true EPS -> PSMC-style mixed rates), batch-first.
"""

from __future__ import annotations

import torch

from ..model.statespace import correction_matrix
from .expm import expm

_BISECT_ITERS = 60
_EXPAND_ITERS = 40


def _ect_dev(x: torch.Tensor) -> torch.Tensor:
    """ECT(lam, T)/T - 1/2 as a function of x = lam*T (stretched units).

    ECT(lam, T) = 1/lam - T/expm1(lam*T) (reference CorrectLambda.py:67-77,
    with the lam > 100 tail guard).  Below the switch point the Bernoulli
    series -x/12 + x^3/720 - x^5/30240 + x^7/1209600 - x^9/47900160 removes
    the T/2 baseline analytically.  Its truncation (the x^11 term, 5.3e-10
    x^11) is below float32's rounding up to x = 1, but in float64 it would
    move a fitted rate by up to ~6e-9 relative, so float64 switches at
    x = 1/4 (truncation < 2e-16; the direct form's cancellation there costs
    ~2e-14 relative).
    """
    x2 = x * x
    ser = x * (
        -1.0 / 12.0
        + x2 * (1.0 / 720.0 + x2 * (-1.0 / 30240.0 + x2 * (
            1.0 / 1209600.0 + x2 * (-1.0 / 47900160.0))))
    )
    hot = x > 100.0
    one = torch.ones_like(x)
    tail = torch.where(hot, torch.zeros_like(x),
                       1.0 / torch.expm1(torch.where(hot, one, x)))
    direct = 1.0 / x - tail - 0.5
    switch = 1.0 if x.dtype == torch.float32 else 0.25
    return torch.where(x < switch, ser, direct)


def fit_single_pop(lh: torch.Tensor, T: torch.Tensor, weights: torch.Tensor, *,
                   moves: list | None = None, halvings: list | None = None):
    """Solve ECT(lam, T) = sum_i w_i ECT(lh_i, T) for lam.

    ``lh`` (..., 2), ``T`` (...), ``weights`` (..., 2) unnormalised.  ECT is
    taken in deviation form, ECT = T (1/2 + dev(lam T)), so the baselines and
    the common factor T cancel.

    The reference guards ECT's 1/expm1 tail on the RAW rate (``lam > 100``,
    CorrectLambda.py:68, called with the unstretched interval), so the
    residual g decreases on each of [lower, 100] and (100, inf) but jumps UP
    at 100 and can have a root on each side.  The reference's solver
    (least_squares from x0 = sum_i w_i lh_i) stays on x0's side, so the
    bracket does too: with x0 <= 100 and a root below 100, the expansion is
    clamped to 100; with x0 > 100 and a root above 100, the bisection starts
    at 100.  Only when x0's branch has no root is the other one taken; when
    neither has one, g < 0 everywhere and the result is the lower bound.
    Per lane with fixed iteration counts: 60 halvings of a bracket no wider
    than ~2 x the root reach float64's last ulp above 100 and the
    residual's own rounding below it.  ``moves``, a list, gets the count
    of expansion steps that moved the upper bound, per lane, and
    ``halvings`` the count of halvings up to the first that leaves the
    bracket's bits as they were (60 if none does; from there on every
    halving repeats it), per lane: the work meters of kernels/post_fit.py.
    """
    w = weights / weights.sum(-1, keepdim=True)
    lh0, lh1 = lh[..., 0], lh[..., 1]
    w0, w1 = w[..., 0], w[..., 1]

    def dev_low(lam):  # lam <= 100: the 1/expm1 tail kept
        return _ect_dev(lam * T)

    def dev_up(lam):  # lam > 100: the tail dropped, ECT = 1/lam
        return 1.0 / (lam * T) - 0.5

    def dev(lam):
        return torch.where(lam > 100.0, dev_up(lam), dev_low(lam))

    te_dev = w0 * dev(lh0) + w1 * dev(lh1)
    x0 = w0 * lh0 + w1 * lh1
    lower = 0.01 * torch.minimum(lh0, lh1)
    hundred = torch.full_like(x0, 100.0)
    # the upper branch starts at 100 (at lower if that is past 100); g's
    # limit there decides whether it has a root (g -> -1/2 - te_dev < 0)
    lo_up = torch.maximum(lower, hundred)
    root_up = dev_up(lo_up) - te_dev >= 0
    root_low = ((lower < 100.0) & (dev_low(lower) - te_dev >= 0)
                & (dev_low(hundred) - te_dev < 0))
    up = root_up & ((x0 > 100.0) | ~root_low)

    def g(lam):  # decreasing in lam on the lane's branch
        return torch.where(up, dev_up(lam), dev_low(lam)) - te_dev

    lo = torch.where(up, lo_up, lower)
    hi = torch.maximum(x0, lower * 2.0)
    # the lower branch's expansion stops at 100, never past lo
    cap = torch.where(up, torch.full_like(x0, float("inf")), torch.maximum(hundred, lower))
    hi = torch.where(up, torch.maximum(hi, lo_up), torch.minimum(hi, cap))
    moved = 0
    for _ in range(_EXPAND_ITERS):
        new = torch.where(g(hi) >= 0, torch.minimum(hi * 2.0, cap), hi)
        if moves is not None:
            moved = moved + ((new != hi) & ~torch.isnan(new)).to(torch.int32)
        hi = new
    if moves is not None:
        moves.append(moved)
    steps = None if halvings is None else torch.full_like(lo, _BISECT_ITERS, dtype=torch.int32)
    for i in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        rise = g(mid) >= 0
        if halvings is not None:
            kept = mid.view(torch.int64) == torch.where(rise, lo, hi).view(torch.int64)
            steps = torch.where(kept & (steps == _BISECT_ITERS), i + 1, steps)
        lo = torch.where(rise, mid, lo)
        hi = torch.where(rise, hi, mid)
    if halvings is not None:
        halvings.append(steps)
    return 0.5 * (lo + hi)


def coal_rates(lc, mu, T, p0):
    """CoalRates (CorrectLambda.py:112-122): true EPS -> PSMC-style mixed rates.

    ``lc`` and ``mu`` (B, 2) rates, ``T`` (B,) interval lengths, ``p0``
    (B, 2, 3) each genome's location distribution.  Returns (lh (B, 2),
    p_out (B, 2, 3)).
    """
    m = correction_matrix(lc[..., 0], lc[..., 1], mu[..., 0], mu[..., 1])
    T = torch.as_tensor(T, dtype=p0.dtype, device=p0.device)
    e = expm(m * T[..., None, None], max_squarings=20)
    p_out = p0 @ e.transpose(-1, -2)
    nc = p_out.sum(-1) / p0.sum(-1)
    lh = -torch.log(nc) / T[..., None]
    return lh, p_out
