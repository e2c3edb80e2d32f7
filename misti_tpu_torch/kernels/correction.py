"""Post-split single-population fit (reference ``FitSinglePop``) and the
forward coalescence rates (``CoalRates``) in torch.

The fit is what the likelihood's ECT post-split sweep needs: the f32-stable
deviation form of the one-population expected coalescence time and the
bracket-expansion + bisection root finder, elementwise over any batch shape.
It is the JAX package's arithmetic as it stands, including its raw-rate
``lam > 100`` guard.  `coal_rates` is the forward model's step (true EPS ->
PSMC-style mixed rates), batch-first.
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
    with the lam > 100 tail guard).  Below x = 1 the Bernoulli series
    -x/12 + x^3/720 - x^5/30240 + x^7/1209600 - x^9/47900160 removes the
    T/2 baseline analytically (truncation < 6e-10 at the switch point).
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
    return torch.where(x < 1.0, ser, direct)


def fit_single_pop(lh: torch.Tensor, T: torch.Tensor, weights: torch.Tensor):
    """Solve ECT(lam, T) = sum_i w_i ECT(lh_i, T) for lam.

    ``lh`` (..., 2), ``T`` (...), ``weights`` (..., 2) unnormalised.  ECT is
    taken in deviation form, ECT = T (1/2 + dev(lam T)), so the baselines and
    the common factor T cancel.  The upstream guard on the RAW rate
    (``lam > 100`` drops the 1/expm1 tail) is kept as it is.
    """
    w = weights / weights.sum(-1, keepdim=True)
    lh0, lh1 = lh[..., 0], lh[..., 1]
    w0, w1 = w[..., 0], w[..., 1]

    def dev(lam):
        x = lam * T
        return torch.where(lam > 100.0, 1.0 / x - 0.5, _ect_dev(x))

    te_dev = w0 * dev(lh0) + w1 * dev(lh1)
    x0 = w0 * lh0 + w1 * lh1
    lower = 0.01 * torch.minimum(lh0, lh1)

    def g(lam):
        return dev(lam) - te_dev  # decreasing in lam (within each branch)

    hi = torch.maximum(x0, lower * 2.0)
    for _ in range(_EXPAND_ITERS):
        hi = torch.where(g(hi) >= 0, hi * 2.0, hi)
    lo = lower
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        up = g(mid) >= 0
        lo = torch.where(up, mid, lo)
        hi = torch.where(up, hi, mid)
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
