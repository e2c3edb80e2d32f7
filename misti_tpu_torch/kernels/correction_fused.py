"""Fused pre-split correction sweep: CUDA kernel wrapper and its plain version.

The corrected likelihood's lambda-correction sweep (reference
``CorrectLambdas``, MigrationInference.py:305-354) solves, per candidate lane
and per pre-split interval, a 2-unknown nonlinear system whose residuals are
built from 3x3 matrix exponentials.  The sequential chain is recast as a
Jacobi fixed point: each round propagates the two-lineage location chain for
the current rate guesses (an ordered prefix product over intervals), then
re-solves every interval by a short trust-region Levenberg-Marquardt from a
warm start.  Budgets 2 rounds / 8 first-round / 2 warm LM iterations and
8 squarings, as the JAX package's `build_fused_correction` passes them.

* `correction_sweep` is the wrapper: CPU tensors take the plain version,
  CUDA tensors launch the hand-written kernel (csrc/correction_sweep.cu) or
  raise.  ``correction_sweep.launches`` counts kernel launches.
* `correction_sweep_plain` is the same arithmetic in torch ops on
  (intervals, lanes) fields: 3x3 matrices are row-major 9-tuples, the
  interval prefix product is the same Hillis-Steele doubling, and the LM
  Jacobian comes from forward-mode AD (``torch.autograd.forward_ad``).
* `fused_correction` does the layout work around either: (B, s, 2)
  candidate tables in, (B, s, 2) rates and (B, s, 2, 3) states out.

The series forms of ``expm1``/``1 - exp(-x)``/``log1p`` below are kept from
the JAX kernel (they stood in for missing TPU lowerings) so the numbers stay
the reference's; swapping in native functions is a separate, re-validated
change.
"""

from __future__ import annotations

import ctypes
import math
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import torch
import torch.autograd.forward_ad as fwAD

_PREC = 1e-10  # reference `prec` (CorrectLambda.py): no-migration threshold
_NORM_EPS = 0.02  # reference `normEps`: near-identical-state merge

MAX_INTERVALS = 256  # one block holds all intervals of a lane

# ---------------------------------------------------------------------------
# Plain version: torch ops on (intervals, lanes) fields
# ---------------------------------------------------------------------------

_EYE = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)
_CE = [1.0 / math.factorial(k) for k in range(19)]
_C1 = [1.0 / math.factorial(k + 1) for k in range(19)]
_CPHI = [0.0] + _CE[1:]  # E - I series (no constant term)
_CJ = [0.0] + [k / (2.0 * math.factorial(k + 2)) for k in range(1, 19)]
_PS_BASE = 3  # Paterson-Stockmeyer base of the degree-18 series, as in the kernel


def _plain(v):
    return v


class _Work:
    """Meter for `sweep_work`: counts of the work a thread per (interval,
    lane) does on given data -- expm squarings, and residual evaluations of
    the lanes that have not converged (the kernel leaves its LM loop at
    convergence).  ``kinds`` are the (name, lane mask) pairs of the residual
    being solved (the kernel evaluates one residual per lane), ``live`` the
    lanes of the current evaluation."""

    def __init__(self):
        self.n = {}
        self.kinds = ()
        self.live = None

    def add(self, key, value):
        self.n[key] = self.n.get(key, 0.0) + float(value)

    def squarings(self, s):
        if self.live is None:  # the chain's expm, outside the LM
            self.add("chain", s.numel())
            self.add("chain_sq", s.sum())
            return
        s = s[0]  # first of the stacked tangent copies
        for name, mask in self.kinds:
            if name != "nomig":
                self.add(name + "_sq", s[self.live & mask].sum())


def _dual_consts(like):
    """Constant maker for code run on forward-mode duals: constants (python
    scalars or tangent-free tensors) are lifted to duals with explicit zero
    tangents.  Forward-mode AD takes a much slower path for a product or
    sum of a dual and a plain operand than for a dual-dual op.
    The values are unchanged.  ``like`` is a dual input."""
    zd = like - like
    true = torch.ones(zd.shape, dtype=torch.bool, device=zd.device)
    return lambda v: torch.where(true, v, zd)


def _m3_mul(a, b):
    """Elementwise 3x3 product of row-major entry tuples (27 products)."""
    return tuple(
        a[3 * i + 0] * b[0 + j] + a[3 * i + 1] * b[3 + j] + a[3 * i + 2] * b[6 + j]
        for i in range(3)
        for j in range(3)
    )


def _m3_select(c, a, b):
    return tuple(torch.where(c, x, y) for x, y in zip(a, b))


def _m3_onenorm(a):
    colsum = [a[0 + j].abs() + a[3 + j].abs() + a[6 + j].abs() for j in range(3)]
    return torch.maximum(torch.maximum(colsum[0], colsum[1]), colsum[2])


def _corr_mat(l0, l1, m0, m1, k=_plain):
    """3x3 two-lineage location generator (reference CorrectLambda.py:55-56).
    ``k`` lifts the constant entries (see `_dual_consts`)."""
    z = k(torch.zeros(l0.shape, dtype=l0.dtype, device=l0.device))
    return (
        k(-2.0 * m0) - l0, z, k(m1),
        z, k(-2.0 * m1) - l1, k(m0),
        k(2.0 * m0), k(2.0 * m1), k(-m0 - m1),
    )


def _scaling(a, max_squarings, k=_plain, work=None):
    """Per-lane squaring count + scaled matrix.  Lanes whose one-norm
    exceeds 2^max_squarings are NaN-poisoned instead of clamped, so a
    runaway trial rate turns into llh = -inf downstream.  The count is a
    step function of the rates: it is taken from the values alone."""
    norm = _m3_onenorm(tuple(x.detach() for x in a))
    s = torch.clamp(torch.ceil(torch.log2(torch.clamp(norm, min=1e-30))), min=0.0)
    s = torch.where(torch.isfinite(norm) & (norm > 0), s, 0.0)
    over = s > float(max_squarings)
    s = torch.clamp(s, max=float(max_squarings))
    scale = torch.where(over, float("nan"), torch.exp2(-s))
    if work is not None:
        work.squarings(s)
    sk = k(scale)
    return tuple(x * sk for x in a), s, scale


def _n_squarings(s):
    """Loop bound of the masked squaring steps: steps past max(s) select
    the unsquared value in every lane, so they are skipped."""
    return int(s.max()) if s.numel() else 0


def _ps_powers(b, k=_plain):
    """Paterson-Stockmeyer powers I, b, ..., b^_PS_BASE."""
    zero = torch.zeros(b[0].shape, dtype=b[0].dtype, device=b[0].device)
    one, zero = k(zero + 1.0), k(zero)
    p = [(one, zero, zero, zero, one, zero, zero, zero, one), b]
    for _ in range(_PS_BASE - 1):
        p.append(_m3_mul(p[-1], b))
    return p


def _ps_horner(p, coeffs, k=_plain):
    """sum_k coeffs[k] * b^k (k <= 18) in base b^m, m = len(p) - 1: outer
    Horner from the top block, acc = B_q + b^m @ acc."""
    m = len(p) - 1
    deg = len(coeffs) - 1

    def blk(k0):
        out = tuple(k(coeffs[k0]) * e for e in p[0])
        for j in range(1, m):
            cj = k(coeffs[k0 + j])
            out = tuple(o + cj * e for o, e in zip(out, p[j]))
        return out

    ctop = k(coeffs[deg])
    acc = tuple(o + ctop * e for o, e in zip(blk(deg - m), p[m]))
    for q in range(deg // m - 2, -1, -1):
        acc = tuple(x + y for x, y in zip(blk(m * q), _m3_mul(p[m], acc)))
    return acc


def _expm3(a, max_squarings, work=None):
    """Scaling-and-squaring Taylor-18 expm of a 3x3 entry tuple."""
    b, s, _ = _scaling(a, max_squarings, work=work)
    e = _ps_horner(_ps_powers(b), _CE)
    for i in range(_n_squarings(s)):
        e = _m3_select(float(i) < s, _m3_mul(e, e), e)
    return e


def _expm3_m1(a, max_squarings, k=_plain, work=None):
    """Phi = e^a - I, cancellation-free: Phi(2h) = Phi^2 + 2 Phi."""
    b, s, _ = _scaling(a, max_squarings, k, work)
    phi = _ps_horner(_ps_powers(b, k), _CPHI, k)
    two = k(2.0)
    for i in range(_n_squarings(s)):
        sq = tuple(pp + two * ph for pp, ph in zip(_m3_mul(phi, phi), phi))
        phi = _m3_select(float(i) < s, sq, phi)
    return phi


def _expm3_nc_moments(a, max_squarings, k=_plain, work=None):
    """(N1, J) of the stretched (t = 1) generator: N1 = int_0^1 e^{as} ds and
    the centred first moment J = int_0^1 (s - 1/2) e^{as} ds.  Doubling
    carries Phi = E - I with N1(2h) = 2 N1 + Phi N1 and
    J(2h) = 2 J + Phi J + (h/2) Phi N1."""
    b, s, scale = _scaling(a, max_squarings, k, work)
    p = _ps_powers(b, k)
    phi1 = _ps_horner(p, _C1, k)
    phim = _ps_horner(p, _CPHI, k)
    h = scale
    hk = k(h)
    n1 = tuple(hk * x for x in phi1)
    hhk = k(h * h)
    j = tuple(hhk * x for x in _ps_horner(p, _CJ, k))
    two = k(2.0)
    for i in range(_n_squarings(s)):
        live = float(i) < s
        tmp = _m3_mul(phim, n1)
        hk = k(0.5 * h)
        jn = tuple(
            two * jj + pj + hk * tm
            for jj, pj, tm in zip(j, _m3_mul(phim, j), tmp)
        )
        n1n = tuple(two * nn + tm for nn, tm in zip(n1, tmp))
        phin = tuple(pp + two * ph for pp, ph in zip(_m3_mul(phim, phim), phim))
        j = _m3_select(live, jn, j)
        n1 = _m3_select(live, n1n, n1)
        phim = _m3_select(live, phin, phim)
        h = torch.where(live, 2.0 * h, h)
    return n1, j


def _pulse_cols(q0, q1, q2, rate, pop):
    """Pulse-migration map on a location column (q_p, q_q, q_split)
    (MigrationInference.py:315-323; identity at rate == 0)."""
    qp, qq = (q0, q1) if pop == 0 else (q1, q0)
    np_ = qp * (1.0 - rate) ** 2
    nq = qp * rate**2 + qq + q2 * rate
    n2 = qp * 2.0 * (1.0 - rate) * rate + q2 * (1.0 - rate)
    return (np_, nq, n2) if pop == 0 else (nq, np_, n2)


def _expm1(x):
    """exp(x) - 1: 7-term Horner series below 0.5, exp(x) - 1 above."""
    small = x < 0.5
    xs = torch.where(small, x, 0.0)
    ser = xs * (1.0 + xs / 2 * (1.0 + xs / 3 * (1.0 + xs / 4 * (
        1.0 + xs / 5 * (1.0 + xs / 6 * (1.0 + xs / 7))))))
    return torch.where(small, ser, torch.exp(x) - 1.0)


def _em1m(x, k=_plain):
    """1 - exp(-x): series below 0.5, direct above."""
    small = x < 0.5
    xs = torch.where(small, x, 0.0)
    one = k(1.0)
    t = one - xs / k(7.0)
    for d in (6.0, 5.0, 4.0, 3.0, 2.0):
        t = one - xs / k(d) * t
    return torch.where(small, xs * t, one - torch.exp(-x))


def _log1p(x):
    """log(1 + x) by the w = 1 + x compensation x * log(w) / (w - 1)."""
    w = 1.0 + x
    d = w - 1.0
    exact = d == 0.0
    safe_w = torch.where(exact, 2.0, w)
    safe_d = torch.where(exact, 1.0, d)
    return torch.where(exact, x, x * torch.log(safe_w) / safe_d)


def _ect_dev(x):
    """ECT(lam, T)/T - 1/2 at x = lam*T: Bernoulli series below 1, direct
    formula with the x > 100 tail guard above."""
    x2 = x * x
    ser = x * (
        -1.0 / 12.0
        + x2 * (1.0 / 720.0 + x2 * (-1.0 / 30240.0 + x2 * (
            1.0 / 1209600.0 + x2 * (-1.0 / 47900160.0))))
    )
    hot = x > 100.0
    tail = torch.where(hot, 0.0, 1.0 / _expm1(torch.where(hot, 1.0, x)))
    direct = 1.0 / x - tail - 0.5
    return torch.where(x < 1.0, ser, direct)


# series of ECTnc(x) - (1 - e^-x)/2 in x (coefficients of x^2 .. x^12)
_ECTNC = (-1.0 / 12.0, 1.0 / 24.0, -1.0 / 80.0, 1.0 / 360.0, -1.0 / 2016.0,
          1.0 / 13440.0, -1.0 / 103680.0, 1.0 / 907200.0, -1.0 / 8870400.0,
          1.0 / 95800320.0, -11.0 / 12454041600.0)


def _ectnc_dev(x, k=_plain):
    """ECTnc(x) - (1 - e^-x)/2: the no-migration numerator term with its
    T/2 baseline removed."""
    t = k(_ECTNC[-1])
    for c in _ECTNC[-2::-1]:
        t = k(c) + x * t
    ser = x * x * t
    xs = torch.where(x < 1.0, 1.0, x)
    one = k(1.0)
    direct = (one - torch.exp(-xs) * (one + xs)) / xs - k(0.5) * _em1m(xs, k)
    return torch.where(x < 1.0, ser, direct)


def _lin_at(res_fn, a0, a1):
    """Residual and its 2x2 Jacobian by forward mode: both tangent columns
    in one forward-mode pass over a stacked pair of dual copies (the same
    values as ``torch.func.jvp`` at ~2.4x less dispatch cost)."""
    a0s, a1s = torch.stack([a0, a0]), torch.stack([a1, a1])
    e0 = torch.zeros_like(a0s)
    e0[0] = 1.0
    with fwAD.dual_level():
        r0, r1 = res_fn(fwAD.make_dual(a0s, e0), fwAD.make_dual(a1s, e0.flip(0)))
        (r0, t0), (r1, t1) = fwAD.unpack_dual(r0), fwAD.unpack_dual(r1)
    return r0[0], r1[0], t0[0], t1[0], t0[1], t1[1]


def _lm2(res_fn, x0, x1, n_iters, lower0, lower1, kinds=(), work=None):
    """Fixed-iteration 2-unknown Levenberg-Marquardt on (intervals, lanes)
    fields: damping 1e-3 start with x0.25/x4 updates, trust-region step
    clip, masked accept and convergence.  The carried (r, J) were taken at
    the accepted point, so each iteration linearises once, at the trial.
    ``kinds`` names the residuals for the `_Work` meter ``work``."""
    x0, x1 = torch.maximum(x0, lower0), torch.maximum(x1, lower1)
    trust = torch.clamp(torch.sqrt(x0 * x0 + x1 * x1), min=1.0)
    done = torch.zeros_like(x0, dtype=torch.bool)

    def lin_at(a0, a1):
        if work is None:
            return _lin_at(res_fn, a0, a1)
        work.kinds, work.live = kinds, ~done
        for name, mask in kinds:
            work.add(name, (~done & mask).sum())
        out = _lin_at(res_fn, a0, a1)
        work.live = None
        return out

    r0, r1, j00, j10, j01, j11 = lin_at(x0, x1)
    damp = torch.full_like(x0, 1e-3)
    c = r0 * r0 + r1 * r1
    for _ in range(n_iters):
        a00 = j00 * j00 + j10 * j10 + damp
        a01 = j00 * j01 + j10 * j11
        a11 = j01 * j01 + j11 * j11 + damp
        g0 = j00 * r0 + j10 * r1
        g1 = j01 * r0 + j11 * r1
        det = a00 * a11 - a01 * a01
        det = torch.where(det == 0, torch.ones_like(det), det)
        d0 = (a01 * g1 - a11 * g0) / det
        d1 = (a01 * g0 - a00 * g1) / det
        dn = torch.sqrt(d0 * d0 + d1 * d1)
        shrink = torch.clamp(trust / torch.clamp(dn, min=1e-30), max=1.0)
        d0 = d0 * shrink
        d1 = d1 * shrink
        xn0 = torch.maximum(x0 + d0, lower0)
        xn1 = torch.maximum(x1 + d1, lower1)
        rn0, rn1, jn00, jn10, jn01, jn11 = lin_at(xn0, xn1)
        cn = rn0 * rn0 + rn1 * rn1
        ok = torch.isfinite(cn) & (cn < c) & ~done
        step = torch.where(
            ok, torch.sqrt((xn0 - x0) ** 2 + (xn1 - x1) ** 2),
            torch.full_like(cn, float("inf")))
        x0, x1 = torch.where(ok, xn0, x0), torch.where(ok, xn1, x1)
        r0, r1 = torch.where(ok, rn0, r0), torch.where(ok, rn1, r1)
        j00, j10 = torch.where(ok, jn00, j00), torch.where(ok, jn10, j10)
        j01, j11 = torch.where(ok, jn01, j01), torch.where(ok, jn11, j11)
        c = torch.where(ok, cn, c)
        damp = torch.where(
            done, damp,
            torch.clamp(torch.where(ok, damp * 0.25, damp * 4.0), 1e-14, 1e10))
        trust = torch.where(
            done, trust,
            torch.clamp(torch.where(ok, trust * 2.0, trust * 0.5), 1e-8, 1e3))
        done = done | (c < 1e-28) | (
            step < 1e-13 * (1.0 + torch.sqrt(x0 * x0 + x1 * x1)))
    return x0, x1


# -- the residuals of one interval's solve, in stretched units (rates a*T) --
# ``c`` holds the entry state p, its normalised pn, the stretched migration
# rates and the targets.  Run on forward-mode duals, so constants are lifted.


def _res_cp(a0, a1, c):
    """cpfit: no-coalescence masses as deviations from the total mass,
    Phi = E - I column sums plus s * em1m(lh T)."""
    k = _dual_consts(a0)
    phi = _expm3_m1(_corr_mat(a0, a1, c.mu0s, c.mu1s, k), c.max_squarings, k, c.work)
    cs = [phi[0 + j] + phi[3 + j] + phi[6 + j] for j in range(3)]
    p = [k(v) for v in c.p]
    r0 = cs[0] * p[0] + cs[1] * p[1] + cs[2] * p[2] + k(c.mass0)
    r1 = cs[0] * p[3] + cs[1] * p[4] + cs[2] * p[5] + k(c.mass1)
    return r0, r1


def _res_ect(a0, a1, c):
    """Expected coalescence time with migration: the conditional mean minus
    its T/2 baseline, with 1 - pnc == a0 (N1 p)_0 + a1 (N1 p)_1 and the
    numerator from J = K - N1/2."""
    k = _dual_consts(a0)
    n1, jm = _expm3_nc_moments(_corr_mat(a0, a1, c.mu0s, c.mu1s, k), c.max_squarings, k,
                               c.work)
    q00, q01, q02, q10, q11, q12 = (k(v) for v in c.pn)
    n1p00 = n1[0] * q00 + n1[1] * q01 + n1[2] * q02
    n1p01 = n1[3] * q00 + n1[4] * q01 + n1[5] * q02
    n1p10 = n1[0] * q10 + n1[1] * q11 + n1[2] * q12
    n1p11 = n1[3] * q10 + n1[4] * q11 + n1[5] * q12
    jp00 = jm[0] * q00 + jm[1] * q01 + jm[2] * q02
    jp01 = jm[3] * q00 + jm[4] * q01 + jm[5] * q02
    jp10 = jm[0] * q10 + jm[1] * q11 + jm[2] * q12
    jp11 = jm[3] * q10 + jm[4] * q11 + jm[5] * q12
    den0 = a0 * n1p00 + a1 * n1p01
    den1 = a0 * n1p10 + a1 * n1p11
    t2_0 = (a0 * jp00 + a1 * jp01) / den0
    t2_1 = (a0 * jp10 + a1 * jp11) / den1
    return t2_0 - k(c.ect0), t2_1 - k(c.ect1)


def _res_nomig(a0, a1, c):
    """Expected coalescence time without migration (closed-form series)."""
    k = _dual_consts(a0)
    d0 = _em1m(a0, k)
    d1 = _em1m(a1, k)
    q0 = _ectnc_dev(a0, k)
    q1 = _ectnc_dev(a1, k)
    q00, q01, _, q10, q11, _ = (k(v) for v in c.pn)
    den0 = q00 * d0 + q01 * d1
    den1 = q10 * d0 + q11 * d1
    ct0 = (q00 * q0 + q01 * q1) / den0
    ct1 = (q10 * q0 + q11 * q1) / den1
    return ct0 - k(c.ect_raw0), ct1 - k(c.ect_raw1)


def _shift_down(m3, d, fill):
    """Row shift on the interval axis: out[t] = in[t-d], fill for t < d."""
    return tuple(
        torch.cat([torch.full_like(x[:d], f), x[:-d]], dim=0) for x, f in zip(m3, fill)
    )


def _sweep_body(T, lh0, lh1, mi0, mi1, pu0, pu1, *, cpfit, mixture_th,
                static_no_mig, has_pulse, rounds, iters0, iters_warm,
                max_squarings, work=None):
    """The fused sweep on (intervals, lanes) fields.  Returns (lc0, lc1,
    p_after 6-tuple): p_after[t] is each genome's location distribution
    after interval t.  ``work`` is an optional `_Work` meter."""
    n_rows = T.shape[0]
    mu0s = mi0 * T
    mu1s = mi1 * T
    lh_raw_s0 = lh0 * T
    lh_raw_s1 = lh1 * T
    no_mig = (mi0 + mi1) < _PREC
    all_lanes = torch.ones_like(no_mig)
    neg_inf = torch.full_like(T, -float("inf"))

    def chain(x0s, x1s):
        """State entering each solve and after each interval, for stretched
        rate guesses: expm(M(lc, mu) T) == expm(M(lc T, mu T))."""
        e = _expm3(_corr_mat(x0s, x1s, mu0s, mu1s), max_squarings, work)
        if has_pulse:
            # pulses act before the exponential: P = PU1 @ PU0, built by
            # pushing the canonical basis through the pulse maps
            p_cols = []
            for j in range(3):
                basis = [torch.full_like(x0s, 1.0 if i == j else 0.0) for i in range(3)]
                q = _pulse_cols(*basis, pu0, 0)
                q = _pulse_cols(*q, pu1, 1)
                p_cols.append(q)
            g = _m3_mul(e, tuple(p_cols[j][i] for i in range(3) for j in range(3)))
        else:
            g = e
        # Hillis-Steele ordered product C_t = G_t @ ... @ G_0
        c = g
        d = 1
        while d < n_rows:
            c = _m3_mul(c, _shift_down(c, d, _EYE))
            d *= 2
        s_excl = _shift_down(c, 1, _EYE)  # C_{t-1}, identity at t == 0

        def col(m, j):
            return (m[0 + j], m[3 + j], m[6 + j])

        p_in = [col(s_excl, 0), col(s_excl, 1)]
        if has_pulse:
            p_in = [_pulse_cols(*_pulse_cols(*q, pu0, 0), pu1, 1) for q in p_in]
        return p_in, (col(c, 0), col(c, 1))

    def solve_round(p_in, x0_init, x1_init, n_iters):
        p00, p01, p02 = p_in[0]
        p10, p11, p12 = p_in[1]
        s0 = p00 + p01 + p02
        s1 = p10 + p11 + p12
        pn00, pn01, pn02 = p00 / s0, p01 / s0, p02 / s0
        pn10, pn11, pn12 = p10 / s1, p11 / s1, p12 / s1
        nv0 = torch.sqrt(p00 * p00 + p01 * p01 + p02 * p02)
        nv1 = torch.sqrt(p10 * p10 + p11 * p11 + p12 * p12)
        nd = torch.sqrt((p00 - p10) ** 2 + (p01 - p11) ** 2 + (p02 - p12) ** 2)
        merge = nd < _NORM_EPS * torch.minimum(nv0, nv1)
        lh_mid = 0.5 * (lh0 + lh1) * T
        lh_s0 = torch.where(merge, lh_mid, lh_raw_s0)
        lh_s1 = torch.where(merge, lh_mid, lh_raw_s1)

        ctx = SimpleNamespace(
            p=(p00, p01, p02, p10, p11, p12), pn=(pn00, pn01, pn02, pn10, pn11, pn12),
            mu0s=mu0s, mu1s=mu1s, max_squarings=max_squarings, work=work,
            mass0=s0 * _em1m(lh_s0), mass1=s1 * _em1m(lh_s1),
            ect0=_ect_dev(lh_s0), ect1=_ect_dev(lh_s1),
            ect_raw0=_ect_dev(lh_raw_s0), ect_raw1=_ect_dev(lh_raw_s1))

        def res_general(a0, a1):
            return (_res_cp if cpfit else _res_ect)(a0, a1, ctx)

        def res_nomig(a0, a1):
            return _res_nomig(a0, a1, ctx)

        if cpfit:
            # no-migration closed form (CorrectLambda.py:213-235), unstretched
            a1c, a2c = pn00, pn01
            a3c, a4c = pn10, pn11
            det = a1c * a4c - a2c * a3c
            det = torch.where(det == 0, torch.ones_like(det), det)
            em0 = _em1m(lh0 * T)
            em1v = _em1m(lh1 * T)
            dy1 = (a2c * em1v - a4c * em0) / det
            dy2 = (a3c * em0 - a1c * em1v) / det
            good = (dy1 > -1.0) & (dy2 > -1.0)
            zero = torch.zeros_like(dy1)
            minus1 = torch.full_like(dy1, -1.0)
            lc_nm0 = torch.where(good, -_log1p(torch.where(good, dy1, zero)) / T, minus1)
            lc_nm1 = torch.where(good, -_log1p(torch.where(good, dy2, zero)) / T, minus1)
            if static_no_mig:
                lc0, lc1 = lc_nm0, lc_nm1
            else:
                xg0, xg1 = _lm2(res_general, x0_init, x1_init, n_iters,
                                neg_inf, neg_inf, [("cp", ~no_mig)], work)
                lc0 = torch.where(no_mig, lc_nm0, xg0 / T)
                lc1 = torch.where(no_mig, lc_nm1, xg1 / T)
        else:
            lower_nm = 0.01 * torch.minimum(lh_raw_s0, lh_raw_s1)
            if static_no_mig:
                x0_, x1_ = _lm2(res_nomig, x0_init, x1_init, n_iters,
                                lower_nm, lower_nm, [("nomig", all_lanes)], work)
            else:
                # one combined LM: per-lane residual and bound selection
                def res(a0, a1):
                    g0, g1 = res_general(a0, a1)
                    n0, n1_ = res_nomig(a0, a1)
                    return torch.where(no_mig, n0, g0), torch.where(no_mig, n1_, g1)

                lo = torch.where(no_mig, lower_nm, neg_inf)
                x0_, x1_ = _lm2(res, x0_init, x1_init, n_iters, lo, lo,
                                [("ect", ~no_mig), ("nomig", no_mig)], work)
            lc0, lc1 = x0_ / T, x1_ / T

        if mixture_th > 0.0:
            mix = torch.sqrt(
                (pn00 - pn10) ** 2 + (pn01 - pn11) ** 2 + (pn02 - pn12) ** 2)
            bail = mix < mixture_th
            lc0 = torch.where(bail, torch.full_like(lc0, -1.0), lc0)
            lc1 = torch.where(bail, torch.full_like(lc1, -1.0), lc1)
        # zero-length (padding) intervals: pin lc = 1 (the reference's own
        # T == 0 rule) so their degenerate solve cannot reach the chain
        one = torch.ones_like(lc0)
        return torch.where(T == 0, one, lc0), torch.where(T == 0, one, lc1)

    p_in, _ = chain(lh_raw_s0, lh_raw_s1)
    lc0, lc1 = solve_round(p_in, lh_raw_s0, lh_raw_s1, iters0)
    for _ in range(rounds - 1):
        p_in, _ = chain(lc0 * T, lc1 * T)
        lc0, lc1 = solve_round(p_in, lc0 * T, lc1 * T, iters_warm)
    _, p_after = chain(lc0 * T, lc1 * T)
    return lc0, lc1, p_after[0] + p_after[1]


def correction_sweep_plain(inp: torch.Tensor, *, cpfit: bool,
                           mixture_th: float = 0.0, static_no_mig: bool = False,
                           has_pulse: bool = True, rounds: int = 2,
                           iters0: int = 8, iters_warm: int = 2,
                           max_squarings: int = 8, work: _Work | None = None
                           ) -> torch.Tensor:
    """The sweep in torch ops: inp (7, s, B) = (T, lh0, lh1, mi0, mi1, pu0,
    pu1) -> out (8, s, B) = (lc0, lc1, p_after x6).  ``work`` meters it
    (`sweep_work`)."""
    lc0, lc1, pa = _sweep_body(
        *inp.unbind(0), cpfit=cpfit, mixture_th=float(mixture_th),
        static_no_mig=static_no_mig, has_pulse=has_pulse, rounds=rounds,
        iters0=iters0, iters_warm=iters_warm, max_squarings=max_squarings,
        work=work)
    return torch.stack([lc0, lc1, *pa])


# The bound's yardstick: the algorithm's work, counted on the base-6
# evaluation the kernel first had (a design that needs fewer instructions
# reads a higher share of the same bound).
# Operations of the kernel's building blocks (csrc/correction_sweep.cu),
# counting each scalar add, sub, mul, div, exp, log and sqrt as one; a dual
# number op counts its value and both tangent parts (D2*D2 = 7, D2+D2 = 3,
# D2*T = 3).  Per unit of the matching `sweep_work` count.
_OPS = {
    "chain": 669,  # expm3: scaling 21, powers 5 x 45, Horner 423
    "chain_sq": 45,  # one squaring of a 3x3
    "scan_step": 45,  # one Hillis-Steele product, per element
    "pulse": 165,  # pulse matrix (72) + its product (45) + entry states (48)
    "setup": 100,  # per element and round: normalise, merge, targets, closed form
    "cp": 2834,  # dual expm3_m1 (39 + 1215 + 1485) + residual 50 + LM step 45
    "cp_sq": 297,
    "ect": 6013,  # dual nc-moments (39 + 1215 + 3 x 1485 + 55) + residual 204 + LM 45
    "ect_sq": 946,
    "nomig": 409,  # dual series residual 364 + LM step 45
}


def sweep_work(inp: torch.Tensor, **opts) -> dict:
    """Counts of what a thread per (interval, lane) computes on this input
    (chain expms and their squarings, residual evaluations of unconverged
    lanes and their squarings), from a metered run of the plain version."""
    work = _Work()
    correction_sweep_plain(inp, work=work, **opts)
    return work.n


def sweep_ops(work: dict, s: int, B: int, *, has_pulse: bool, rounds: int = 2,
              **_) -> float:
    """Arithmetic operations of the sweep for `sweep_work` counts."""
    chains = work.get("chain", 0.0)
    ops = chains * (_OPS["chain"] + _OPS["scan_step"] * max(0, math.ceil(math.log2(s))))
    if has_pulse:
        ops += chains * _OPS["pulse"]
    ops += rounds * s * B * _OPS["setup"]
    for key in ("chain_sq", "cp", "cp_sq", "ect", "ect_sq", "nomig"):
        ops += work.get(key, 0.0) * _OPS[key]
    return ops


# ---------------------------------------------------------------------------
# CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------

_CSRC = Path(__file__).resolve().parent / "csrc" / "correction_sweep.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"  # listed in .gitignore
_LIBS: dict = {}
_LIB_LOCK = threading.Lock()
_DTYPES = {torch.float32: ("float", "f32"), torch.float64: ("double", "f64")}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


# nvcc flags of every build; FMA contraction is on (nvcc's default), so the
# kernel matches its plain version to a tolerance, not bitwise
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")


def _lib_path(dtype: torch.dtype, cpfit: bool) -> Path:
    return BUILD_DIR / f"correction_sweep_{_DTYPES[dtype][1]}_{'cpfit' if cpfit else 'ect'}.so"


def _tmp_path(out: Path) -> Path:
    """Where nvcc writes ``out`` before it is moved into place: a name of this
    process's own, so processes building one library at once (the ranks of a
    sharded sweep) never load one another's half-written file."""
    return out.with_name(f"{out.name}.{os.getpid()}.tmp")


def compile_libs(jobs, check: bool = True) -> dict:
    """Run one nvcc per job (out path, source, dtype, cpfit, extra flags), all
    started together.  Returns {library name: (seconds, nvcc/ptxas log, ok)};
    with ``check`` a failed build raises."""
    procs = []
    for out, src, dtype, cpfit, flags in jobs:
        out = Path(out)
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [_nvcc(), *NVCC_FLAGS, *flags, f"-DMISTI_T={_DTYPES[dtype][0]}",
               f"-DMISTI_CPFIT={int(cpfit)}", "-o", str(_tmp_path(out)), str(src)]
        procs.append((out, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    report = {}
    for out, t0, proc in procs:
        log, _ = proc.communicate()
        ok = proc.returncode == 0
        if ok:
            os.replace(_tmp_path(out), out)  # atomic: a loader sees the old file or the new
        elif check:
            raise RuntimeError(f"nvcc failed for {out.name}:\n{log}")
        report[out.name] = (time.perf_counter() - t0, log, ok)
    return report


def stale(jobs) -> list:
    """The `compile_libs` jobs whose library is missing or older than its source."""

    def fresh(out, src):
        return out.exists() and out.stat().st_mtime >= src.stat().st_mtime

    return [j for j in jobs if not fresh(Path(j[0]), Path(j[1]))]


def build_jobs(variants=None, force: bool = False) -> list:
    """The nvcc jobs of the sweep kernels, one shared library per (dtype,
    residual mode), for `compile_libs`; without ``force`` only stale ones."""
    variants = variants or [(d, c) for d in _DTYPES for c in (True, False)]
    jobs = [(_lib_path(d, c), _CSRC, d, c, ()) for d, c in variants]
    return jobs if force else stale(jobs)


def build(variants=None, force: bool = False) -> dict:
    """Compile the sweep kernels, all started together.  Returns {library
    name: (seconds, ptxas report, ok)}; raises on a failed build."""
    return compile_libs(build_jobs(variants, force))


def bind(path) -> SimpleNamespace:
    """The C entry points of a built library: ``sweep`` (the launch) and
    ``attrs`` (registers, spills, blocks per SM; None in a library without
    it)."""
    lib = ctypes.CDLL(str(path))
    fn = lib.misti_correction_sweep
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_double, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    attrs = getattr(lib, "misti_correction_sweep_attrs", None)
    if attrs is not None:
        attrs.argtypes = [ctypes.c_int, ctypes.c_void_p]
        attrs.restype = ctypes.c_int
    return SimpleNamespace(sweep=fn, attrs=attrs)


def _load(dtype: torch.dtype, cpfit: bool) -> SimpleNamespace:
    key = (dtype, cpfit)
    with _LIB_LOCK:
        if key not in _LIBS:
            build([key])
            _LIBS[key] = bind(_lib_path(dtype, cpfit))
        return _LIBS[key]


def lib_attrs(lib: SimpleNamespace, s: int) -> list:
    """Per template instance of a bound library: registers per thread, local
    (spill) bytes per thread and resident blocks per SM at the launch shape
    for ``s`` intervals.  Needs a card."""
    buf = (ctypes.c_int * 20)()
    err = lib.attrs(int(s), ctypes.addressof(buf))
    if err != 0:
        raise RuntimeError(f"misti_correction_sweep_attrs failed: CUDA error {err}")
    return [dict(static_no_mig=bool(buf[5 * i]), has_pulse=bool(buf[5 * i + 1]),
                 registers=buf[5 * i + 2], local_bytes=buf[5 * i + 3],
                 blocks_per_sm=buf[5 * i + 4]) for i in range(4)]


def kernel_attrs(dtype: torch.dtype, cpfit: bool, s: int) -> list:
    """`lib_attrs` of the sweep library for (dtype, residual mode)."""
    return lib_attrs(_load(dtype, cpfit), s)


def correction_sweep(inp: torch.Tensor, *, cpfit: bool, mixture_th: float = 0.0,
                     static_no_mig: bool = False, has_pulse: bool = True,
                     rounds: int = 2, iters0: int = 8, iters_warm: int = 2,
                     max_squarings: int = 8) -> torch.Tensor:
    """The fused sweep, inp (7, s, B) -> out (8, s, B).

    A CPU tensor takes `correction_sweep_plain`; a CUDA tensor launches the
    kernel (csrc/correction_sweep.cu) on the current stream, or raises.
    """
    opts = dict(cpfit=cpfit, mixture_th=mixture_th, static_no_mig=static_no_mig,
                has_pulse=has_pulse, rounds=rounds, iters0=iters0,
                iters_warm=iters_warm, max_squarings=max_squarings)
    if inp.device.type == "cpu":
        return correction_sweep_plain(inp, **opts)
    if inp.device.type != "cuda":
        raise ValueError(f"unsupported device {inp.device}")
    if inp.dtype not in _DTYPES:
        raise TypeError(f"correction_sweep takes float32 or float64, not {inp.dtype}")
    if inp.dim() != 3 or inp.shape[0] != 7:
        raise ValueError(f"expected input (7, s, B), got {tuple(inp.shape)}")
    if not inp.is_contiguous():
        raise ValueError("correction_sweep input must be contiguous")
    s, B = inp.shape[1], inp.shape[2]
    if not 1 <= s <= MAX_INTERVALS:
        raise ValueError(f"the kernel holds 1..{MAX_INTERVALS} intervals, got {s}")
    out = torch.empty((8, s, B), dtype=inp.dtype, device=inp.device)
    if B == 0:
        return out
    fn = _load(inp.dtype, cpfit).sweep
    with torch.cuda.device(inp.device):
        stream = torch.cuda.current_stream(inp.device).cuda_stream
        err = fn(inp.data_ptr(), out.data_ptr(), s, B, int(static_no_mig),
                 int(has_pulse), float(mixture_th), int(rounds), int(iters0),
                 int(iters_warm), int(max_squarings), stream)
    if err != 0:
        raise RuntimeError(f"correction_sweep kernel launch failed: CUDA error {err}")
    correction_sweep.launches += 1
    return out


correction_sweep.launches = 0


def sweep_inputs(mi: torch.Tensor, pu: torch.Tensor, lh: torch.Tensor,
                 times: torch.Tensor) -> torch.Tensor:
    """The kernel's (7, s, B) input from (B, s, 2) tables; ``lh`` (s, 2) and
    ``times`` (s,) are broadcast over the lanes."""
    B, s = mi.shape[0], mi.shape[1]
    dt = mi.dtype
    if lh.dim() == 2:
        lh = lh.expand(B, s, 2)
    if times.dim() == 1:
        times = times.expand(B, s)
    return torch.stack([
        times.to(dt).T, lh[..., 0].to(dt).T, lh[..., 1].to(dt).T,
        mi[..., 0].T, mi[..., 1].T, pu[..., 0].to(dt).T, pu[..., 1].to(dt).T,
    ]).contiguous()


def fused_correction(mi: torch.Tensor, pu: torch.Tensor, lh: torch.Tensor,
                     times: torch.Tensor, **opts):
    """Run the sweep for candidate tables ``mi``, ``pu`` (B, s, 2).

    ``lh`` is (s, 2) or per-lane (B, s, 2); ``times`` is (s,) or per-lane
    (B, s), where zero-length rows are exact no-ops.  Returns lc (B, s, 2)
    and p_after (B, s, 2, 3).
    """
    B, s = mi.shape[0], mi.shape[1]
    out = correction_sweep(sweep_inputs(mi, pu, lh, times), **opts)
    lc = out[:2].permute(2, 1, 0)  # (B, s, 2)
    p_after = out[2:].reshape(2, 3, s, B).permute(3, 2, 0, 1)  # (B, s, 2, 3)
    return lc, p_after
