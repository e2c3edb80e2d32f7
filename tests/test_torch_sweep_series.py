"""The degree-18 Taylor series of the port's correction sweep
(misti_tpu_torch/kernels/correction_fused.py `_ps_horner`, Paterson-Stockmeyer
in base 3 as the CUDA kernel evaluates it) against exact values from
``scipy.linalg`` in float64, on both routes the plain version takes: on
plain tensors (the chain), and under ``torch.func.jvp`` with its constants
lifted to duals (the LM residuals), where the tangent is held against the
exact Frechet derivative too.

Each table is a known matrix function of the scaled generator b (one-norm
at most 1, as after the sweep's scaling step):

* ``_CE``: e^b;
* ``_CPHI``: e^b - I;
* ``_C1``: phi1(b) = int_0^1 e^{bs} ds;
* ``_CJ``: the centred moment J = int_0^1 (s - 1/2) e^{bs} ds.

The integrals come from the exponential of a block upper-triangular matrix
(Van Loan): with M = [[b, I, 0], [0, 0, I], [0, 0, 0]], the (0, 1) block of
e^M is int_0^1 e^{bs} ds and the (0, 2) block is int_0^1 (1 - s) e^{bs} ds;
their derivatives along E are the same blocks of the Frechet derivative of
e^M along [[E, 0, 0], [0, 0, 0], [0, 0, 0]].  At norm 1 the truncation
error of degree 18 is below 1/19! ~ 8e-18, so the tolerance (atol 2e-15
on values and tangents of size ~1, some 10 ulp) is rounding alone.
"""

import numpy as np
import pytest
import scipy.linalg
import torch

from misti_tpu_torch.kernels import correction_fused as cf

N = 48


def _generators(seed):
    """N two-lineage location generators (the sweep's 3x3 form) with random
    rates, scaled to a one-norm in (0, 1], and N unit directions."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(N):
        l0, l1 = rng.uniform(0.0, 3.0, 2)
        m0, m1 = rng.uniform(0.0, 1.5, 2) * (rng.uniform() < 0.8)
        a = np.array([[-2 * m0 - l0, 0.0, m1],
                      [0.0, -2 * m1 - l1, m0],
                      [2 * m0, 2 * m1, -m0 - m1]])
        norm = np.abs(a).sum(0).max()
        out.append(a * rng.uniform(0.05, 1.0) / norm)
    e = rng.normal(size=(N, 3, 3))
    return np.stack(out), e / np.abs(e).sum(1).max(1)[:, None, None]


def _exact(b, e, table):
    """(value, derivative along e) of the table's matrix function at b."""
    if table in ("CE", "CPHI"):
        val, der = scipy.linalg.expm_frechet(b, e)
        return (val - np.eye(3) if table == "CPHI" else val), der
    m = np.zeros((9, 9))
    m[:3, :3] = b
    m[:3, 3:6] = np.eye(3)
    m[3:6, 6:] = np.eye(3)
    dm = np.zeros((9, 9))
    dm[:3, :3] = e
    pair = scipy.linalg.expm_frechet(m, dm)
    phi1, tail = (x[:3, 3:6] for x in pair), (x[:3, 6:] for x in pair)
    if table == "C1":
        return tuple(phi1)
    return tuple(0.5 * p - t for p, t in zip(phi1, tail))


def _entries(m):
    return tuple(torch.tensor(m[:, i, j]) for i in range(3) for j in range(3))


def _matrix(entries):
    return torch.stack(entries, 1).reshape(N, 3, 3).numpy()


@pytest.mark.parametrize("route", ["plain", "dual"])
@pytest.mark.parametrize("table", ["CE", "C1", "CPHI", "CJ"])
def test_series_matches_scipy(table, route):
    b, e = _generators(7)
    assert np.abs(b).sum(1).max() <= 1.0 + 1e-15
    coeffs = getattr(cf, "_" + table)
    want = [np.stack(x) for x in zip(*(_exact(bi, ei, table) for bi, ei in zip(b, e)))]
    if route == "plain":
        got = _matrix(cf._ps_horner(cf._ps_powers(_entries(b)), coeffs))
    else:
        def series(*x):
            k = cf._dual_consts(x[0])
            return cf._ps_horner(cf._ps_powers(x, k), coeffs, k)

        vals, tans = torch.func.jvp(series, _entries(b), _entries(e))
        got = _matrix(vals)
        np.testing.assert_allclose(_matrix(tans), want[1], rtol=0, atol=2e-15)
    np.testing.assert_allclose(got, want[0], rtol=0, atol=2e-15)
