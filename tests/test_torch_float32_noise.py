"""The float32 sweep's llh noise against the optimiser's tolerance (port only).

On the north-star ECT cell that float32 sweeps on the card left unconverged
(tests/fixtures/sweep*.psmc + sweep.jsfs, ``-mi 1 4 ST 3 1 -uf``, bootstrap
seed 0, smoothing on; split 27, bootstrap row 13): a float32 run's llh must
track the float64 llh closely enough that Nelder-Mead's ``fatol`` = 1e-4
test can pass near the optimum, and a float32 lockstep fit from the spec's
start must converge there.  Before the likelihood computed in float64
(config.LLH_DTYPE) the float32 llh stepped by ~1e-3 nats between rates
1e-3 apart (tests/torch_float32_noise_stages.py).
"""

import os

import numpy as np
import pytest
import torch

from misti_tpu_torch.engine import bootstrap
from misti_tpu_torch.engine.bootstrap import _lane_objective
from misti_tpu_torch.engine.optimize import nelder_mead
from misti_tpu_torch.engine.sweep_fused import build_fused_sweep
from misti_tpu_torch.io import jsfs as io_jsfs
from misti_tpu_torch.io import psmc as io_psmc

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
SPLIT, ROW = 27.0, 13
FATOL = 1e-4  # the sweep's tol (xatol = fatol)
MAXITER = 1000  # the sweep's --maxiter


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the lanes are few, more threads crowd the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cell():
    """(float32 sweep, float64 sweep, the cell's data row, float64 llh of a
    rate (N,) -> (N,))."""
    inp = io_psmc.read_psmc(f"{FIX}/sweep1.psmc", f"{FIX}/sweep2.psmc", 0, -1)
    data = bootstrap.make_bootstrap_data(io_jsfs.read_jafs(f"{FIX}/sweep.jsfs"), 100, seed=0)
    kw = dict(sample_date=inp.sample_date_discr, cpfit=False, smooth=True, unfolded=True,
              device="cpu")
    fs = [build_fused_sweep(inp.times, inp.lambdas, [SPLIT], [["1", "4", "ST", "3", "1"]],
                            dtype=dt, **kw) for dt in (torch.float32, torch.float64)]
    d = data[ROW]

    def llh(f, xs):
        xs = np.asarray(xs, float).reshape(-1, 1)
        return f.llh(np.zeros(len(xs)), xs, np.tile(d, (len(xs), 1))).double().numpy()

    return fs[0], fs[1], d, llh


def _fit(f, d, dtype, tol):
    obj = _lane_objective(f.llh, torch.zeros(1, dtype=torch.int64), torch.tensor(d[None]), [0])
    return nelder_mead(obj, torch.tensor(f.init_params[None], dtype=dtype), xatol=tol,
                       fatol=tol, maxiter=MAXITER)


@pytest.fixture(scope="module")
def optimum64(cell):
    """(x*, llh*): the float64 fit to 1e-8."""
    fs32, fs64, d, llh = cell
    res = _fit(fs64, d, torch.float64, 1e-8)
    return float(res.x[0, 0]), float(-res.fun[0])


def test_float32_llh_noise_below_half_fatol(cell, optimum64):
    """41 rates over x* +- 0.02 as one batch: llh32 - llh64 spreads by less
    than fatol / 2 (the parent's float32 spread 2.7e-3 nats here)."""
    fs32, fs64, d, llh = cell
    x_opt, _ = optimum64
    xs = np.linspace(x_opt - 0.02, x_opt + 0.02, 41)
    diff = llh(fs32, xs) - llh(fs64, xs)
    assert np.isfinite(diff).all()
    assert diff.max() - diff.min() < FATOL / 2, diff.max() - diff.min()


def test_float32_fit_converges_at_the_float64_optimum(cell, optimum64):
    """The float32 lockstep Nelder-Mead from the spec's start converges
    before --maxiter, at a rate whose float64 llh is within fatol of the
    float64 optimum."""
    fs32, fs64, d, llh = cell
    res = _fit(fs32, d, torch.float32, FATOL)
    assert bool(res.converged[0]) and int(res.nit[0]) < MAXITER
    _, llh_opt = optimum64
    assert llh(fs64, res.x[0].double().numpy())[0] >= llh_opt - FATOL
