"""The port's single fit (misti_tpu_torch.solve) against the JAX package's
``solve``, float64 on the CPU.

solve.npz's model (15 intervals, split 7, one optimised band) is fitted
with the uncorrected rates (trueEPS): the JAX side then compiles its fit
program in a few seconds, where the corrected ones take 50-130 s on XLA:CPU.
The corrected single fit is held against the JAX CLI and upstream's .mi
files in test_torch_misti_cli.py.
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_fixture
from misti_tpu.engine.likelihood import build_likelihood as jax_build_likelihood
from misti_tpu.engine.optimize import solve as jax_solve
from misti_tpu.engine.spec import build_spec as jax_build_spec
from misti_tpu_torch import SolveResult, build_likelihood, build_spec, solve
from _torch_sweep_cases import one_torch_thread  # noqa: F401 (autouse fixture)


def _spec_args(mi=None):
    fx = load_fixture("solve.npz")
    mi = [list(v) for v in fx["mi"]] if mi is None else mi
    return (list(fx["times"]), [list(v) for v in fx["lams"]], list(fx["sfs"]),
            float(fx["splitT"]), mi, [])


SPEC_KW = dict(unfolded=True, smooth=False, correct=False)


def _quiet(fn, *a, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **kw)
    return out, buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def fits():
    """(port SolveResult, its stdout lines with trace=True, JAX SolveResult,
    the JAX stdout lines) on solve.npz."""
    lik = build_likelihood(build_spec(*_spec_args(), **SPEC_KW), device="cpu")
    ours, out = _quiet(solve, lik, tol=1e-4, trace=True)
    ref, ref_out = _quiet(jax_solve, jax_build_likelihood(jax_build_spec(*_spec_args(), **SPEC_KW)),
                          tol=1e-4)
    return ours, out, ref, ref_out


def test_solve_matches_jax(fits):
    ours, _, ref, _ = fits
    assert isinstance(ours, SolveResult)
    np.testing.assert_allclose(ours.x, ref.x, rtol=0, atol=1e-8)
    np.testing.assert_allclose(ours.llh, ref.llh, rtol=0, atol=1e-10)
    assert (ours.nit, ours.nfev, ours.corr_called, ours.corr_failed) == (
        ref.nit, ref.nfev, ref.corr_called, ref.corr_failed)


def test_report_counters(fits):
    """As test_optimize.py's: the result unpacks like [params, llh];
    CorrectLambdas is still called once per guarded evaluation under
    trueEPS and never fails."""
    sol = fits[0]
    x, llh = sol
    assert llh == sol.llh and np.array_equal(x, sol.x) and len(sol) == 2
    assert repr(sol) == repr([sol.x, sol.llh])
    assert sol.nfev >= 2 + sol.nit - 1
    assert 0 < sol.corr_called <= sol.nfev
    assert sol.corr_failed == 0


def test_summary_and_trace_lines(fits):
    """On the CPU: one "<p> <-llh>" line per evaluated point, then the JAX
    package's four summary lines to the character."""
    ours, out, _, ref_out = fits
    trace, summary = out[:-4], out[-4:]
    assert summary == ref_out
    assert summary[0] == "Optimization terminated successfully."
    assert len(trace) == ours.nfev
    p, f = trace[0].rsplit(" ", 1)
    assert p == str(np.asarray([0.5])) and np.isfinite(float(f))


class _FakeSpec:
    n_params = 2
    init_params = np.array([0.45, 0.0])


def _double_well(p0, p1):
    return (4.0 * p0**2 - 1.0) ** 2 + 0.3 * p0 + p1**2


class _FakeLik:
    """test_optimize.py's asymmetric double well, batch-first: plain
    Nelder-Mead from the start stays in the local well near x = +0.5, the
    global one is near x = -0.5."""

    spec = _FakeSpec()
    device = torch.device("cpu")
    dtype = torch.float64

    def llh_flags_batch(self, p):
        return -_double_well(p[:, 0], p[:, 1]), torch.zeros(p.shape[0], 2, dtype=p.dtype)


class _JaxFakeLik:
    spec = _FakeSpec()

    def llh_flags(self, p):
        return -_double_well(p[0], p[1]), jnp.zeros(2)


def test_basinhopping_matches_jax():
    """The host loop draws the same steps from default_rng(0) and takes the
    same Metropolis decisions: the same minimum, x to 1e-8."""
    local, _ = _quiet(solve, _FakeLik(), tol=1e-6)
    assert abs(local.x[0] - 0.5) < 0.1
    ours = solve(_FakeLik(), tol=1e-6, global_opt=True, seed=0, n_hops=25)
    ref = jax_solve(_JaxFakeLik(), tol=1e-6, global_opt=True, seed=0, n_hops=25)
    assert abs(ours.x[0] + 0.5) < 0.1 and ours.llh > local.llh
    np.testing.assert_allclose(ours.x, ref.x, rtol=0, atol=1e-8)
    np.testing.assert_allclose(ours.llh, ref.llh, rtol=0, atol=1e-12)
    assert (ours.nit, ours.nfev) == (ref.nit, ref.nfev)


def test_solve_without_parameters():
    """No optimised parameter (a fixed band): one evaluation, no summary."""
    mi = [[1, 2, 7, 0.5, 0]]
    lik = build_likelihood(build_spec(*_spec_args(mi), **SPEC_KW), device="cpu")
    sol, out = _quiet(solve, lik, tol=1e-4, trace=True)
    ref = jax_solve(jax_build_likelihood(jax_build_spec(*_spec_args(mi), **SPEC_KW)))
    assert out == [] and sol.x.shape == (0,)
    assert (sol.nit, sol.nfev, sol.corr_called, sol.corr_failed) == (0, 1, 1, 0)
    assert (ref.nfev, ref.corr_called, ref.corr_failed) == (1, 1, 0)
    np.testing.assert_allclose(sol.llh, ref.llh, rtol=0, atol=1e-10)
    np.testing.assert_allclose(sol.llh, float(lik.llh(np.zeros(0))), rtol=0, atol=0)
