"""The port's lockstep Nelder-Mead (misti_tpu_torch.engine.optimize) against
scipy and the JAX package's `nelder_mead`, float64 on the CPU."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from scipy import optimize as sopt

from misti_tpu.engine.optimize import nelder_mead as jax_nelder_mead
from misti_tpu_torch import build_likelihood, build_spec
from misti_tpu_torch.engine.optimize import NMState, nelder_mead, solve_batch
from _torch_sweep_cases import one_torch_thread  # noqa: F401 (autouse fixture)

# test_optimize.py's three functions, each written once for jnp vectors (x)
# and once for torch points (..., n)
FUNCS = [
    (lambda x: (x[0] - 1.3) ** 2 + 2.0 * (x[1] + 0.4) ** 2,
     lambda p: (p[..., 0] - 1.3) ** 2 + 2.0 * (p[..., 1] + 0.4) ** 2, [0.0, 0.0]),
    (lambda x: (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2,
     lambda p: (1 - p[..., 0]) ** 2 + 100 * (p[..., 1] - p[..., 0] ** 2) ** 2, [-1.2, 1.0]),
    (lambda x: jnp.abs(x[0] - 0.7) + (x[1] * x[2]) ** 2,
     lambda p: (p[..., 0] - 0.7).abs() + (p[..., 1] * p[..., 2]) ** 2, [0.1, 0.5, -0.5]),
]


def _run(ft, x0, **kw):
    return nelder_mead(ft, torch.tensor([x0], dtype=torch.float64), **kw)


@pytest.mark.parametrize("fj,ft,x0", FUNCS, ids=["quadratic", "rosenbrock", "abs3"])
def test_nm_matches_scipy(fj, ft, x0):
    ours = _run(ft, x0, xatol=1e-6, fatol=1e-6, maxiter=2000)
    ref = sopt.minimize(lambda x: float(ft(torch.from_numpy(x))), np.asarray(x0),
                        method="Nelder-Mead",
                        options={"xatol": 1e-6, "fatol": 1e-6, "maxiter": 2000})
    assert bool(ours.converged[0])
    np.testing.assert_allclose(ours.x[0].numpy(), ref.x, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(ours.fun[0]), ref.fun, rtol=1e-6, atol=1e-9)
    # the same update rules take the same path as scipy's
    assert int(ours.nit[0]) == ref.nit and int(ours.nfev[0]) >= ref.nfev


@pytest.mark.parametrize("fj,ft,x0", FUNCS, ids=["quadratic", "rosenbrock", "abs3"])
def test_nm_matches_jax_nelder_mead(fj, ft, x0):
    """Equal iteration and evaluation counts; x and fun to 1e-9 relative:
    XLA:CPU contracts the jitted vertex updates (e.g. 3 xbar - 2 x_n) into
    fused multiply-adds, torch's CPU ops round each product, so the two
    trajectories part in the last bits."""
    ref = jax_nelder_mead(fj, jnp.asarray(x0), xatol=1e-6, fatol=1e-6, maxiter=2000)
    ours = _run(ft, x0, xatol=1e-6, fatol=1e-6, maxiter=2000)
    assert int(ours.nit[0]) == int(ref.nit)
    assert int(ours.nfev[0]) == int(ref.nfev)
    assert bool(ours.converged[0]) == bool(ref.converged)
    np.testing.assert_allclose(ours.x[0].numpy(), np.asarray(ref.x), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(float(ours.fun[0]), float(ref.fun), rtol=1e-9, atol=1e-14)


def test_lockstep_equals_standalone_bitwise():
    """Three problems of different lengths in one batch: each lane's result,
    counters and iteration count are those of its own run."""
    ft = FUNCS[1][1]
    starts = [[-1.2, 1.0], [0.5, 0.5], [2.0, -1.0]]
    both = nelder_mead(ft, torch.tensor(starts, dtype=torch.float64), xatol=1e-8,
                       fatol=1e-8, maxiter=3000)
    assert len(set(both.nit.tolist())) == 3  # the lanes stop at different steps
    for i, x0 in enumerate(starts):
        one = _run(ft, x0, xatol=1e-8, fatol=1e-8, maxiter=3000)
        assert torch.equal(both.x[i], one.x[0])
        assert torch.equal(both.fun[i], one.fun[0])
        assert int(both.nit[i]) == int(one.nit[0])
        assert int(both.nfev[i]) == int(one.nfev[0])


def test_resume_from_state_equals_uninterrupted():
    ft = FUNCS[1][1]
    x0 = torch.tensor([[-1.2, 1.0], [0.3, 0.2]], dtype=torch.float64)
    full = nelder_mead(ft, x0, xatol=1e-8, fatol=1e-8, maxiter=500)
    part, st = nelder_mead(ft, x0, xatol=1e-8, fatol=1e-8, maxiter=7, with_state=True)
    assert isinstance(st, NMState) and st.it.tolist() == [7, 7]
    rest = nelder_mead(ft, x0, xatol=1e-8, fatol=1e-8, maxiter=500, state0=st)
    for a, b in zip(rest, full):
        assert torch.equal(a, b)


def test_inf_objective_and_aux_counters():
    """+inf trial values are ordinary large values (scipy's rule); aux
    vectors are summed over every evaluated point of a live lane."""

    def ft(p):
        val = torch.where(p[..., 0] < 0, torch.full_like(p[..., 0], float("inf")),
                          (p[..., 0] - 0.5) ** 2)
        aux = torch.stack([torch.ones_like(val), (p[..., 0] < 0).to(val.dtype)], dim=-1)
        return val, aux

    res = nelder_mead(ft, torch.tensor([[2.0], [-3.0]], dtype=torch.float64),
                      xatol=1e-6, fatol=1e-6, maxiter=200, naux=2)
    assert bool(res.converged[0])
    np.testing.assert_allclose(float(res.x[0, 0]), 0.5, atol=1e-4)
    assert float(res.aux_sum[0, 0]) == float(res.nfev[0])
    # a lane whose whole simplex is +inf never converges, like scipy
    assert not bool(res.converged[1]) and int(res.nit[1]) == 201
    assert float(res.aux_sum[1, 1]) == float(res.nfev[1])
    ref = jax_nelder_mead(lambda x: jnp.where(x[0] < 0, jnp.inf, (x[0] - 0.5) ** 2),
                          jnp.asarray([2.0]), xatol=1e-6, fatol=1e-6, maxiter=200)
    assert int(res.nit[0]) == int(ref.nit) and int(res.nfev[0]) == int(ref.nfev)


def test_stable_sort_keeps_tied_vertices_in_order():
    """Every vertex +inf: the stable sort leaves the simplex as scipy (and
    jnp.argsort) would, so each shrink keeps vertex 0 in place."""
    inf = lambda p: torch.full(p.shape[:-1], float("inf"), dtype=p.dtype)
    res, st = nelder_mead(inf, torch.tensor([[1.0, 2.0]], dtype=torch.float64),
                          maxiter=3, with_state=True)
    assert torch.equal(st.sim[0, 0], torch.tensor([1.0, 2.0], dtype=torch.float64))


def test_solve_batch_fits_each_start_as_alone():
    """Lockstep fits of one likelihood from three starts: each equals its
    own one-start fit bitwise."""
    spec = build_spec([0.1, 0.2, 0.3, 0.4], [[1.0, 1.5], [0.8, 1.2], [1.1, 0.9],
                      [1.0, 1.0], [1.2, 1.2]], [0, 50, 20, 40, 10, 8, 5, 3], 2,
                      [[1, 0, 2, 0.2, 1]], [], correct=False, unfolded=True)
    lik = build_likelihood(spec, device="cpu")
    starts = np.array([[0.2], [0.05], [0.6]])
    both = solve_batch(lik, starts, tol=1e-4)
    for i in range(3):
        one = solve_batch(lik, starts[i:i + 1], tol=1e-4)
        assert torch.equal(both.x[i], one.x[0]) and torch.equal(both.fun[i], one.fun[0])
        assert int(both.nfev[i]) == int(one.nfev[0])
    assert bool(both.converged.all())
