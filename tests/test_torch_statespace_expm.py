"""The port's state-space assemblers and expm kernels against misti_tpu.

Float64 on the CPU.  Inputs come from a seeded numpy RNG and go to both
packages; the fixtures in statespace.npz were made by running upstream MiSTI.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from conftest import load_fixture
from misti_tpu.kernels import expm as jke
from misti_tpu.model import statespace as jss
from misti_tpu_torch.kernels import expm as tke
from misti_tpu_torch.model import statespace as tss

F64 = dict(dtype=torch.float64)


def test_basis_tables_equal_jax_package():
    for name in ("coal", "migr", "jsfs", "collapse", "ancient", "pulse_coeff", "pulse_k",
                 "stationary_mask"):
        np.testing.assert_array_equal(getattr(tss.two_pop_basis(), name),
                                      getattr(jss.two_pop_basis(), name), err_msg=name)
    for name in ("coal", "jsfs"):
        np.testing.assert_array_equal(getattr(tss.one_pop_basis(), name),
                                      getattr(jss.one_pop_basis(), name), err_msg=name)


def test_two_pop_matrix_matches_reference_batched():
    fx = load_fixture("statespace.npz")
    rates = torch.tensor(fx["two_rates"], **F64)  # (n, 4)
    m = tss.two_pop_matrix(*rates.unbind(-1))
    assert m.shape == (len(rates), 44, 44)
    np.testing.assert_allclose(m.numpy(), fx["two_mats"], rtol=0, atol=1e-12)
    for r, mi in zip(fx["two_rates"], m.numpy()):
        np.testing.assert_allclose(mi, jss.two_pop_matrix(*r), rtol=0, atol=1e-15)


def test_one_pop_matrix_matches_reference():
    fx = load_fixture("statespace.npz")
    m = tss.one_pop_matrix(torch.tensor([0.9, 2.5], **F64))
    np.testing.assert_allclose(m[0].numpy(), fx["one_mat"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(m[1].numpy(), jss.one_pop_matrix(2.5), rtol=0, atol=1e-15)


def test_correction_matrix_matches_jax_package():
    rng = np.random.default_rng(1)
    r = rng.uniform(0.0, 3.0, (6, 4))
    m = tss.correction_matrix(*torch.tensor(r, **F64).unbind(-1))
    want = jss.correction_matrix(r[:, 0], r[:, 1], r[:, 2], r[:, 3])
    np.testing.assert_allclose(m.numpy(), want, rtol=0, atol=1e-15)


def test_pulse_operator_matches_reference_batched():
    fx = load_fixture("statespace.npz")
    for pop in (0, 1):
        r = float(fx[f"pulse_rate_pop{pop}"])
        rates = torch.tensor([r, 0.0, 0.37], **F64)
        P = tss.pulse_operator(rates, pop).numpy()
        np.testing.assert_allclose(P[0], fx[f"pulse_mat_pop{pop}"], rtol=1e-12, atol=1e-13)
        np.testing.assert_array_equal(P[1], np.eye(44))  # P(0) is exactly I
        want = np.asarray(jax.jit(jss.pulse_operator, static_argnums=1)(0.37, pop))
        np.testing.assert_allclose(P[2], want, rtol=1e-12, atol=1e-15)


def _action_case():
    """Spectrum-shaped inputs: the static (44, 176) basis, per-lane rates
    whose sub-step counts differ, and one runaway lane past the cost cap."""
    b2 = jss.two_pop_basis()
    kmat = np.concatenate([b2.coal[0].T, b2.coal[1].T, b2.migr[0].T, b2.migr[1].T], axis=1)
    norms = np.abs(np.stack([b2.coal[0], b2.coal[1], b2.migr[0], b2.migr[1]])).sum(1).max(1)
    rng = np.random.default_rng(7)
    coeffs = rng.uniform(0.1, 1.5, (5, 4)) * np.array([[1], [4], [15], [40], [1]])
    coeffs[4] = [1e6, 1.0, 1.0, 1.0]  # runaway: past theta * max_substeps
    p0 = rng.uniform(0.0, 1.0, (5, 44))
    return kmat, norms, coeffs, 0.3, p0


def test_expm_action_pair_matches_jax_ragged_and_runaway():
    kmat, norms, coeffs, t, p0 = _action_case()
    m, over = tke.substep_counts(torch.tensor(coeffs, **F64), norms, t)
    assert len(set(m[:4].tolist())) == 4, m  # ragged per-lane sub-step counts
    assert over.tolist() == [False, False, False, False, True]
    basis = tke.sparse_basis(torch.tensor(kmat, **F64), coeffs.shape[1])
    p1, n1p = tke.expm_action_pair(basis, torch.tensor(coeffs, **F64), norms, t,
                                   torch.tensor(p0, **F64))
    f = jax.jit(jax.vmap(lambda c, p: jke.expm_action_pair(jnp.asarray(kmat), c, norms, t, p)))
    w1, wn = (np.asarray(x) for x in f(jnp.asarray(coeffs), jnp.asarray(p0)))
    np.testing.assert_allclose(p1[:4].numpy(), w1[:4], rtol=1e-12, atol=1e-300)
    np.testing.assert_allclose(n1p[:4].numpy(), wn[:4], rtol=1e-12, atol=1e-300)
    assert np.isnan(p1[4].numpy()).all() and np.isnan(n1p[4].numpy()).all()
    assert np.isnan(w1[4]).all()


@pytest.mark.parametrize("scale", [1e-6, 0.3, 4.0, 60.0])
def test_expm_and_expm_m1_match_scipy_and_jax(scale):
    rng = np.random.default_rng(3)
    a = (rng.normal(size=(3, 4, 4)) - 2 * np.eye(4)) * scale
    e = tke.expm(torch.tensor(a, **F64)).numpy()
    phi = tke.expm_m1(torch.tensor(a, **F64)).numpy()
    for i in range(3):
        ref = scipy.linalg.expm(a[i])
        np.testing.assert_allclose(e[i], ref, rtol=1e-10, atol=1e-13)
        # scipy's e^A - I itself carries ~1e-16 absolute cancellation error
        np.testing.assert_allclose(phi[i], ref - np.eye(4), rtol=1e-10, atol=1e-15)
    np.testing.assert_allclose(e, np.asarray(jke.expm(jnp.asarray(a))), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(phi, np.asarray(jke.expm_m1(jnp.asarray(a))), rtol=1e-12,
                               atol=1e-300)
