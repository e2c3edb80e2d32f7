"""Shared inputs for the fused-sweep parity tests (tests/test_torch_correction_*.py),
and the one-thread fixture of the sweep tests (tests/test_torch_sweep*.py,
tests/test_torch_optimize.py).

One seeded numpy draw goes to both packages: the JAX package's CPU form of
the kernel (``build_fused_correction(..., mode="xla")``) and the port's plain
version, at s = 6 intervals and B = 5 lanes.
"""

import jax
import numpy as np
import pytest
import torch

from misti_tpu.kernels.correction_pallas import build_fused_correction
from misti_tpu_torch.kernels.correction_fused import fused_correction

S, B = 6, 5


def draw(seed, *, mig=True, pulse=False):
    """(lh (S, 2), times (S,), mi (B, S, 2), pu (B, S, 2)); lane 0 has no
    migration so the no-migration branch runs beside the general one."""
    rng = np.random.default_rng(seed)
    lh = rng.uniform(0.5, 2.0, (S, 2))
    times = rng.uniform(0.05, 0.3, S)
    mi = rng.uniform(0.0, 0.5, (B, S, 2)) if mig else np.zeros((B, S, 2))
    mi[0] = 0.0
    pu = np.zeros((B, S, 2))
    if pulse:
        pu[:, 2, 1] = rng.uniform(0.0, 0.3, B)
        pu[:, 4, 0] = rng.uniform(0.0, 0.2, B)
    return lh, times, mi, pu


def jax_sweep(lh, times, mi, pu, **opts):
    """The JAX package's sweep; per-lane tables when lh is (B, S, 2)."""
    if lh.ndim == 3:
        f = build_fused_correction(None, None, n_intervals=S, mode="xla", **opts)
        lc, pa = jax.jit(f)(mi, pu, lh, times)
    else:
        f = build_fused_correction(lh, times, mode="xla", **opts)
        lc, pa = jax.jit(f)(mi, pu)
    return np.asarray(lc), np.asarray(pa)


def torch_sweep(lh, times, mi, pu, **opts):
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    lc, pa = fused_correction(t(mi), t(pu), t(lh), t(times), **opts)
    return lc.numpy(), pa.numpy()


def assert_sweeps_agree(lh, times, mi, pu, **opts):
    """rtol 1e-6 / atol 1e-9, not bitwise: a one-ULP difference between the
    two frameworks can flip one LM accept near convergence (both iterates
    meet the 1e-13 step tolerance)."""
    lc_j, pa_j = jax_sweep(lh, times, mi, pu, **opts)
    lc_t, pa_t = torch_sweep(lh, times, mi, pu, **opts)
    assert lc_t.shape == (B, S, 2) and pa_t.shape == (B, S, 2, 3)
    np.testing.assert_allclose(lc_t, lc_j, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(pa_t, pa_j, rtol=1e-6, atol=1e-9)
    return lc_t


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for a module's torch ops: its tensors are small,
    so more threads only crowd the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
