"""The port's fused split-time sweep and bootstrap sweep
(misti_tpu_torch.engine.sweep_fused / .bootstrap) against the JAX package and
against the port's own per-split likelihood, float64 on the CPU, at the JAX
tests' toy size (12 intervals, splits 4-7).

JAX-side fused-xla compiles are the slow part (~5-20 s each on XLA:CPU):
three configurations are compiled, once each.
"""

import jax
import numpy as np
import pytest
import torch

from misti_tpu.engine import bootstrap as jax_bootstrap
from misti_tpu.engine.sweep_fused import build_fused_sweep as jax_build_fused_sweep
from misti_tpu.io.data import Jafs as JaxJafs
from misti_tpu_torch import build_likelihood, build_spec
from misti_tpu_torch.engine import bootstrap
from misti_tpu_torch.engine.sweep_fused import build_fused_sweep
from misti_tpu_torch.io.data import Jafs
from test_sweep_fused import _toy
from _torch_sweep_cases import one_torch_thread  # noqa: F401 (autouse fixture)

BASE = np.array([3000.0, 800, 2900, 1500, 1200, 850, 1250])
# the model's own spectrum (split 5, one band at 0.4, x 12000): replicates
# near it have interior optima that the fits reach at different iterations
MODEL = np.array([3317.9, 571.4, 3298.2, 2083.7, 1071.3, 576.4, 1081.1])

# (name, spec flags, mi template, pu template, splits)
CONFIGS = {
    # two optimised bands, smoothing, fractional splits
    "cpfit_2band_smooth": (dict(cpfit=True, smooth=True, unfolded=True),
                           [[1, 2, "ST", 0.3, 1], [2, 2, "ST", 0.3, 1]], [], [4, 4.5, 6.25, 7]),
    # ECT with an optimised pulse and an ancient sample (no migration band)
    "ect_pulse_sdate": (dict(cpfit=False, smooth=False, unfolded=False, sample_date=2),
                        [], [[2, 3, 0.1, 1]], [4, 5.5, 7]),
    # cpfit with a band, a fixed pulse and a sample date at a split
    "cpfit_pulse_fixed": (dict(cpfit=True, smooth=False, unfolded=True, sample_date=4),
                          [[1, 4, "ST", 0.25, 1]], [[2, 5, 0.15, 0]], [5, 6]),
    # trueEPS
    "trueeps": (dict(cpfit=True, smooth=True, unfolded=True, correct=False),
                [[1, 0, "ST", 0.25, 1]], [], [4, 7]),
}


def _data(rng, n):
    return np.stack([BASE * rng.uniform(0.9, 1.1, size=7) for _ in range(n)])


def _build(name, **kw):
    flags, mi, pu, splits = CONFIGS[name]
    times, lams = _toy()
    return build_fused_sweep(times, lams, splits, mi, pu, device="cpu", **flags, **kw)


def _build_jax(name):
    flags, mi, pu, splits = CONFIGS[name]
    times, lams = _toy()
    return jax_build_fused_sweep(times, lams, splits, mi, pu, correction_mode="fused-xla",
                                 **flags)


def _cells(fs, seed, per_split=3):
    """A grid of cells: every split x ``per_split`` parameter points, data
    rows from the seed."""
    rng = np.random.default_rng(seed)
    S = len(fs.split_times)
    st = np.repeat(np.arange(S), per_split)
    params = rng.uniform(0.02, 0.8, (st.size, fs.n_params))
    return st, params, _data(rng, st.size)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tables_equal_jax(name):
    fs, fj = _build(name), _build_jax(name)
    assert fs.n_params == fj.n_params
    np.testing.assert_array_equal(fs.init_params, fj.init_params)
    assert sorted(fs.tables) == sorted(fj.tables)
    for key, want in fj.tables.items():
        got = fs.tables[key]
        assert got.dtype == np.asarray(want).dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("name", ["cpfit_2band_smooth", "ect_pulse_sdate"])
def test_llh_t_matches_jax_fused_xla(name):
    """Per-lane tables through the whole pipeline (correction, post-split
    fit, smoothing, spectrum) against the JAX package's grid sweep, rtol 1e-6
    as in test_torch_likelihood.py; -inf masks equal."""
    fs, fj = _build(name), _build_jax(name)
    st, params, data = _cells(fs, 11)
    want = np.asarray(jax.jit(jax.vmap(fj.llh))(st, params, data))
    got = fs.llh(st, params, data).numpy()
    assert np.isfinite(want).sum() >= 0.75 * want.size
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("name", ["cpfit_2band_smooth", "ect_pulse_sdate", "cpfit_pulse_fixed",
                                  "trueeps"])
def test_fused_matches_per_split_llh_data(name):
    """Each cell of the fused grid equals the port's own per-split
    likelihood (`build_likelihood(...).llh_data`) to rtol 1e-9.  With
    trueEPS both carry only the pulses into the post-split fit (upstream's
    rule); the JAX package's grid sweep differs there, so that case is held
    here and not against it."""
    flags, mi, pu, splits = CONFIGS[name]
    times, lams = _toy()
    fs = _build(name)
    st, params, data = _cells(fs, 12, per_split=2)
    got = fs.llh(st, params, data).numpy()
    for i, split in enumerate(splits):
        s_i = int(split)
        mi_i = [[r[0], s_i if r[1] == "ST" else r[1], s_i if r[2] == "ST" else r[2], *r[3:]]
                for r in mi]
        spec = build_spec(times, lams, [0.0, *BASE], split, mi_i, pu, **flags)
        lik = build_likelihood(spec, device="cpu")
        rows = st == i
        want = lik.llh_data(params[rows], data[rows]).numpy()
        np.testing.assert_allclose(got[rows], want, rtol=1e-9, atol=1e-9,
                                   err_msg=f"split {split}")


def test_lane_result_does_not_depend_on_the_batch():
    """A lane's llh is bitwise the same alone, in a narrow batch and in a
    wide one: the property staged compaction needs (float64, CPU)."""
    fs = _build("cpfit_2band_smooth")
    st, params, data = _cells(fs, 13, per_split=4)
    full = fs.llh(st, params, data)
    for lanes in ([5], [0, 9], [3, 4, 10, 15, 1, 2, 7]):
        part = fs.llh(st[lanes], params[lanes], data[lanes])
        assert torch.equal(part, full[lanes])


def test_expm_action_pair_takes_per_lane_t():
    """Per-lane interval lengths give each lane its scalar-t result bitwise,
    and a zero-length lane returns its state and a zero occupancy exactly."""
    from misti_tpu_torch.engine.likelihood import SpectrumBasis
    from misti_tpu_torch.kernels.expm import expm_action_pair

    basis = SpectrumBasis(torch.device("cpu"), torch.float64)
    rng = np.random.default_rng(14)
    coeffs = torch.tensor(rng.uniform(0.1, 3.0, (4, 4)))
    p0 = torch.tensor(rng.dirichlet(np.ones(44), 4))
    t = torch.tensor([0.3, 0.0, 1.7, 0.05], dtype=torch.float64)
    p1, n1 = expm_action_pair(basis.sp2, coeffs, basis.norms2, t, p0)
    for i in range(4):
        q1, m1 = expm_action_pair(basis.sp2, coeffs[i:i + 1], basis.norms2, float(t[i]),
                                  p0[i:i + 1])
        assert torch.equal(p1[i], q1[0]) and torch.equal(n1[i], m1[0])
    assert torch.equal(p1[1], p0[1]) and not n1[1].any()


def _sweep(data, **kw):
    """1-band cpfit sweep over splits 4 and 7."""
    times, lams = _toy()
    return bootstrap.sweep(times, lams, data, [4, 7], [[1, 0, "ST", 0.25, 1]], (),
                           tol=1e-4, device="cpu", cpfit=True, smooth=False,
                           unfolded=True, **kw)


@pytest.fixture(scope="module")
def uninterrupted():
    rng = np.random.default_rng(3)
    data = np.stack([MODEL * rng.uniform(0.99, 1.01, size=7) for _ in range(5)])
    res = _sweep(data, phase1_maxiter=10_000)
    assert len(set(res.nfev.ravel().tolist())) > 2  # the cells stop at different steps
    return data, res


@pytest.mark.parametrize("schedule", [dict(phase1_maxiter=3),
                                      dict(stage_caps=(2, 5, 9, 14))],
                         ids=["two_phase_bucket8", "four_stages"])
def test_staged_compaction_is_bitwise_uninterrupted(uninterrupted, schedule, capsys):
    """Staged straggler compaction (iteration caps, the unconverged cells
    resumed from their NMState in one narrower batch) reproduces the
    uninterrupted lockstep sweep bitwise."""
    data, r1 = uninterrupted
    r2 = _sweep(data, **schedule)
    assert "resumed to cap" in capsys.readouterr().err
    np.testing.assert_array_equal(r2.llh, r1.llh)
    np.testing.assert_array_equal(r2.params, r1.params)
    np.testing.assert_array_equal(r2.nfev, r1.nfev)
    np.testing.assert_array_equal(r2.converged, r1.converged)


def test_per_split_path_matches_fused(uninterrupted):
    """``fused=False`` (one build_likelihood per split) takes the fused
    sweep's steps (the first 6 iterations of each fit)."""
    data, _ = uninterrupted
    r0 = _sweep(data, fused=False, maxiter=6)
    r1 = _sweep(data, maxiter=6)
    np.testing.assert_allclose(r0.llh, r1.llh, rtol=1e-9)
    np.testing.assert_allclose(r0.params, r1.params, rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(r0.nfev, r1.nfev)
    np.testing.assert_array_equal(r0.converged, r1.converged)


def _scenario(seed):
    rng = np.random.default_rng(seed)
    times, lams = _toy()
    lams = [[a * (1.0 + 0.05 * seed), b] for a, b in lams]
    return dict(times=times, lambdas=lams, data=_data(rng, 2), splits=[4, 7],
                mi_template=[[1, 0, "ST", 0.25, 1]], cpfit=True, smooth=False,
                unfolded=True)


def test_sweep_many_equals_independent_sweeps():
    """Same-shape scenarios share one shape key and give what independent
    sweeps give (first 6 iterations of each fit)."""
    scs = [dict(name=n, **_scenario(k)) for k, n in ((1, "a"), (2, "b"))]
    res = bootstrap.sweep_many(scs, tol=1e-4, device="cpu", maxiter=6)
    assert res["a"].shape_key == res["b"].shape_key != ""
    assert not np.array_equal(res["a"].llh, res["b"].llh)
    for sc in scs:
        sc = dict(sc)
        name = sc.pop("name")
        one = bootstrap.sweep(sc.pop("times"), sc.pop("lambdas"), sc.pop("data"),
                              sc.pop("splits"), sc.pop("mi_template"), tol=1e-4,
                              device="cpu", maxiter=6, **sc)
        np.testing.assert_array_equal(res[name].llh, one.llh)
        np.testing.assert_array_equal(res[name].params, one.params)
        np.testing.assert_array_equal(res[name].nfev, one.nfev)


def test_bootstrap_data_and_ci_equal_jax():
    rng = np.random.default_rng(5)
    rows = [[float(rng.integers(50, 150))] + list(rng.integers(0, 40, 7).astype(float))
            for _ in range(30)]
    got = bootstrap.make_bootstrap_data(Jafs(jafs=rows), 12, seed=7)
    want = jax_bootstrap.make_bootstrap_data(JaxJafs(jafs=rows), 12, seed=7)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (13, 7)

    times, _ = _toy()
    llh = np.random.default_rng(6).normal(-100.0, 3.0, (4, 13))
    splits = np.array([4.0, 4.5, 6.0, 7.0])
    mk = lambda mod: mod.SweepResult(split_times=splits, params=np.zeros((4, 13, 1)),
                                     llh=llh, data=got)
    ci = bootstrap.split_time_confidence_interval(mk(bootstrap), times, 2.0e4)
    ci_j = jax_bootstrap.split_time_confidence_interval(mk(jax_bootstrap), times, 2.0e4)
    for key in ("best_split_idx", "split_gens", "mean", "ci", "level"):
        np.testing.assert_array_equal(np.asarray(ci[key]), np.asarray(ci_j[key]), err_msg=key)


def test_sweep_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    times, lams = _toy()
    with pytest.raises(RuntimeError, match="CUDA"):
        bootstrap.sweep(times, lams, BASE[None], [4], [[1, 0, "ST", 0.25, 1]])
    with pytest.raises(RuntimeError, match="CUDA"):
        build_fused_sweep(times, lams, [4], [[1, 0, "ST", 0.25, 1]])
