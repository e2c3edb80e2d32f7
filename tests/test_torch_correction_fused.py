"""The port's fused correction sweep (misti_tpu_torch/kernels/correction_fused.py).

On the CPU: the plain version against the JAX package's CPU form of the TPU
kernel (cpfit variants and per-lane tables here; the expected-coalescence-time
variants in test_torch_correction_ect.py), the forward-mode residual Jacobians
against ``torch.func.jacfwd``, and the post-split fit against the reference
residual's root (and JAX).  The CUDA
kernel itself runs only on a card: those tests skip here.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from _torch_sweep_cases import B, S, assert_sweeps_agree, draw
from misti_tpu.kernels import correction as jkc
from misti_tpu_torch.kernels import correction as tkc
from misti_tpu_torch.kernels import correction_fused as cf

F64 = dict(dtype=torch.float64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sweep kernel has no CPU form")
    return torch.device("cuda")


@pytest.mark.parametrize("pulse", [False, True], ids=["mig", "pulse"])
def test_plain_sweep_matches_jax_cpfit(pulse):
    lh, times, mi, pu = draw(11, pulse=pulse)
    assert_sweeps_agree(lh, times, mi, pu, cpfit=True, has_pulse=pulse)


def test_plain_sweep_matches_jax_per_lane_tables_with_padding():
    """Per-lane tables (the grid sweep's form): zero-length trailing rows
    are no-ops -- lc pinned to 1, the state carried unchanged (up to the
    association order of the prefix product)."""
    lh, times, mi, pu = draw(12)
    rng = np.random.default_rng(13)
    lh_tab = lh[None] * rng.uniform(0.8, 1.25, (B, 1, 2))
    t_tab = np.repeat(times[None], B, 0)
    t_tab[1, -1] = 0.0
    t_tab[3, -2:] = 0.0
    lc = assert_sweeps_agree(lh_tab, t_tab, mi, pu, cpfit=True, has_pulse=False)
    assert lc[1, -1].tolist() == [1.0, 1.0] and lc[3, -2:].ravel().tolist() == [1.0] * 4
    t = lambda a: torch.tensor(a, **F64)
    _, pa = cf.fused_correction(t(mi), t(pu), t(lh_tab), t(t_tab), cpfit=True, has_pulse=False)
    np.testing.assert_allclose(pa[1, -1], pa[1, -2], rtol=1e-13)
    np.testing.assert_allclose(pa[3, -1], pa[3, -3], rtol=1e-13)


def _ctx(n, seed):
    """Residual context of one interval solve for n lanes."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, **F64)
    p = rng.uniform(0.05, 1.0, (6, n))
    pn = np.concatenate([p[:3] / p[:3].sum(0), p[3:] / p[3:].sum(0)])
    lh_s = rng.uniform(0.05, 0.6, (2, n))
    return SimpleNamespace(
        p=tuple(t(v) for v in p), pn=tuple(t(v) for v in pn),
        mu0s=t(rng.uniform(0.0, 0.4, n)), mu1s=t(rng.uniform(0.0, 0.4, n)),
        max_squarings=8, work=None,
        mass0=t(p[:3].sum(0)) * cf._em1m(t(lh_s[0])),
        mass1=t(p[3:].sum(0)) * cf._em1m(t(lh_s[1])),
        ect0=cf._ect_dev(t(lh_s[0])), ect1=cf._ect_dev(t(lh_s[1])),
        ect_raw0=cf._ect_dev(t(lh_s[0])), ect_raw1=cf._ect_dev(t(lh_s[1])))


@pytest.mark.parametrize("res", [cf._res_cp, cf._res_ect, cf._res_nomig],
                         ids=["cpfit", "ect", "nomig"])
def test_residual_tangents_match_jacfwd(res):
    """The LM's 2x2 Jacobian (one stacked forward-mode pass) against jacfwd.
    The rates straddle the series/direct switch points (0.5 and 1), and the
    larger ones need squarings."""
    n = 8
    ctx = _ctx(n, 5)
    a0 = torch.tensor([0.01, 0.2, 0.45, 0.55, 0.9, 1.2, 3.0, 6.0], **F64)
    a1 = torch.tensor([0.03, 0.1, 0.6, 0.4, 1.1, 0.8, 5.0, 2.0], **F64)
    r0, r1, j00, j10, j01, j11 = cf._lin_at(lambda x, y: res(x, y, ctx), a0, a1)
    want_r = res(a0, a1, ctx)
    jac = torch.func.jacfwd(lambda x, y: torch.stack(res(x, y, ctx)), argnums=(0, 1))(a0, a1)
    np.testing.assert_array_equal(torch.stack([r0, r1]).numpy(), torch.stack(want_r).numpy())
    got = torch.stack([j00, j10, j01, j11])
    want = torch.stack([jac[0][0].diagonal(), jac[0][1].diagonal(),
                        jac[1][0].diagonal(), jac[1][1].diagonal()])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-15)


def _ref_residual(lh, T, w):
    """Upstream's post-split residual (CorrectLambda.py:67-77 with the raw-rate
    tail guard at :68, FitSinglePop at MigrationInference.py:361-362), as
    tests/test_correction.py writes it: (f, x0, lower)."""
    wn = w / w.sum()

    def ect(lam):
        return 1.0 / lam - (0.0 if lam > 100.0 else T / np.expm1(lam * T))

    te = wn[0] * ect(lh[0]) + wn[1] * ect(lh[1])
    return (lambda lam: ect(lam) - te), float(wn @ lh), 0.01 * float(lh.min())


def _root_on_x0_branch(lh, T, w):
    """The residual's root on the branch (lam <= 100 or lam > 100) that holds
    the start x0, the other branch's when x0's has none: where upstream's
    least_squares from x0 stops.  Returns (root, f, every branch's root)."""
    from scipy import optimize as sopt

    f, x0, lower = _ref_residual(lh, T, w)
    roots = {}
    if lower < 100.0 and f(lower) >= 0 > f(100.0):
        roots["low"] = sopt.brentq(f, lower, 100.0, xtol=1e-14, rtol=1e-15)
    a = max(lower, np.nextafter(100.0, np.inf))
    if f(a) >= 0:
        b = max(2.0 * a, x0)
        while f(b) >= 0:
            b *= 2.0
        roots["up"] = sopt.brentq(f, a, b, xtol=1e-14, rtol=1e-15)
    take = "up" if "up" in roots and (x0 > 100.0 or "low" not in roots) else "low"
    return roots[take], f, roots


def _fit(lh, T, w, dtype=torch.float64):
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype)
    return tkc.fit_single_pop(t(lh), t(T), t(w)).double().numpy()


def test_fit_single_pop_matches_jax():
    """Toy post-split rates (all < 100): both packages reach the reference
    residual's root.  The JAX package's float64 fit carries the Bernoulli
    series' truncation up to x = lam T = 1 (~3e-9 relative here), which the
    port's float64 fit no longer does (kernels/correction.py `_ect_dev`):
    the port is held to the root at rtol 1e-10 (the brentq oracle's own
    cancellation is ~1e-12) and is 100x closer to it than the JAX package."""
    rng = np.random.default_rng(21)
    n = 40
    lh = rng.uniform(0.3, 5.0, (n, 2))
    T = rng.uniform(0.01, 0.5, n)
    w = rng.uniform(0.05, 1.0, (n, 2))
    got = _fit(lh, T, w)
    jax_fit = np.asarray(jax.jit(jax.vmap(jkc.fit_single_pop))(lh, T, w))
    want = np.array([_root_on_x0_branch(lh[i], T[i], w[i])[0] for i in range(n)])
    np.testing.assert_allclose(got, want, rtol=1e-10)
    np.testing.assert_allclose(jax_fit, want, rtol=1e-8)
    err = lambda a: np.max(np.abs(a - want) / want)
    assert err(got) * 100 < err(jax_fit)


# (lh, T, w, the root on x0's branch, the other branch's root): the fit lands
# on x0's side of the raw-rate guard's jump, as upstream's least_squares does
_TABLE = {
    "upper_only": ((149.6, 117.2), 0.00243, (0.116, 0.884), 120.2203, None),
    "two_roots_a": ((55.0, 55.9), 0.005, (0.5, 0.5), 55.45, 419.3528),
    "two_roots_b": ((55.0, 56.0), 0.0043, (0.3, 0.7), 55.7, 484.4357),
}
# vectorised draws: the JAX package's test distribution (rates straddling
# 100 on short intervals) and a regime where most lanes have two roots
_DRAWS = {"straddle": ((60.0, 300.0), (0.002, 0.1)), "two_roots": ((30.0, 100.0), (0.002, 0.02))}
_N_DRAWS = 600


@pytest.mark.parametrize("case", [*(f"table_{k}" for k in _TABLE),
                                  *(f"{k}_{d}" for k in _DRAWS for d in ("f64", "f32"))])
def test_fit_single_pop_takes_x0_branch(case):
    """The post-split fit against the reference residual's root on x0's
    branch (brentq per lane): float64 within rel 5e-9 with |f| <= 1e-11
    (tests/test_correction.py's limits), float32 on the same branch within
    rel 1e-4."""
    if case.startswith("table_"):
        lh, T, w, want_root, other = _TABLE[case[6:]]
        lh, T, w = np.array([lh]), np.array([T]), np.array([w])
        dtype = torch.float64
    else:
        name, dt = case.rsplit("_", 1)
        (lh_lo, lh_hi), (t_lo, t_hi) = _DRAWS[name]
        rng = np.random.default_rng(5)
        lh = rng.uniform(lh_lo, lh_hi, (_N_DRAWS, 2))
        T = rng.uniform(t_lo, t_hi, _N_DRAWS)
        w = rng.uniform(0.1, 1.0, (_N_DRAWS, 2))
        dtype = torch.float64 if dt == "f64" else torch.float32
    got = _fit(lh, T, w, dtype)
    refs = [_root_on_x0_branch(lh[i], T[i], w[i]) for i in range(len(T))]
    want = np.array([r[0] for r in refs])
    if dtype == torch.float64:
        np.testing.assert_allclose(got, want, rtol=5e-9)
        assert max(abs(r[1](g)) for r, g in zip(refs, got)) <= 1e-11
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4)
    if case.startswith("table_"):
        np.testing.assert_allclose(got[0], want_root, rtol=2e-6)
        if other is not None:
            np.testing.assert_allclose(refs[0][2]["up"], other, rtol=2e-7)
    else:
        # both regimes reach both branches' cases
        n_two = sum(len(r[2]) == 2 for r in refs)
        assert n_two >= (0.9 * _N_DRAWS if name == "two_roots" else 10)


@pytest.mark.parametrize("regime", sorted(_DRAWS))
def test_fit_single_pop_bisection_reaches_the_last_ulp(regime):
    """float64: 60 halvings reach the last ulp.  On the lam > 100 branch
    (brackets up to 100 * 2^40 wide) each lane ends within one ulp of its
    residual's sign change, g(prev) >= 0 >= g(next); below 100 the
    residual's own rounding (~1e-16) is not monotone over a few ulps, so
    there every lane's |g| is at that level."""
    (lh_lo, lh_hi), (t_lo, t_hi) = _DRAWS[regime]
    rng = np.random.default_rng(6)
    lh = torch.tensor(rng.uniform(lh_lo, lh_hi, (_N_DRAWS, 2)), **F64)
    T = torch.tensor(rng.uniform(t_lo, t_hi, _N_DRAWS), **F64)
    w = torch.tensor(rng.uniform(0.1, 1.0, (_N_DRAWS, 2)), **F64)
    got = tkc.fit_single_pop(lh, T, w)
    wn = w / w.sum(-1, keepdim=True)
    dev = lambda lam, up: torch.where(up, 1.0 / (lam * T) - 0.5,  # noqa: E731
                                      tkc._ect_dev(lam * T))
    te = wn[:, 0] * dev(lh[:, 0], lh[:, 0] > 100) + wn[:, 1] * dev(lh[:, 1], lh[:, 1] > 100)
    up = got > 100
    g = lambda lam: dev(lam, up) - te  # noqa: E731
    prev = torch.nextafter(got, torch.zeros_like(got))
    nxt = torch.nextafter(got, torch.full_like(got, float("inf")))
    assert bool(((g(prev) >= 0) & (g(nxt) <= 0))[up].all())
    assert float(g(got).abs().max()) <= 1e-15
    assert int(up.sum()) > (_N_DRAWS // 2 if regime == "straddle" else -1)


def _sweep_input(seed, device="cpu"):
    lh, times, mi, pu = draw(seed, pulse=True)
    t = lambda a: torch.tensor(a, dtype=torch.float64, device=device)
    return cf.sweep_inputs(t(mi), t(pu), t(lh), t(times))


def test_cpu_tensor_takes_the_plain_version():
    inp = _sweep_input(31)
    before = cf.correction_sweep.launches
    out = cf.correction_sweep(inp, cpfit=True)
    assert cf.correction_sweep.launches == before
    assert out.shape == (8, S, B)
    assert torch.equal(out, cf.correction_sweep_plain(inp, cpfit=True))


def test_sweep_work_counts_converged_lanes_only():
    inp = _sweep_input(32)
    opts = dict(cpfit=True, has_pulse=True)
    work = cf.sweep_work(inp, **opts)
    assert work["chain"] == 3 * S * B  # two rounds and the final chain
    full = 2 * S * B + (8 + 2) * S * B  # every lane running its whole budget
    assert 0 < work["cp"] <= full
    assert cf.sweep_ops(work, S, B, **opts) > 0


def test_kernel_matches_plain_on_card(cuda):
    inp = _sweep_input(41, cuda)
    for cpfit in (True, False):
        before = cf.correction_sweep.launches
        got = cf.correction_sweep(inp, cpfit=cpfit)
        torch.cuda.synchronize()
        assert cf.correction_sweep.launches == before + 1
        want = cf.correction_sweep_plain(inp, cpfit=cpfit)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-9, equal_nan=True)


def test_kernel_rejects_what_it_does_not_take(cuda):
    inp = _sweep_input(42, cuda)
    with pytest.raises(ValueError):
        cf.correction_sweep(inp.transpose(1, 2), cpfit=True)  # not contiguous
    with pytest.raises(TypeError):
        cf.correction_sweep(inp.half(), cpfit=True)
    before = cf.correction_sweep.launches
    with pytest.raises(TypeError):  # built in float64 only
        cf.correction_sweep(inp.float(), cpfit=True)
    assert cf.correction_sweep.launches == before
    with pytest.raises(ValueError):
        cf.correction_sweep(inp[:6].contiguous(), cpfit=True)
    with pytest.raises(ValueError):
        cf.correction_sweep(torch.ones(7, cf.MAX_INTERVALS + 1, 2, dtype=torch.float64,
                                       device=cuda), cpfit=True)


# the kernel's ten variants: {cpfit, ECT} x {migration, static_no_mig} x
# {no pulse, pulse}, plus per-lane tables with T == 0 padding rows
VARIANTS = [
    dict(cpfit=cp, static_no_mig=snm, has_pulse=pulse, per_lane=False)
    for cp in (True, False) for snm in (False, True) for pulse in (False, True)
] + [dict(cpfit=cp, static_no_mig=False, has_pulse=True, per_lane=True) for cp in (True, False)]


def _variant_id(v):
    return (f"{'cpfit' if v['cpfit'] else 'ect'}-{'snm' if v['static_no_mig'] else 'mig'}"
            f"-{'pulse' if v['has_pulse'] else 'nopulse'}{'-perlane' if v['per_lane'] else ''}")


def _variant_input(v, device, s=12, b=64):
    """A seeded (7, s, b) sweep input for one variant; one lane in eight
    without migration, so both branches of a mixed warp run."""
    rng = np.random.default_rng(51)
    lh = rng.uniform(0.5, 2.0, (s, 2))
    times = rng.uniform(0.05, 0.3, s)
    mi = np.zeros((b, s, 2)) if v["static_no_mig"] else rng.uniform(0.0, 0.5, (b, s, 2))
    mi[::8] = 0.0
    pu = np.zeros((b, s, 2))
    if v["has_pulse"]:
        pu[:, 2, 1] = rng.uniform(0.0, 0.3, b)
        pu[:, 7, 0] = rng.uniform(0.0, 0.2, b)
    if v["per_lane"]:
        lh = lh[None] * rng.uniform(0.8, 1.25, (b, 1, 2))
        times = np.repeat(times[None], b, 0)
        for lane in range(b):
            if lane % 5:
                times[lane, s - lane % 5:] = 0.0
    t = lambda a: torch.tensor(a, dtype=torch.float64, device=device)
    return cf.sweep_inputs(t(mi), t(pu), t(lh), t(times))


@pytest.mark.parametrize("variant", VARIANTS, ids=_variant_id)
def test_every_kernel_variant_matches_plain_on_card(cuda, variant):
    """Built with FMA contraction, the kernel matches its plain version to
    rtol 1e-6 / atol 1e-9 (the tolerances chip_smoke.py holds it to), with
    equal NaN masks."""
    inp = _variant_input(variant, cuda)
    opts = {k: variant[k] for k in ("cpfit", "static_no_mig", "has_pulse")}
    got = cf.correction_sweep(inp, **opts)
    torch.cuda.synchronize()
    want = cf.correction_sweep_plain(inp, **opts)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-9, equal_nan=True)
