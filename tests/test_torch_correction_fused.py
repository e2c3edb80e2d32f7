"""The port's fused correction sweep (misti_tpu_torch/kernels/correction_fused.py).

On the CPU: the plain version against the JAX package's CPU form of the TPU
kernel (cpfit variants and per-lane tables here; the expected-coalescence-time
variants in test_torch_correction_ect.py), the forward-mode residual Jacobians
against ``torch.func.jacfwd``, and the post-split fit against JAX.  The CUDA
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


def test_fit_single_pop_matches_jax():
    rng = np.random.default_rng(21)
    n = 40
    lh = rng.uniform(0.3, 5.0, (n, 2))
    T = rng.uniform(0.01, 0.5, n)
    w = rng.uniform(0.05, 1.0, (n, 2))
    got = tkc.fit_single_pop(torch.tensor(lh, **F64), torch.tensor(T, **F64),
                             torch.tensor(w, **F64)).numpy()
    want = np.asarray(jax.jit(jax.vmap(jkc.fit_single_pop))(lh, T, w))
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_fit_single_pop_keeps_the_raw_rate_guard():
    """Ported as it is: on the lam > 100 branch the bracket search lands
    where the JAX package's does (1.17 here, not the root near 120)."""
    lh = np.array([[149.6, 117.2]])
    T = np.array([0.00243])
    w = np.array([[0.116, 0.884]])
    got = tkc.fit_single_pop(torch.tensor(lh, **F64), torch.tensor(T, **F64),
                             torch.tensor(w, **F64)).numpy()
    want = np.asarray(jax.vmap(jkc.fit_single_pop)(lh, T, w))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert got[0] < 2.0


def _sweep_input(seed, dtype=torch.float64, device="cpu"):
    lh, times, mi, pu = draw(seed, pulse=True)
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
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


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_kernel_matches_plain_on_card(cuda, dtype):
    inp = _sweep_input(41, dtype, cuda)
    for cpfit in (True, False):
        before = cf.correction_sweep.launches
        got = cf.correction_sweep(inp, cpfit=cpfit)
        torch.cuda.synchronize()
        assert cf.correction_sweep.launches == before + 1
        want = cf.correction_sweep_plain(inp, cpfit=cpfit)
        rtol, atol = (1e-6, 1e-9) if dtype == torch.float64 else (1e-4, 1e-6)
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol, equal_nan=True)


def test_kernel_rejects_what_it_does_not_take(cuda):
    inp = _sweep_input(42, torch.float64, cuda)
    with pytest.raises(ValueError):
        cf.correction_sweep(inp.transpose(1, 2), cpfit=True)  # not contiguous
    with pytest.raises(TypeError):
        cf.correction_sweep(inp.half(), cpfit=True)
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


def _variant_input(v, dtype, device, s=12, b=64):
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
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    return cf.sweep_inputs(t(mi), t(pu), t(lh), t(times))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("variant", VARIANTS, ids=_variant_id)
def test_every_kernel_variant_matches_plain_on_card(cuda, variant, dtype):
    """Built with FMA contraction, the kernel matches its plain version to
    rtol 1e-4 / atol 1e-6 in float32 and 1e-6 / 1e-9 in float64 (the
    tolerances chip_smoke.py holds it to), with equal NaN masks."""
    inp = _variant_input(variant, dtype, cuda)
    opts = {k: variant[k] for k in ("cpfit", "static_no_mig", "has_pulse")}
    got = cf.correction_sweep(inp, **opts)
    torch.cuda.synchronize()
    want = cf.correction_sweep_plain(inp, **opts)
    rtol, atol = (1e-6, 1e-9) if dtype == torch.float64 else (1e-4, 1e-6)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol, equal_nan=True)


def test_no_float32_instance_spills(cuda):
    """misti_correction_sweep_attrs: every float32 template instance runs
    without local memory and fits at least one block per SM at s = 28."""
    for cpfit in (True, False):
        for a in cf.kernel_attrs(torch.float32, cpfit, 28):
            assert a["local_bytes"] == 0, a
            assert a["registers"] > 0 and a["blocks_per_sm"] >= 1, a
