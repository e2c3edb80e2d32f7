"""The port's batched likelihood (misti_tpu_torch) against the reference
oracles and the JAX package, float64 on the CPU.

* all 13 ``likelihood.npz`` cases (made by running upstream MiSTI) with the
  tolerances of test_likelihood.py;
* the README oracle llh -5.6330938966336905;
* the JAX package's fused-xla likelihood (the same sweep algorithm the port
  runs) through ``llh_batch`` and ``llh_aux``;
* float32 ``torch.log`` accuracy, the reason the JAX package's
  ``log_accurate`` (a workaround for the TPU's coarse f32 log) is not ported.
"""

import numpy as np
import pytest
import torch

from misti_tpu.engine.likelihood import build_likelihood as jax_build_likelihood
from misti_tpu.engine.spec import build_spec as jax_build_spec
from misti_tpu_torch import build_likelihood, build_spec, params_from_jax
from misti_tpu_torch.config import LLH_DTYPE
from test_likelihood import CASES

README_LLH = -5.6330938966336905


def _spec_args(case):
    return (
        [list(case["times"]), [list(v) for v in case["lambdas"]], list(case["sfs8"]),
         case["splitT"], [list(v) for v in case["mi"]], [list(v) for v in case["pu"]]],
        dict(correct=not case["trueEPS"], cpfit=case["cpfit"], smooth=case["smooth"],
             unfolded=case["unfolded"], sample_date=case["sampleDate"],
             mixture_th=case["mixture_th"]),
    )


def _case(name):
    return next(c for c in CASES if c["name"] == name)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_llh_matches_reference(case):
    args, kw = _spec_args(case)
    lik = build_likelihood(build_spec(*args, **kw), device="cpu")
    llh, aux = lik.llh_aux(np.zeros(0))
    assert llh.dtype == torch.float64
    if not np.isfinite(case["llh"]):
        # reference bail-out (the -mth mixture threshold): the same eval fails
        assert not bool(aux["valid"]) and float(llh) == -np.inf
        return
    assert bool(aux["valid"]), f"valid=False but reference llh={case['llh']}"
    tol = 1e-12 if case["trueEPS"] else 2e-4
    np.testing.assert_allclose(aux["lc"].numpy(), case["lc"], rtol=tol, atol=tol)
    np.testing.assert_allclose(aux["jafs"].numpy(), case["jafs"], rtol=5e-6, atol=1e-9)
    np.testing.assert_allclose(float(llh), case["llh"], rtol=1e-7, atol=1e-3)


def test_readme_oracle():
    args, kw = _spec_args(_case("readme_trueEPS_unfolded"))
    llh = build_likelihood(build_spec(*args, **kw), device="cpu").llh(np.zeros(0))
    assert abs(float(llh) - README_LLH) <= 1e-12


def _band_spec_jax(case):
    return jax_build_spec(
        list(case["times"]), [list(v) for v in case["lambdas"]], list(case["sfs8"]),
        case["splitT"], [[1, 2, int(case["splitT"]), 0.3, 1]], [], unfolded=True, cpfit=True)


def test_llh_batch_matches_jax_fused():
    """cpfit with an optimised band: eight candidates through llh_batch."""
    spec_j = _band_spec_jax(_case("correct_cpfit1_mig1"))
    batch = np.linspace(0.05, 1.2, 8)[:, None]
    want = np.asarray(jax_build_likelihood(spec_j, correction_mode="fused-xla").llh_batch(batch))
    got = build_likelihood(params_from_jax(spec_j), device="cpu").llh_batch(batch)
    assert got.shape == (8,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_llh_aux_matches_jax_fused():
    """ECT without migration: llh, rates, states and spectrum via llh_aux."""
    args, kw = _spec_args(_case("correct_cpfit0_mig0"))
    spec_j = jax_build_spec(*args, **kw)
    llh_j, aux_j = jax_build_likelihood(spec_j, correction_mode="fused-xla").llh_aux(np.zeros(0))
    llh_t, aux_t = build_likelihood(params_from_jax(spec_j), device="cpu").llh_aux(np.zeros(0))
    np.testing.assert_allclose(float(llh_t), float(llh_j), rtol=1e-6)
    for key in ("lc", "pr", "jafs"):
        np.testing.assert_allclose(aux_t[key].numpy(), np.asarray(aux_j[key]), rtol=1e-6,
                                   atol=1e-12, err_msg=key)
    assert bool(aux_t["valid"]) == bool(aux_j["valid"])


def test_params_from_jax_copies_every_field():
    args, kw = _spec_args(_case("correct_pulse"))
    spec_j = jax_build_spec(*args, **kw)
    spec_t = params_from_jax(spec_j)
    ref = build_spec(*args, **kw)
    for f in ("numT", "splitT", "sample_date", "opt_mi", "opt_pu", "snps", "llh_const",
              "correct", "cpfit", "smooth", "unfolded", "mixture_th", "thrh"):
        assert getattr(spec_t, f) == getattr(ref, f), f
    for f in ("times", "lh", "mi_base", "pu_base", "mi_masks", "pu_masks", "data_jafs"):
        np.testing.assert_array_equal(getattr(spec_t, f), getattr(ref, f), err_msg=f)
    assert getattr(spec_t, "times") is not getattr(spec_j, "times")


def _band_lik():
    return build_likelihood(params_from_jax(_band_spec_jax(_case("correct_cpfit1_mig1"))),
                            device="cpu")


def test_batch_single_data_and_flags_agree():
    lik = _band_lik()
    batch = np.array([[0.3], [-0.5], [0.9]])
    out = lik.llh_batch(batch)
    assert np.isneginf(float(out[1])) and np.isfinite(float(out[0]))
    for i, p in enumerate(batch):
        np.testing.assert_allclose(float(lik.llh(p)), float(out[i]), rtol=1e-12)
    # the data spectrum as an argument reproduces the built-in constant
    data = np.repeat(lik.spec.data_jafs[None], 3, 0)
    np.testing.assert_allclose(lik.llh_data(batch, data).numpy(), out.numpy(), rtol=1e-12)
    np.testing.assert_allclose(float(lik.llh_data(batch[0], lik.spec.data_jafs)),
                               float(out[0]), rtol=1e-12)
    llh, flags = lik.llh_flags(batch[1])
    assert float(llh) == -np.inf and flags.tolist() == [0.0, 0.0]  # negative: not called
    llh, flags = lik.llh_flags(batch[0])
    assert flags.tolist() == [1.0, 0.0]


def test_float32_log_within_4_ulp():
    """torch.log in float32 against the float64 log, on the inputs and ulp
    measure of test_expm.py's log_accurate test: within 4 ulp."""
    x64 = np.concatenate([np.logspace(-6, 6, 4001), np.linspace(0.03, 0.3, 1000)])
    x = x64.astype(np.float32)
    got = torch.log(torch.from_numpy(x)).numpy().astype(np.float64)
    ref = np.log(x.astype(np.float64))
    err_ulp = np.abs(got - ref) / np.spacing(np.abs(ref).astype(np.float32))
    assert err_ulp.max() < 4.0, err_ulp.max()


def test_float32_cpu_run_tracks_float64():
    """A run's dtype rounds only its parameters: on parameters float32 holds
    exactly, the float32 run's llh is the float64 run's, bit for bit, and
    comes back in LLH_DTYPE."""
    lik32 = build_likelihood(_band_lik().spec, device="cpu", dtype=torch.float32)
    lik64 = _band_lik()
    batch = np.linspace(0.05, 1.2, 6, dtype=np.float32).astype(np.float64)[:, None]
    out32 = lik32.llh_batch(batch)
    assert out32.dtype == LLH_DTYPE
    assert torch.equal(out32, lik64.llh_batch(batch))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_optimised_pulse_lane_does_not_depend_on_its_batch(dtype):
    """correct_pulse with its pulse optimised: each lane's llh is bitwise the
    same alone, in sub-batches and in the whole batch (the per-lane pulse
    operator is applied as a product and a last-axis sum, as the card needs),
    and the float32 run is the float64 one bit for bit on parameters that
    float32 holds exactly."""
    args, kw = _spec_args(_case("correct_pulse"))
    args[5] = [[2, 4, 0.15, 1]]
    lik = build_likelihood(build_spec(*args, **kw), device="cpu", dtype=dtype)
    # finite llh up to ~0.75 here; float32 holds these rates exactly
    batch = np.linspace(0.0, 0.7, 37, dtype=np.float32).astype(np.float64)[:, None]
    full = lik.llh_batch(batch)
    assert full.dtype == LLH_DTYPE and bool(torch.isfinite(full).all())
    for sel in (slice(0, 1), slice(5, 11), slice(3, 37, 5), slice(0, 36)):
        assert torch.equal(lik.llh_batch(batch[sel]), full[sel])
    if dtype == torch.float32:
        lik64 = build_likelihood(build_spec(*args, **kw), device="cpu")
        assert torch.equal(full, lik64.llh_batch(batch))
