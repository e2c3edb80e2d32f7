"""Pulse migration through the port's bootstrap x split sweep, held to the
benchmark's plain reference (benchmark/reference/, float64 torch that
imports nothing of the port), on the benchmark's pulse deployment
``hanfre_cpfit_pulse``: one optimised band, an optimised pulse from
population 2 at interval 12 and a fixed one from population 1 at interval
18, cpfit with smoothing.

* The sweep, cut to 2 split times and 1 resample (row 0 and one bootstrap
  row) at 12 Nelder-Mead iterations, against the reference's own fits of
  the same cells, to the judge's limits (benchmark/limits/).
* With recording on, the sweep's pulse counters: ``correction.pulse_rows``
  is lanes x pre-split rows, ``spectrum.pulse_ops`` lanes x pulse sites.
* A pulse rate stepped past 1 or below 0 gives the reference's answer.
* The reference's pulse path against upstream's own output: its likelihood
  at the parameters of ``tests/fixtures/ref_fit_pu.mi`` (upstream MiSTI's
  pulse fit) gives that file's LK.

The card's form of the out-of-range check runs where there is a card
(``python -m pytest --noconftest tests/test_torch_sweep_pulse.py``).
"""

import json
import os

import numpy as np
import pytest
import torch

from benchmark.harness.traffic import bootstrap_set
from benchmark.reference.fit import flags, run_job, templates
from benchmark.reference.likelihood import build_llh, multinomial_const
from benchmark.reference.readers import read_jafs_rows, read_psmc
from benchmark.reference.spec import build_spec
from misti_tpu_torch import spans
from misti_tpu_torch.engine.bootstrap import sweep
from misti_tpu_torch.engine.sweep_fused import build_fused_sweep
from misti_tpu_torch.io import mi_format
from misti_tpu_torch.io import psmc as io_psmc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
FIXDIR = os.path.join(ROOT, "tests", "fixtures")
DATA = os.path.join(BENCH, "data", "hanfre_cpfit_pulse")
SPLITS = [23.0, 24.0]  # s_max = 24 pre-split rows
MAXITER, TOL = 12, 1e-4

with open(os.path.join(BENCH, "configs", "hanfre_cpfit_pulse.json")) as _f:
    CONFIG = json.load(_f)
CONFIG["paths"] = {k: os.path.join(DATA, v) for k, v in CONFIG["inputs"].items()}
with open(os.path.join(BENCH, "limits", "hanfre_cpfit_pulse.sweep.json")) as _f:
    LIMITS = json.load(_f)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spectra():
    """Row 0 (the summed spectrum) and one bootstrap resample."""
    rows = np.asarray(read_jafs_rows(CONFIG["paths"]["jsfs"]), float)
    return bootstrap_set(rows, 1, np.random.default_rng(2**31 + 5))


def _psmc():
    return io_psmc.read_psmc(CONFIG["paths"]["psmc1"], CONFIG["paths"]["psmc2"])


@pytest.fixture(scope="module")
def recorded_sweep():
    """(the port's sweep of the cut cell on the CPU, its span records)."""
    inp, data = _psmc(), _spectra()
    with spans.recording() as records:
        res = sweep(inp.times, inp.lambdas, data, SPLITS, CONFIG["mi"], CONFIG["pu"], tol=TOL,
                    device="cpu", maxiter=MAXITER, **flags(CONFIG))
    return res, records


@pytest.mark.parametrize("si", range(len(SPLITS)))
def test_sweep_matches_the_reference_fits(recorded_sweep, si):
    res, _ = recorded_sweep
    ref = run_job(dict(config=CONFIG, psmc=(CONFIG["paths"]["psmc1"], CONFIG["paths"]["psmc2"]),
                       split=SPLITS[si], data=res.data, x_at=res.params[si], const="multinomial",
                       tol=TOL, maxiter=MAXITER))
    assert np.isfinite(res.llh[si]).all()
    assert np.abs(res.params[si, :, 1]).min() > 0  # the optimised pulse is fitted, not left at 0
    assert np.abs(res.llh[si] - ref["llh"]).max() <= LIMITS["llh_gap"]
    assert np.abs(ref["llh_at"] - ref["llh"]).max() <= LIMITS["x_llh_gap"]


def test_pulse_counters_count_lanes_by_rows_and_sites(recorded_sweep):
    _, records = recorded_sweep
    calls = [r for r in records if r["name"] == "llh"]
    lanes = sum(c["attrs"]["lanes"] for c in calls)
    (root,) = [r for r in records if r["name"] == "sweep"]
    assert lanes > 0 and root["counters"]["correction.pulse_rows"] == lanes * 24
    assert root["counters"]["spectrum.pulse_ops"] == lanes * 2
    assert all(r["attrs"]["pulse"] is True for r in records if r["name"] == "llh.correct")
    assert {r["attrs"]["pulse_sites"] for r in records if r["name"] == "llh.spectrum"} == {2}


def _out_of_range(device):
    """(the port's fused llh, the reference's) at pulse rates past 1 and
    below 0, beside in-range ones, at the cut cell's later split."""
    inp, data = _psmc(), _spectra()[0]
    fs = build_fused_sweep(inp.times, inp.lambdas, SPLITS, CONFIG["mi"], CONFIG["pu"],
                           device=device, **flags(CONFIG))
    rates = [0.1, 1.0 - 1e-9, 1.0, 1.2, 2.0, -1e-9, -0.1, float("inf")]
    params = torch.tensor([[0.5, r] for r in rates], dtype=torch.float64)
    d = torch.as_tensor(data, dtype=torch.float64).expand(len(rates), 7)
    times, lambdas, _ = read_psmc(CONFIG["paths"]["psmc1"], CONFIG["paths"]["psmc2"])
    si, st = 1, SPLITS[1]
    got = fs.llh(torch.full((len(rates),), si), params.to(device), d.to(device)).cpu()
    spec = build_spec(times, lambdas, [0.0, *data], st, *templates(CONFIG, st), **flags(CONFIG))
    return got, build_llh(spec)(params, d, multinomial_const(d, CONFIG["unfolded"]))


def _assert_same_answer(got, want):
    assert torch.equal(torch.isneginf(got), torch.isneginf(want)), (got, want)
    assert torch.isfinite(want[0]) and torch.isneginf(want[3:]).all()
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=0, atol=LIMITS["llh_gap"])


def test_pulse_rates_out_of_range_give_the_references_answer():
    _assert_same_answer(*_out_of_range("cpu"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused sweep's kernels have no CPU form")
    return torch.device("cuda")


def test_pulse_rates_out_of_range_give_the_references_answer_on_card(cuda):
    _assert_same_answer(*_out_of_range(cuda))


def test_the_reference_gives_upstreams_pulse_fit_llh():
    """ref_fit_pu.mi is upstream MiSTI's output of ``synth1.psmc synth2.psmc
    synth.jsfs 8 -uf -pu 2 4 0.2 1 -pu 1 6 0.1 0 --cpfit -bs 0``
    (tests/fixtures/generate_cli_fixtures.py).  The file holds no parameter
    vector; its probabilities do: after interval 4, genome 2's share with
    one lineage in each population is 2 r (1 - r) of its mass, which puts
    the optimised rate r at ~4e-16.  Tolerance: the port's own pulse fit
    is held to rtol 2e-6 (tests/test_torch_misti_cli.py); this is tighter."""
    mi = mi_format.read_migration(os.path.join(FIXDIR, "ref_fit_pu.mi"))
    one, both = np.asarray(mi.pr12)[1, 5], np.asarray(mi.pr22)[1, 5]
    rate = one / (2 * (one + both))
    assert 0 < rate < 1e-15
    times, lambdas, _ = read_psmc(*(os.path.join(FIXDIR, f) for f in ("synth1.psmc",
                                                                       "synth2.psmc")))
    data = read_jafs_rows(os.path.join(FIXDIR, "synth.jsfs"))[0][1:]  # -bs 0: the first row
    spec = build_spec(times, lambdas, [0.0, *data], 8, [], [[2, 4, 0.2, 1], [1, 6, 0.1, 0]],
                      cpfit=True, smooth=True, unfolded=True)
    llh = build_llh(spec)(torch.tensor([[rate]], dtype=torch.float64),
                          torch.tensor([data], dtype=torch.float64),
                          torch.tensor([spec.llh_const], dtype=torch.float64))
    np.testing.assert_allclose(float(llh[0]), mi.llh, rtol=1e-9)
