"""The judge on the CPU at a size a test run holds: a run of the harness
with the card's look skipped, once sound, once with the program's own
lower precision (the control), and once per fault the cells can have,
planted in the port underneath.  Sound runs judge correct; every other run
judges not correct."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.harness import layout
from benchmark.harness.cell import Cell


def _small(name, *, cpfit_fit=False, seed=2**31 + 11, dtype=None):
    """A cell cut to two split times and one resample (so the judge's
    sample holds every answer), on the CPU."""
    bench = layout.benchmark()
    entry = layout.cell(bench, name)
    c = Cell.__new__(Cell)
    c.bench, c.name, c.seed, c.seconds = bench, name, seed, 0.0
    c.config = layout.config(bench, entry["config"])
    c.mix = dict(layout.traffic(entry["traffic"]), replicates=1)
    c.config["splits"] = [23, 24]
    if c.mix["kind"] == "sweep":
        c.mix["maxiter"] = 12
    if cpfit_fit:  # the fit cell's path with the cheaper residual on the CPU
        c.config.update(cpfit=True, nosmooth=True)
    c.limits = layout.limits(name)
    from benchmark.harness import drivers
    from benchmark.harness.traffic import Requests
    from benchmark.reference.readers import read_jafs_rows

    rows = np.asarray(read_jafs_rows(c.config["paths"]["jsfs"]), float)
    c.requests = Requests(c.mix, c.config, rows, seed)
    dt = torch.float64 if dtype is None else dtype
    if c.mix["kind"] == "sweep":
        c.driver = drivers.Sweep(c.config, c.mix, "cpu", dt)
    else:
        c.driver = drivers.Fit(c.config, c.mix, "cpu", dt, c.requests.spectra)
    c.records, c.window_s, c.done = [], None, None
    return c


def _judged(cell, requests):
    torch.set_num_threads(1)
    cell.run_window(requests=requests)
    cell.free()
    ok, compared, _ = cell.judge(workers=0)
    return ok, compared


@pytest.fixture
def port():
    from misti_tpu_torch.engine import bootstrap, likelihood, optimize

    return bootstrap, likelihood, optimize


def test_a_sound_sweep_is_correct():
    ok, compared = _judged(_small("pair3_2band_cpfit.sweep"), 1)
    assert ok, compared


def _altered_sweep(orig):
    def sweep(*a, **kw):
        res = orig(*a, **kw)
        res.params[-1, -1] += 1e-3  # one answer altered, by ten times the fit's tolerance
        return res
    return sweep


def _half_sweep(orig):
    def sweep(times, lambdas, data, *a, **kw):
        half = orig(times, lambdas, data[: (data.shape[0] + 1) // 2], *a, **kw)
        fill = lambda x: np.concatenate([x, x[:, : data.shape[0] - x.shape[1]]], axis=1)  # noqa
        return dataclasses.replace(half, params=fill(half.params), llh=fill(half.llh),
                                   nfev=fill(half.nfev), converged=fill(half.converged),
                                   data=data)
    return sweep


def _frozen_steps(orig):
    def nelder_mead(fun, x0, *a, **kw):
        kw["maxiter"] = 0  # every step returns the state unchanged
        return orig(fun, x0, *a, **kw)
    return nelder_mead


@pytest.mark.parametrize("fault", ["altered answer", "half the batch", "steps unchanged"])
def test_a_faulty_sweep_is_not_correct(port, monkeypatch, fault):
    bootstrap, _, _ = port
    if fault == "altered answer":
        monkeypatch.setattr(bootstrap, "sweep", _altered_sweep(bootstrap.sweep))
    elif fault == "half the batch":
        monkeypatch.setattr(bootstrap, "sweep", _half_sweep(bootstrap.sweep))
    else:
        monkeypatch.setattr(bootstrap, "nelder_mead", _frozen_steps(bootstrap.nelder_mead))
    ok, compared = _judged(_small("pair3_2band_cpfit.sweep"), 1)
    assert not ok, compared


def test_a_sound_fit_is_correct():
    ok, compared = _judged(_small("hanfre_ect.fit", cpfit_fit=True), 2)
    assert ok, compared


@pytest.mark.parametrize("fault", ["altered answer", "half the batch", "steps unchanged"])
def test_a_faulty_fit_is_not_correct(port, monkeypatch, fault):
    _, likelihood, optimize = port
    if fault == "altered answer":
        orig = optimize.solve

        def solve(*a, **kw):
            sol = orig(*a, **kw)
            sol.x = sol.x + 1e-3  # ten times the fit's tolerance
            return sol
        monkeypatch.setattr(optimize, "solve", solve)
    elif fault == "half the batch":
        orig = likelihood.build_likelihood

        def build_likelihood(*a, **kw):
            lik = orig(*a, **kw)
            full = lik.llh_flags_batch

            def half(params):
                k = (params.shape[0] + 1) // 2
                llh, flags = full(params[:k])
                pad = lambda x: torch.cat([x, x[:1].expand(params.shape[0] - k, *x.shape[1:])])  # noqa
                return pad(llh), pad(flags)
            return dataclasses.replace(lik, llh_flags_batch=half)
        monkeypatch.setattr(likelihood, "build_likelihood", build_likelihood)
    else:
        monkeypatch.setattr(optimize, "nelder_mead", _frozen_steps(optimize.nelder_mead))
    ok, compared = _judged(_small("hanfre_ect.fit", cpfit_fit=True), 2)
    assert not ok, compared


def test_the_control_is_not_correct():
    ok, compared = _judged(_small("pair3_2band_cpfit.sweep", dtype=torch.float32), 1)
    assert not ok, compared
