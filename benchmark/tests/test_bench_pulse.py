"""The pulse deployment (``hanfre_cpfit_pulse.sweep``) on the CPU: the
reference's pulse path against upstream's output, the judge on a cut run
(sound, the control, and the pulses left out in the port underneath), and
the two pulse metrics' readers."""

import os

import numpy as np
import pytest
import torch
from test_bench_judge import _judged, _small

from benchmark.harness import layout
from benchmark.reference.likelihood import build_llh
from benchmark.reference.readers import read_jafs_rows, read_psmc
from benchmark.reference.spec import build_spec

CELL = "hanfre_cpfit_pulse.sweep"
FIXDIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "fixtures")


def test_the_reference_gives_upstreams_pulse_fit_llh():
    """ref_fit_pu.mi: upstream MiSTI's ``synth1.psmc synth2.psmc synth.jsfs
    8 -uf -pu 2 4 0.2 1 -pu 1 6 0.1 0 --cpfit -bs 0``, its LK line; its
    optimised pulse fits to ~4e-16 (genome 2's one-in-each share after
    interval 4, 7.685e-16, is 2 r (1 - r) of its mass)."""
    times, lambdas, _ = read_psmc(os.path.join(FIXDIR, "synth1.psmc"),
                                  os.path.join(FIXDIR, "synth2.psmc"))
    data = read_jafs_rows(os.path.join(FIXDIR, "synth.jsfs"))[0][1:]
    spec = build_spec(times, lambdas, [0.0, *data], 8, [], [[2, 4, 0.2, 1], [1, 6, 0.1, 0]],
                      cpfit=True, smooth=True, unfolded=True)
    f64 = dict(dtype=torch.float64)
    llh = build_llh(spec)(torch.tensor([[7.68497124e-16 / 2 / 0.9757480]], **f64),
                          torch.tensor([data], **f64), torch.tensor([spec.llh_const], **f64))
    np.testing.assert_allclose(float(llh[0]), -1838.8666471937468, rtol=1e-9)


def test_a_sound_pulse_sweep_is_correct():
    ok, compared = _judged(_small(CELL), 1)
    assert ok, compared


def test_the_pulse_control_is_not_correct():
    ok, compared = _judged(_small(CELL, dtype=torch.float32), 1)
    assert not ok, compared


def test_a_pulse_sweep_without_its_pulses_is_not_correct(monkeypatch):
    """The fault: every pulse rate zeroed in the port's fused likelihood,
    in its correction and in its spectrum."""
    from misti_tpu_torch.engine import sweep_fused

    correction, spectrum = sweep_fused.fused_correction, sweep_fused.jafs_spectrum
    monkeypatch.setattr(sweep_fused, "fused_correction",
                        lambda mi, pu, *a, **kw: correction(mi, torch.zeros_like(pu), *a, **kw))
    monkeypatch.setattr(sweep_fused, "jafs_spectrum",
                        lambda b, lc, mi, pu, *a: spectrum(b, lc, mi, torch.zeros_like(pu), *a))
    ok, compared = _judged(_small(CELL), 1)
    assert not ok, compared
    assert compared["llh_gap"]["value"] > 1.0, compared


def _span(id_, name, parent=None, **attrs):
    return dict(id=id_, name=name, start=0, end=1, parent=parent, request=1, attrs=attrs)


def test_pulse_ops_reader_on_known_counters():
    records = [_span(2, "llh", 1, lanes=70), _span(3, "llh", 1, lanes=14),
               _span(1, "sweep")]
    records[-1]["counters"] = {"correction.pulse_rows": 84 * 27, "spectrum.pulse_ops": 84 * 2,
                               "nm.lanes_live": 5}
    got = layout.reader("pulse_ops_per_call.sweep")({"port_spans": dict(records=records)})
    assert got == {"value": pytest.approx(84 * 29 / 2), "calls": 2,
                   "correction.pulse_rows_per_call": pytest.approx(84 * 27 / 2),
                   "spectrum.pulse_ops_per_call": pytest.approx(84 * 2 / 2)}
    records[-1]["counters"] = {"nm.lanes_live": 5}  # a port without the pulse counters
    assert layout.reader("pulse_ops_per_call.sweep")(
        {"port_spans": dict(records=records)}) is None


def test_pulse_device_reader_replays_each_kernel_with_and_without_its_pulses(monkeypatch):
    """On the CPU with the kernel timing stubbed: the reader replays the
    correction with and without its pulse instance and the spectrum with
    and without its sites, and reads nothing from a port without
    ``FusedSweep.spectrum_input``."""
    from misti_tpu_torch.kernels import correction_fused, spectrum

    seen, replaying, orig_sweep = [], [], correction_fused.correction_sweep

    def correction_sweep(inp, **kw):  # the sweep's own calls run; the replays are noted
        if not replaying:
            return orig_sweep(inp, **kw)
        seen.append(("correction", kw["has_pulse"], bool(inp[5:7].any())))

    monkeypatch.setattr(correction_fused, "correction_sweep", correction_sweep)
    monkeypatch.setattr(spectrum, "spectrum_kernel", lambda basis, a: seen.append(
        ("spectrum", a.pulse_site is not None)))
    times = iter([1.0, 0.9, 4.0, 3.9])

    def kernel_ms(fn, reps, launches):
        replaying.append(1)
        fn()
        replaying.clear()
        return next(times), "stub"

    read = layout.reader("pulse_device_pct.sweep")
    monkeypatch.setitem(read.__globals__, "kernel_ms", kernel_ms)
    cell = _small(CELL)
    ctx = dict(driver=cell.driver, request=cell.requests.profile())
    got = read(ctx)
    assert seen == [("correction", True, True), ("correction", False, False),
                    ("spectrum", True), ("spectrum", False)]
    assert got["value"] == pytest.approx(100 * 0.2 / 5.0)
    assert got["pulse_sites"] == 2 and got["lanes"] == 2 * 2 * 3  # splits x rows x (n + 1)

    orig = cell.driver.first_call

    def first_call(spectra):  # the parent's FusedSweep, which has no such hook
        call = orig(spectra)
        call["fs"].spectrum_input = None
        return call

    monkeypatch.setattr(cell.driver, "first_call", first_call)
    assert read(ctx) is None
