"""The metric arithmetic: rates over all the window's work and time,
percentiles over all its requests, per-layer readers on known records."""

import statistics

import numpy as np
import pytest

from benchmark.harness import layout
from benchmark.harness.cell import Cell
from benchmark.harness.profiling import Trace, idle_pct


def _cell(kind, records, window_s):
    c = Cell.__new__(Cell)
    c.mix, c.records, c.window_s = {"kind": kind}, records, window_s
    return c


def test_a_rate_is_all_work_over_the_whole_window():
    recs = [dict(cells=808, t0=0.0, t1=0.4), dict(cells=808, t0=0.4, t1=1.4),
            dict(cells=808, t0=1.4, t1=1.5)]
    # the window runs 2.0 s: the time between requests counts too
    got = _cell("sweep", recs, 2.0).end_to_end()["sweep_cells_per_s"]
    assert got == 3 * 808 / 2.0
    assert got != statistics.mean(r["cells"] / (r["t1"] - r["t0"]) for r in recs)


def test_the_tail_is_over_all_fits_not_a_median_of_chunks():
    rng = np.random.default_rng(0)
    ms = list(rng.lognormal(5.4, 0.3, size=150)) + [900.0] * 20
    recs = [dict(t0=0.0, t1=v / 1e3) for v in ms]
    got = _cell("fit", recs, 30.0).end_to_end()
    assert got["fit_ms_p90"] == pytest.approx(float(np.percentile(ms, 90)), rel=1e-12)
    chunks = [ms[i:i + 10] for i in range(0, len(ms), 10)]
    assert got["fit_ms_p90"] != pytest.approx(
        statistics.median(float(np.percentile(c, 90)) for c in chunks), rel=1e-3)


def test_readers_on_known_records():
    sweeps = [dict(name="sweep", t0=0.0, t1=0.5, calls=40, cells=808),
              dict(name="sweep", t0=0.5, t1=1.1, calls=50, cells=808)]
    fits = [dict(name="fit", t0=0.0, t1=0.3, solve_s=0.25, nit=30),
            dict(name="fit", t0=0.3, t1=0.5, solve_s=0.15, nit=20)]
    ctx_s = dict(records=sweeps, profiled=dict(calls=45), trace=_trace(launches=9000))
    ctx_f = dict(records=fits, profiled=dict(nit=25), trace=_trace(launches=5000))
    assert layout.reader("calls_per_sweep")(ctx_s) == 45
    assert layout.reader("iter_ms.sweep")(ctx_s) == pytest.approx(1e3 * 1.1 / 90)
    assert layout.reader("launches_per_call.sweep")(ctx_s) == 200
    assert layout.reader("iter_ms.fit")(ctx_f) == pytest.approx(1e3 * 0.4 / 50)
    assert layout.reader("nm_iters_per_fit")(ctx_f) == 25
    assert layout.reader("launches_per_call.fit")(ctx_f) == 200
    assert layout.reader("calls_per_sweep")(dict(records=[])) is None


class _Event:
    def __init__(self, name, start, dur, cuda):
        self._n, self._s, self._d, self._c = name, start, dur, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._c else DeviceType.CPU


def _trace(launches=0, kernels=(), host=(), wall_s=1.0):
    ev = [_Event("cudaLaunchKernel", 10 * i, 1, False) for i in range(launches)]
    ev += [_Event(n, s, d, True) for n, s, d in kernels]
    ev += [_Event(n, s, d, False) for n, s, d in host]
    return Trace(ev, wall_s)


def test_trace_busy_idle_and_gaps():
    # two overlapping kernels and one apart: busy 300 + 100 ns; the profiled
    # wall 2000 ns, the same request's unprofiled wall 1000 ns
    tr = _trace(launches=3, kernels=[("k1", 100, 200), ("k2", 250, 150), ("k1", 700, 100)],
                host=[("aten::mul", 0, 50), ("aten::add", 450, 200)], wall_s=2e-6)
    assert tr.complete and tr.busy_s() == pytest.approx(400e-9)
    got = idle_pct(tr, 1e-6)
    assert got["value"] == pytest.approx(60.0) and got["source"] == "profiler"
    assert got["wall_s"] == 1e-6 and got["profiled_wall_s"] == 2e-6
    assert tr.device_ops()[0] == ["k1", pytest.approx(300e-9)]
    gaps = dict(tr.idle_gaps())
    assert gaps["aten::add"] == pytest.approx(300e-9)  # 400..700, the add at its middle
    assert gaps["aten::mul"] == pytest.approx(100e-9)  # 0..100


def test_the_idle_share_is_over_the_unprofiled_wall():
    tr = _trace(launches=1, kernels=[("k", 0, 250)], wall_s=2e-6)
    ctx = dict(trace=tr, plain=dict(t0=5.0, t1=5.0 + 1e-6))
    for kind in ("sweep", "fit"):
        assert layout.reader(f"device_idle_pct.{kind}")(ctx)["value"] == pytest.approx(75.0)


def test_an_incomplete_trace_reads_nothing():
    tr = _trace(launches=4, kernels=[("k", 0, 100), ("k", 200, 100)], wall_s=1e-6)
    assert idle_pct(tr, 1e-6) is None
    assert layout.reader("device_idle_pct.sweep")(dict(trace=tr, plain=dict(t0=0, t1=1))) is None
