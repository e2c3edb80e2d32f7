"""The readers of the port's spans (benchmark/harness/spans.py and its
metrics) on synthetic records and a synthetic profiler trace."""

import sys

import pytest

from benchmark.harness import layout
from benchmark.harness import spans as hs


def _span(id_, name, start, end, parent=None, **attrs):
    return dict(id=id_, name=name, start=start, end=end, parent=parent, request=1,
                attrs=attrs)


def _sweep_records():
    """A sweep of two stages: its tables, stage 1's start and two
    iterations, stage 2's one iteration (times in ns)."""
    r = [_span(1, "sweep", 0, 1000, splits=2, replicates=4, cells=8),
         _span(2, "sweep.tables", 0, 100, 1), _span(3, "spec.build", 10, 50, 2),
         _span(4, "sweep.stage", 100, 600, 1, stage=1, cells=8, lanes=48, cap=2, calls=3,
               unconverged=2),
         _span(5, "llh", 110, 200, 4, lanes=24, hand_launches=4),
         _span(6, "nm.iter", 200, 400, 4), _span(7, "llh", 210, 330, 6, lanes=48,
                                                 hand_launches=4),
         _span(8, "nm.live_read", 350, 390, 6),
         _span(9, "nm.iter", 400, 590, 4), _span(10, "llh", 405, 500, 9, lanes=48,
                                                 hand_launches=4),
         _span(11, "nm.live_read", 520, 580, 9),
         _span(12, "sweep.stage", 600, 990, 1, stage=2, cells=2, lanes=12, cap=4, calls=1,
               unconverged=0),
         _span(13, "nm.iter", 610, 980, 12), _span(14, "llh", 620, 900, 13, lanes=12,
                                                   hand_launches=6),
         _span(15, "llh.correct", 630, 700, 14), _span(16, "nm.live_read", 910, 970, 13)]
    r[0]["counters"] = {"nm.lanes_evaluated": 18, "nm.lanes_live": 12}
    return r


def _ctx(records, **got):
    return {"port_spans": dict(records=records, plain=dict(calls=4), **got)}


def test_sweep_readers_on_known_spans():
    ctx = _ctx(_sweep_records())
    got = layout.reader("straggler_time_pct.sweep")(ctx)
    assert got["value"] == pytest.approx(100 * 390 / 1000)
    assert [s["stage"] for s in got["stages"]] == [1, 2]
    assert got["stages"][1]["ms"] == pytest.approx(390e-6)
    assert got["stage_calls"] == got["sweep_calls"] == 4
    assert layout.reader("tables_ms.sweep")(ctx) == {"value": pytest.approx(100e-6),
                                                      "spec_build_ms": pytest.approx(40e-6)}
    live = layout.reader("live_lane_pct.sweep")(ctx)
    assert live == {"value": pytest.approx(100 * 12 / 18), "lanes_live": 12,
                    "lanes_evaluated": 18}
    nm = layout.reader("nm_host_us_per_iter.sweep")(ctx)
    # each iteration less its call and its read: 200-120-40, 190-95-60, 370-280-60
    assert nm["value"] == pytest.approx((40 + 35 + 30) / 3 / 1e3)
    assert nm["live_read_us"] == pytest.approx((40 + 60 + 60) / 3 / 1e3)
    call = layout.reader("host_us_per_call.sweep")(ctx)
    assert call["value"] == pytest.approx((90 + 120 + 95 + 280) / 4 / 1e3)
    assert call["llh.correct_us"] == pytest.approx(70 / 4 / 1e3)
    assert call["hand_launches"] == pytest.approx(18 / 4)
    # covered: the tables 100, the calls and iterations 90 + 200 + 190 + 370
    assert call["uncovered_pct"] == pytest.approx(5.0)


def test_fit_readers_on_known_spans():
    """A fit is three roots; the request's own walls cover them."""
    r = [_span(1, "spec.build", 1000, 1100), _span(2, "likelihood.build", 1150, 1200),
         _span(3, "solve", 1200, 1900), _span(4, "llh", 1210, 1300, 3, lanes=2, hand_launches=5),
         _span(5, "nm.live_read", 1300, 1310, 3), _span(6, "nm.iter", 1310, 1890, 3),
         _span(7, "llh", 1320, 1800, 6, lanes=6, hand_launches=5),
         _span(8, "nm.live_read", 1810, 1880, 6)]
    ctx = {"port_spans": dict(records=r, plain=dict(t0=900e-9, t1=2000e-9))}
    call = layout.reader("host_us_per_call.fit")(ctx)
    assert call["value"] == pytest.approx((90 + 480) / 2 / 1e3)
    assert call["uncovered_pct"] == pytest.approx(100 * (1 - 850 / 1100))
    nm = layout.reader("nm_host_us_per_iter.fit")(ctx)
    assert nm == {"value": pytest.approx(30 / 1e3), "live_read_us": pytest.approx(70 / 1e3),
                  "iters": 1}


class _Event:
    def __init__(self, name, start, end, cuda=False, annotation=False):
        self._n, self._s, self._e, self._c, self._a = name, start, end, cuda, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._c else DeviceType.CPU

    def is_user_annotation(self):
        return self._a


def test_idle_by_span_leaves_annotations_out_of_the_busy_time():
    """Kineto's device-side copies of the spans (gpu_user_annotation) are
    not work; each gap goes to the innermost port span or aten op in its
    middle, else to the Python between operations."""
    events = [_Event("sweep", 0, 1000, annotation=True), _Event("llh", 100, 300, annotation=True),
              _Event("aten::add", 120, 140), _Event("cudaLaunchKernel", 150, 160),
              _Event("cudaLaunchKernel", 450, 460), _Event("cudaLaunchKernel", 1200, 1210),
              _Event("k1", 200, 250, cuda=True), _Event("k2", 600, 700, cuda=True),
              _Event("k3", 1500, 1600, cuda=True),
              _Event("llh", 100, 300, cuda=True, annotation=True),  # by its flag and its name
              _Event("sweep", 0, 1000, cuda=True),  # by its name alone
              _Event("ProfilerStep#1", 0, 1600, cuda=True, annotation=True)]  # by its flag
    trace = hs.annotated(events, 2e-6, {"sweep", "llh"})
    assert trace.complete and trace.busy_s() == pytest.approx(250e-9)
    got = layout.reader("llh_idle_pct.sweep")(
        {"port_spans": dict(trace=trace, names={"sweep", "llh"})})
    # gaps: [0, 200] in llh, [250, 600] in the sweep, [700, 1500] outside every span
    assert got["idle_by_span"] == {hs.PYTHON: pytest.approx(800e-9),
                                   "sweep": pytest.approx(350e-9),
                                   "llh": pytest.approx(200e-9)}
    assert got["idle_s"] == pytest.approx(got["stretch_s"] - got["busy_s"])
    assert got["value"] == pytest.approx(100 * 200 / 1350)
    assert got["python_pct"] == pytest.approx(100 * 800 / 1350)
    assert layout.reader("llh_idle_pct.fit")(
        {"port_spans": dict(trace=hs.annotated(events[:-3], 2e-6, set()), names=set())}
    )["value"] == pytest.approx(0.0)  # no llh span in the trace: none of the idle time


def test_readers_read_nothing_without_the_ports_spans(monkeypatch):
    import misti_tpu_torch

    monkeypatch.delattr(misti_tpu_torch, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "misti_tpu_torch.spans", None)
    ctx = {"driver": None, "request": None, "cell": "x.sweep"}
    for m in ("straggler_time_pct.sweep", "tables_ms.sweep", "live_lane_pct.sweep",
              "nm_host_us_per_iter.sweep", "nm_host_us_per_iter.fit",
              "host_us_per_call.sweep", "host_us_per_call.fit", "llh_idle_pct.sweep",
              "llh_idle_pct.fit"):
        assert layout.reader(m)(ctx) is None
