"""The reader of the fit's graph replays (metrics/graph_replay_pct.fit.py) on
synthetic records."""

import sys

import pytest

from benchmark.harness import layout


def _span(id_, name, parent=None, **attrs):
    return dict(id=id_, name=name, start=id_, end=id_ + 1, parent=parent, request=3,
                attrs=attrs)


def test_replays_over_the_fits_calls():
    r = [_span(1, "spec.build"), _span(2, "likelihood.build"),
         _span(4, "llh", 3, lanes=2, hand_launches=3),
         _span(5, "llh", 3, lanes=6, hand_launches=3),
         _span(6, "llh", 3, lanes=6, hand_launches=3, graph=True),
         _span(7, "llh", 3, lanes=6, hand_launches=3, graph=True),
         _span(8, "llh", 3, lanes=6, hand_launches=3, graph=True), _span(3, "solve")]
    r[-1]["counters"] = {"llh.graph_captures": 1, "llh.graph_replays": 3}
    got = layout.reader("graph_replay_pct.fit")({"port_spans": dict(records=r)})
    assert got == {"value": pytest.approx(60.0), "calls": 5, "replays": 3, "captures": 1}


def test_nothing_to_read_without_the_counter():
    r = [_span(4, "llh", 3, lanes=6, hand_launches=3), _span(3, "solve")]
    r[-1]["counters"] = {"nm.lanes_live": 1}
    assert layout.reader("graph_replay_pct.fit")({"port_spans": dict(records=r)}) is None


def test_nothing_to_read_without_the_ports_spans(monkeypatch):
    import misti_tpu_torch

    monkeypatch.delattr(misti_tpu_torch, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "misti_tpu_torch.spans", None)
    ctx = {"driver": None, "request": None, "cell": "x.fit"}
    assert layout.reader("graph_replay_pct.fit")(ctx) is None
