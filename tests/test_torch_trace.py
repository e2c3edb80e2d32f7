"""The port's spans and counters (misti_tpu_torch/spans.py), float64 on the
CPU: recording off leaves no record and no profiler event, recording on
changes no answer, the spans nest, their counts agree with the results',
and under torch.profiler each span is a host event around the ops it ran.
Also the sweep CLI's ``--profile``, which records the spans into its trace.

The sweep is test_torch_sweep.py's two-split cpfit sweep, cut to 3
replicates and to few iterations in three stages; the fit is one toy fit
with a loose tolerance.
"""

import contextlib
import io
import json
import os
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from conftest import FIXDIR
from misti_tpu_torch import build_likelihood, build_spec, solve, spans
from misti_tpu_torch.cli import sweep as cli
from misti_tpu_torch.engine import bootstrap
from test_sweep_fused import _toy
from _torch_sweep_cases import one_torch_thread  # noqa: F401 (autouse fixture)

MODEL = np.array([3317.9, 571.4, 3298.2, 2083.7, 1071.3, 576.4, 1081.1])
LLH_STAGES = ("llh.lanes", "llh.correct", "llh.post_split", "llh.spectrum", "llh.multinomial")


def _sweep():
    times, lams = _toy()
    data = np.stack([MODEL * f for f in (1.0, 0.99, 1.01)])
    return bootstrap.sweep(times, lams, data, [4, 7], [[1, 0, "ST", 0.25, 1]], (),
                           tol=1e-4, device="cpu", cpfit=True, smooth=False, unfolded=True,
                           stage_caps=(1, 2), maxiter=4)


def _fit(**flags):
    """A fit as cli/misti.py makes one: the spec, the likelihood, the solve."""
    times, lams = _toy()
    spec = build_spec(times, lams, [0.0, *MODEL], 5, [[1, 0, 5, 0.25, 1]], [], cpfit=True,
                      unfolded=True, **flags)
    with contextlib.redirect_stdout(io.StringIO()):
        return solve(build_likelihood(spec, device="cpu"), tol=1e-2)


@pytest.fixture(scope="module")
def sweeps():
    off = _sweep()
    with spans.recording() as records:
        on = _sweep()
    return off, on, records


@pytest.fixture(scope="module")
def fits():
    off = _fit()
    with spans.recording() as records:
        on = _fit()
    return off, on, records


def _by_id(records):
    return {r["id"]: r for r in records}


def _assert_nested(records):
    """Every span inside its parent, of its parent's request."""
    ids = _by_id(records)
    for r in records:
        assert r["start"] <= r["end"]
        if r["parent"] is None:
            assert r["request"] == r["id"]
            continue
        p = ids[r["parent"]]
        assert p["start"] <= r["start"] and r["end"] <= p["end"], (r["name"], p["name"])
        assert r["request"] == p["request"]


def test_recording_off_leaves_no_record_and_answers_equal(sweeps, fits):
    """Off, a span is the one shared no-op and a counter does nothing; on,
    every answer is bitwise the one recording off gives."""
    assert spans._rec is None
    assert spans.span("llh", lanes=3) is spans.span("sweep")
    assert not spans.span("llh")
    spans.count("nm.lanes_live", torch.ones(3))
    with spans.recording() as records:
        pass
    assert records == []
    (s_off, s_on, _), (f_off, f_on, _) = sweeps, fits
    for key in ("params", "llh", "nfev", "converged"):
        np.testing.assert_array_equal(getattr(s_on, key), getattr(s_off, key), err_msg=key)
    assert s_on.calls == s_off.calls
    np.testing.assert_array_equal(f_on.x, f_off.x)
    assert (f_on.llh, f_on.nit, f_on.nfev) == (f_off.llh, f_off.nit, f_off.nfev)


def test_sweep_spans(sweeps):
    """One `sweep` root, every span inside its parent; the stages' calls sum
    to the sweep's objective calls, each a `llh` span with its five stages;
    the live lanes are at most the evaluated ones."""
    _, res, records = sweeps
    _assert_nested(records)
    roots = [r for r in records if r["parent"] is None]
    assert [r["name"] for r in roots] == ["sweep"]
    assert roots[0]["attrs"] == dict(splits=2, replicates=3, cells=6)
    names = Counter(r["name"] for r in records)
    stages = [r for r in records if r["name"] == "sweep.stage"]
    assert [s["attrs"]["stage"] for s in stages] == [1, 2, 3]
    assert stages[0]["attrs"]["cells"] == 6 and stages[0]["attrs"]["lanes"] == 6 * 6
    assert sum(s["attrs"]["calls"] for s in stages) == res.calls == names["llh"]
    assert stages[-1]["attrs"]["unconverged"] == int((~res.converged).sum())
    assert all(names[s] == res.calls for s in LLH_STAGES)
    assert names["sweep.tables"] == 1 and names["spec.build"] == 2
    assert names["nm.iter"] == res.calls - 1  # and stage 1's start; later stages resume
    ids = _by_id(records)
    parents = Counter(ids[r["parent"]]["name"] for r in records if r["name"] == "llh")
    assert parents == {"nm.iter": names["nm.iter"], "sweep.stage": 1}
    counters = roots[0]["counters"]
    assert counters["nm.lanes_evaluated"] == 6 * names["nm.iter"]
    assert 0 < counters["nm.lanes_live"] <= counters["nm.lanes_evaluated"]
    assert all(r["attrs"]["hand_launches"] == 0 for r in records if r["name"] == "llh")


def test_fit_spans(fits):
    """A fit's roots: `spec.build`, `likelihood.build`, `solve`; a `llh`
    span per objective call (its iterations and its start)."""
    _, res, records = fits
    _assert_nested(records)
    assert [r["name"] for r in records if r["parent"] is None] == [
        "spec.build", "likelihood.build", "solve"]
    names = Counter(r["name"] for r in records)
    assert names["nm.iter"] == res.nit - 1 and names["llh"] == res.nit
    assert names["nm.live_read"] == res.nit
    lanes = Counter(r["attrs"]["lanes"] for r in records if r["name"] == "llh")
    assert lanes == {2: 1, 6: res.nit - 1}  # the start's n + 1 points, an iteration's n + 5


def _events(prof):
    """(start ns, end ns, name) of every host event, by start."""
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events())


def test_spans_are_profiler_events():
    """Recording off, a profiled fit holds no span; recording on, every span
    is a host event of its name, and each `llh` event encloses, on the
    profiler's clock, its five stages and every aten op that started inside
    it.  Uncorrected (``correct=False``), for fewer events."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _fit(correct=False)
    assert not {"solve", "llh", "nm.iter"} & {name for _, _, name in _events(prof)}
    with profile(activities=[ProfilerActivity.CPU]) as prof, spans.recording() as records:
        _fit(correct=False)
    events = _events(prof)
    names = Counter(r["name"] for r in records)
    assert names == Counter(name for _, _, name in events if name in names)
    calls = [(start, end) for start, end, name in events if name == "llh"]
    assert len(calls) == names["llh"]
    for start, end in calls:
        inside = [(s, e, name) for s, e, name in events if start <= s < end and name != "llh"]
        assert sorted(name for _, _, name in inside if name.startswith("llh.")) == sorted(
            LLH_STAGES)
        assert any(name.startswith("aten::") for _, _, name in inside)
        assert all(e <= end for _, e, _ in inside)


def test_cli_profile_writes_the_spans(tmp_path, capsys):
    """``--profile DIR``: the trace holds the port's spans, ``spans.jsonl``
    their records, and the busy line is over the profiled wall."""
    argv = [os.path.join(FIXDIR, n) for n in ("synth1.psmc", "synth2.psmc", "synth.jsfs")]
    argv += ["--splits", "7", "7", "-bs", "1", "-mi", "1", "2", "ST", "0.3", "1", "-uf",
             "--cpfit", "--nosmooth", "--trueEPS", "--funits", "/nonexistent", "--platform",
             "cpu", "--maxiter", "2", "--stages", "1", "--profile", str(tmp_path)]
    assert cli.main(argv) == 0
    err = capsys.readouterr().err
    assert "# profile: device busy 0.000 ms over the profiled wall" in err
    records = [json.loads(line) for line in open(tmp_path / "spans.jsonl")]
    _assert_nested(records)
    assert [r["name"] for r in records if r["parent"] is None] == ["sweep"]
    assert [r["attrs"]["stage"] for r in records if r["name"] == "sweep.stage"] == [1, 2]
    trace = json.load(open(tmp_path / "trace.json"))
    names = Counter(e.get("name") for e in trace["traceEvents"])
    for name, n in Counter(r["name"] for r in records).items():
        assert names[name] == n, name
