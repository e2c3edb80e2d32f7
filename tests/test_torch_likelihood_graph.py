"""The batch objective as CUDA graph replays (engine/likelihood.py
`BatchGraphs`, `cuda_capture`).

On the CPU, through a stand-in for the graph (`StandIn`: a capture calls the
body, a replay calls it again into the same outputs with recording off, as a
replay runs no Python): a width's first call runs eagerly, its second
captures, its third replays; at most `_MAX_GRAPHS` graphs are kept; a CPU
likelihood never captures; `llh_aux`, `llh`, `llh_flags` and `llh_data`
never replay; the counters, the `llh` span's `graph` attribute and the
stage spans of each kind of call; a returned tensor stays as it was after
the next call; a fit through the stand-in is the eager fit.

On the card (skipped here: a graph needs CUDA): fits that replay are bitwise
the eager fits (every `SolveResult` field) in ECT with smoothing, cpfit,
cpfit with an optimised pulse (n = 2, width 7) and trueEPS; each call at
widths 1, 6 and 7, with -inf lanes and negative parameters, bitwise the eager
core's; a returned tensor is unchanged by the next call; the hand kernels'
wrappers launch on a width's eager and capturing calls and not on a replay,
whose graph runs the eager call's kernels (torch.profiler); 50 likelihoods
built, replayed and dropped leave the card's reserved memory where 2 left it.
"""

import contextlib
import io
import os
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from misti_tpu_torch import build_likelihood, build_spec, solve, spans
from misti_tpu_torch.engine import likelihood as lk
from misti_tpu_torch.io import jsfs as io_jsfs
from misti_tpu_torch.io import psmc as io_psmc

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
MODEL = [0.0, 3317.9, 571.4, 3298.2, 2083.7, 1071.3, 576.4, 1081.1]
STAGES = ("llh.lanes", "llh.correct", "llh.post_split", "llh.spectrum", "llh.multinomial")


def _toy(numT=12):
    grid = 0.015 * (1.14 ** np.arange(numT)) - 0.015
    tt = np.cumsum([0.0] + list(np.diff(grid)))
    lams = np.stack([1.0 + 0.3 * np.sin(tt * 11.0), 1.1 + 0.25 * np.cos(tt * 7.0)], axis=1)
    return list(np.diff(grid)), [list(v) for v in lams]


def _toy_lik(pulse=False, correct=True):
    """A two-parameter cpfit likelihood on the CPU: a band and, with
    ``pulse``, an optimised pulse before the split."""
    times, lams = _toy()
    pu = [[2, 3, 0.15, 1]] if pulse else []
    spec = build_spec(times, lams, MODEL, 5, [[1, 0, 5, 0.25, 1]], pu, cpfit=True,
                      unfolded=True, correct=correct)
    return build_likelihood(spec, device="cpu")


class StandIn:
    """A capture that calls: the body runs at the capture (recording its
    spans, as the real capture's Python does), and each replay runs it again
    into the same outputs under a recording that is thrown away."""

    def __init__(self):
        self.captures = 0

    def __call__(self, fn, static_in):
        self.captures += 1
        outputs = fn(static_in)

        def replay():
            with spans.recording():
                new = fn(static_in)
            for o, n in zip(outputs, new):
                o.copy_(n)

        return SimpleNamespace(replay=replay, outputs=outputs, static_in=static_in)


def _stand_in(lik):
    lik.graphs.capture = StandIn()
    return lik.graphs.capture


def _points(B, n, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).uniform(0.05, 0.6, (B, n)))


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


# --- on the CPU, through the stand-in -------------------------------------------

def test_a_widths_second_call_captures_and_its_third_replays():
    lik = _toy_lik()
    cap = _stand_in(lik)
    n = lik.spec.n_params
    seen = []
    for B, seed in [(6, 0), (6, 1), (6, 2), (2, 3), (6, 4), (2, 5), (2, 6)]:
        p = _points(B, n, seed)
        got = lik.llh_flags_batch(p)
        assert _equal(got, lik.graphs.eager("flags", p))
        seen.append((cap.captures, sorted(lik.graphs.graphs)))
    six, two = ("flags", 6), ("flags", 2)
    assert seen == [(0, []), (1, [six]), (1, [six]), (1, [six]), (1, [six]),
                    (2, [two, six]), (2, [two, six])]


@pytest.mark.parametrize("entry", ["llh_batch", "llh_flags_batch"])
def test_at_most_max_graphs_are_kept(entry):
    lik = _toy_lik(correct=False)
    cap = _stand_in(lik)
    call = getattr(lik, entry)
    widths = range(1, lk._MAX_GRAPHS + 3)
    for _ in range(3):
        for B in widths:
            call(_points(B, lik.spec.n_params, B))
    assert cap.captures == lk._MAX_GRAPHS
    assert sorted(B for _, B in lik.graphs.graphs) == list(widths)[:lk._MAX_GRAPHS]


def test_a_cpu_likelihood_never_captures():
    lik = _toy_lik(correct=False)
    assert lik.graphs.capture is None
    p = _points(6, lik.spec.n_params)
    with spans.recording() as records:
        outs = [lik.llh_flags_batch(p) for _ in range(3)]
    assert lik.graphs.graphs == {}
    calls = [r for r in records if r["name"] == "llh"]
    assert len(calls) == 3 and not any("graph" in r["attrs"] for r in calls)
    assert not any(k.startswith("llh.graph") for r in records for k in r.get("counters", {}))
    assert all(_equal(o, outs[0]) for o in outs)


def test_the_single_and_data_entries_never_replay():
    lik = _toy_lik(correct=False)
    cap = _stand_in(lik)
    n = lik.spec.n_params
    x = np.full(n, 0.3)
    for _ in range(3):
        lik.llh(x)
        lik.llh_aux(x)
        lik.llh_flags(x)
        lik.llh_data(_points(3, n), np.asarray(MODEL[1:]))
    assert cap.captures == 0 and lik.graphs.graphs == {}


def test_counters_and_spans_of_eager_capturing_and_replayed_calls():
    n_calls = 4
    runs = {}
    served = {}
    for kind in ("eager", "graph"):
        lik = _toy_lik(pulse=True)
        if kind == "graph":
            _stand_in(lik)
        p = _points(lik.spec.n_params + 5, lik.spec.n_params)
        before = (lk.BatchGraphs.captures, lk.BatchGraphs.replays)
        with spans.recording() as records:
            with spans.span("solve"):  # a request's root, which carries its counters
                for _ in range(n_calls):
                    lik.llh_flags_batch(p)
        runs[kind] = records
        served[kind] = (lk.BatchGraphs.captures - before[0], lk.BatchGraphs.replays - before[1])
    assert served == {"eager": (0, 0), "graph": (1, n_calls - 1)}
    counters = {k: r["counters"] for k, r in ((k, v[-1]) for k, v in runs.items())}
    for name in ("correction.pulse_rows", "spectrum.pulse_ops"):
        assert counters["graph"][name] == counters["eager"][name] > 0
    assert counters["graph"]["llh.graph_captures"] == 1
    assert counters["graph"]["llh.graph_replays"] == n_calls - 1
    assert not any(k.startswith("llh.graph") for k in counters["eager"])

    records = runs["graph"]
    calls = sorted((r for r in records if r["name"] == "llh"), key=lambda r: r["start"])
    assert [r["attrs"].get("graph", False) for r in calls] == [False] + [True] * (n_calls - 1)
    assert all("hand_launches" in r["attrs"] for r in calls)
    names = Counter(r["name"] for r in records)
    assert all(names[s] == 2 for s in STAGES)  # the eager call's and the capture's
    (capture,) = [r for r in records if r["name"] == "llh.capture"]
    assert capture["parent"] == calls[1]["id"]
    under = {r["name"] for r in records if r["start"] >= capture["start"]
             and r["end"] <= capture["end"] and r["id"] != capture["id"]}
    assert set(STAGES) <= under


def test_a_returned_tensor_stays_after_the_next_call():
    lik = _toy_lik(correct=False)
    _stand_in(lik)
    n = lik.spec.n_params
    for seed in range(2):
        lik.llh_batch(_points(6, n, seed))  # eager, then the capture
    first = lik.llh_batch(_points(6, n, 2))
    kept = first.clone()
    second = lik.llh_batch(_points(6, n, 3))
    assert torch.equal(first, kept) and not torch.equal(first, second)


def _fit(lik, tol=1e-2):
    with contextlib.redirect_stdout(io.StringIO()):
        return solve(lik, tol=tol)


def _fields(sol):
    return (sol.x.tolist(), sol.llh, sol.nit, sol.nfev, sol.corr_called, sol.corr_failed)


def test_a_fit_through_the_stand_in_is_the_eager_fit():
    eager = _fit(_toy_lik(correct=False))
    lik = _toy_lik(correct=False)
    cap = _stand_in(lik)
    with spans.recording() as records:
        graph = _fit(lik)
    assert _fields(graph) == _fields(eager)
    assert cap.captures == 1
    root = [r for r in records if r["name"] == "solve"][0]
    assert root["counters"]["llh.graph_replays"] == graph.nit - 2


# --- on the card --------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU form")
    return torch.device("cuda")


# the north-star command at split 24 (tests/fixtures/torch_single_fit_ref.json),
# smoothing on: (mi, pu, flags)
FITS = {
    "ect": ([[1, 4, 24, 3.0, 1]], [], dict(cpfit=False)),
    "cpfit": ([[1, 4, 24, 3.0, 1]], [], dict(cpfit=True)),
    "cpfit_pulse": ([[1, 4, 24, 3.0, 1]], [[2, 20, 0.2, 1]], dict(cpfit=True)),
    "trueeps": ([[1, 4, 24, 3.0, 1]], [], dict(correct=False)),
}


def _card_lik(name, device, eager=False):
    data = io_psmc.read_psmc(os.path.join(FIX, "sweep1.psmc"), os.path.join(FIX, "sweep2.psmc"),
                             0, -1)
    sfs = list(io_jsfs.read_jafs(os.path.join(FIX, "sweep.jsfs")).jafs[0])
    mi, pu, flags = FITS[name]
    spec = build_spec(data.times, data.lambdas, sfs, 24, mi, pu, smooth=True, unfolded=True,
                      sample_date=data.sample_date_discr, thrh=(data.theta, data.rho), **flags)
    lik = build_likelihood(spec, device=device, dtype=torch.float64)
    if eager:
        lik.graphs.capture = None
    return lik


@pytest.mark.parametrize("name", list(FITS))
def test_a_replayed_fit_is_the_eager_fit_on_card(cuda, name):
    eager = _fit(_card_lik(name, cuda, eager=True), 1e-4)
    lik = _card_lik(name, cuda)
    with spans.recording() as records:
        graph = _fit(lik, 1e-4)
    assert _fields(graph) == _fields(eager)
    assert len(lik.graphs.graphs) == 1
    root = [r for r in records if r["name"] == "solve"][0]
    assert root["counters"]["llh.graph_replays"] == graph.nit - 2


@pytest.mark.parametrize("B", [1, 6, 7])
def test_each_call_is_the_eager_cores_on_card(cuda, B):
    lik = _card_lik("cpfit_pulse", cuda)
    n = lik.spec.n_params
    for seed in range(6):
        p = _points(B, n, seed).to(cuda)
        if B > 1:
            p[seed % B] = -p[seed % B]  # a negative parameter: -inf
            p[(seed + 1) % B, 0] = 1e6  # a rate the correction fails at
        got = lik.llh_flags_batch(p)
        want = lik.graphs.eager("flags", p)
        assert _equal(got, want), (B, seed)
    assert ("flags", B) in lik.graphs.graphs


def test_a_returned_tensor_is_unchanged_by_the_next_call_on_card(cuda):
    lik = _card_lik("ect", cuda)
    n = lik.spec.n_params
    outs = [lik.llh_flags_batch(_points(6, n, seed).to(cuda)) for seed in range(3)]
    kept = [tuple(t.clone() for t in o) for o in outs]
    lik.llh_flags_batch(_points(6, n, 3).to(cuda))
    assert all(_equal(o, k) for o, k in zip(outs, kept))
    assert not torch.equal(outs[1][0], outs[2][0])


def _kernels_seen(call, times=3):
    """The names of the CUDA kernels torch.profiler saw over ``times`` calls,
    and the runtime's graph launches among its host events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(times):
            call()
        torch.cuda.synchronize()
    events = prof.key_averages()
    names = {e.key for e in events if e.device_type == DeviceType.CUDA
             and not e.key.startswith(("Memcpy", "Memset"))}
    return names, sum(e.count for e in events if e.key == "cudaGraphLaunch")


def test_hand_kernels_launch_on_eager_and_capturing_calls_only_on_card(cuda):
    lik = _card_lik("ect", cuda)
    kernels = (lk.correction_sweep, lk.post_fit, lk.row_matmul, lk.spectrum_kernel)
    before = [k.launches for k in kernels]
    replays, captures = lk.BatchGraphs.replays, lk.BatchGraphs.captures
    p = _points(6, lik.spec.n_params).to(cuda)
    seen = []
    for _ in range(5):  # eager, capture, replays
        lik.llh_flags_batch(p)
        seen.append([k.launches - b for k, b in zip(kernels, before)])
    # correction, post_fit, row_matmul, spectrum
    assert seen == [[1, 1, 0, 1]] + [[2, 2, 0, 2]] * 4, seen
    assert lk.BatchGraphs.replays - replays == 4 and lk.BatchGraphs.captures - captures == 1
    eager, none = _kernels_seen(lambda: lik.graphs.eager("flags", p))
    replayed, launched = _kernels_seen(lambda: lik.llh_flags_batch(p))
    assert none == 0 and launched == 3
    assert replayed == eager and len(eager) > 3, (sorted(eager), sorted(replayed))


def test_dropped_likelihoods_release_their_graphs_memory_on_card(cuda):
    def one():
        lik = _card_lik("ect", cuda)
        p = _points(6, lik.spec.n_params).to(cuda)
        for _ in range(3):
            lik.llh_flags_batch(p)
        assert len(lik.graphs.graphs) == 1
        torch.cuda.synchronize()

    for _ in range(2):
        one()
    reserved = torch.cuda.memory_reserved()
    for _ in range(48):
        one()
    assert torch.cuda.memory_reserved() == reserved
