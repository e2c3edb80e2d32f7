"""The port's own spans and counters (misti_tpu_torch/spans.py), read by the
per-layer metrics of a traced run.

`runs` serves the traced run's request twice more with the port's recording
on: once as the window serves it, for the spans' times and counters, and
once under torch.profiler, where each recorded span is a host event on the
profiler's clock beside the card's kernels, for the card's idle time inside
them.  Both runs are kept in ``ctx``, so they happen once a traced run,
whichever reader asks first, and the records of both go to
``benchmark/out/<cell>.seed<n>.port_spans.jsonl``.  Where the port has no
spans, `runs` returns None and serves nothing.

The traced request the harness reads its own metrics from runs before,
with the port's recording off, so nothing here changes them.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

from benchmark.harness.profiling import Trace

OUT = Path(__file__).resolve().parents[1] / "out"
PYTHON = "(Python between operations)"  # no port span or aten op running: Trace's name


def runs(ctx: dict):
    """{"plain": the request's record (harness/drivers.py `serve`),
    "records": the port's span records, "profiled_records": the profiled
    run's, "trace": its `annotated` Trace, "names": the port's span names},
    or None without the port's spans."""
    if "port_spans" in ctx:
        return ctx["port_spans"]
    ctx["port_spans"] = None
    try:
        from misti_tpu_torch import spans
    except ImportError:
        return None
    driver, req = ctx["driver"], ctx["request"]
    with spans.recording() as records:
        plain = driver.serve(req, keep=False)
    for _ in range(3):  # as the harness's own traced request: again while kernels are missed
        with spans.recording() as profiled_records:
            events, wall = _profile(lambda: driver.serve(req, keep=False))
        names = {r["name"] for r in records} | {r["name"] for r in profiled_records}
        trace = annotated(events, wall, names)
        if trace.complete:
            break
    got = dict(plain=plain, records=records, profiled_records=profiled_records, trace=trace,
               names=names)
    _write(ctx, got)
    ctx["port_spans"] = got
    return got


def _profile(fn):
    """(the profiler's events of ``fn``, its wall in s), both activities."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return list(prof.profiler.kineto_results.events()), wall


def annotated(events, wall_s: float, names) -> Trace:
    """The `Trace` of ``events`` with every annotation on the device's
    timeline left out: Kineto may draw each recorded span there too
    (``gpu_user_annotation``), and such a range is not work on the card.
    An annotation is an event the profiler marks as one, or a device event
    named as one of the port's spans."""
    from torch.autograd import DeviceType

    def annotation(e):
        if e.device_type() != DeviceType.CUDA:
            return False
        flag = getattr(e, "is_user_annotation", None)
        return e.name() in names or (flag is not None and flag())

    return Trace([e for e in events if not annotation(e)], wall_s)


def _write(ctx, got):
    seed = ctx.get("seed")
    if seed is None:  # the runner's own argument
        p = argparse.ArgumentParser(add_help=False)
        p.add_argument("--seed")
        seed = p.parse_known_args(sys.argv[1:])[0].seed
    OUT.mkdir(parents=True, exist_ok=True)
    with open(OUT / f"{ctx['cell']}.seed{seed}.port_spans.jsonl", "w") as f:
        for run in ("records", "profiled_records"):
            for r in got[run]:
                f.write(json.dumps(dict(r, run=run)) + "\n")


# -- the arithmetic of the readers ---------------------------------------------

def named(records, name: str) -> list:
    return [r for r in records if r["name"] == name]


def dur(r) -> int:
    return r["end"] - r["start"]


def children(records, parent, name: str) -> list:
    return [r for r in records if r["parent"] == parent["id"] and r["name"] == name]


def self_ns(records, parent, *names) -> int:
    """``parent``'s duration less that of its children of ``names``."""
    return dur(parent) - sum(dur(c) for n in names for c in children(records, parent, n))


def uncovered_pct(start: int, end: int, spans) -> float:
    """The share of [start, end] that no span of ``spans`` covers, %."""
    covered, t = 0, start
    for r in sorted(spans, key=lambda r: r["start"]):
        s, e = max(r["start"], t), min(r["end"], end)
        if e > s:
            covered += e - s
            t = e
    return 100 * (1 - covered / (end - start))


def idle_by_span(trace: Trace, names) -> tuple:
    """({name: s}, s inside `llh` spans): the card's idle time from the
    traced stretch's first host operation to its last device operation
    (Trace.idle_gaps' stretch), each gap put down to the innermost port span
    (named in ``names``) or aten op running in its middle, or to
    `PYTHON` where none runs."""
    if not trace.device or not trace.host:
        return {}, 0.0
    host = sorted(((s, e, n) for s, e, n in trace.host
                   if n in names or n.startswith("aten::")), key=lambda h: (h[0], -h[1]))
    parent, open_ = [], []  # each event's innermost enclosing one, by a stack
    for i, (s, e, _) in enumerate(host):
        while open_ and host[open_[-1]][1] < s:
            open_.pop()
        parent.append(open_[-1] if open_ else None)
        open_.append(i)
    starts = [h[0] for h in host]
    calls = sorted((s, e) for s, e, n in host if n == "llh")
    call_starts = [c[0] for c in calls]

    by, in_llh = defaultdict(int), 0
    t, stop = trace.host[0][0], trace.device[-1][1]
    for s, e, _ in trace.device + [(stop, stop, "")]:
        if s > t:
            mid = (s + t) // 2
            i = bisect.bisect_right(starts, mid) - 1
            while i is not None and i >= 0 and host[i][1] < mid:
                i = parent[i]
            by[host[i][2] if i is not None and i >= 0 else PYTHON] += s - t
            j = bisect.bisect_right(call_starts, mid) - 1
            if j >= 0 and calls[j][1] >= mid:
                in_llh += s - t
        t = max(t, e)
    return ({k: v / 1e9 for k, v in sorted(by.items(), key=lambda kv: -kv[1])},
            in_llh / 1e9)


# -- the readings, one per metric and kind --------------------------------------

def host_us_per_call(got) -> dict:
    """Host time of an objective call (`llh` span), us, from the run served
    as the window serves it; the same split by stage, the hand kernels'
    launches per call, and the part of the request that the port's
    layer spans leave uncovered."""
    records = got["records"]
    calls = named(records, "llh")
    if not calls:
        return None
    out = {"value": sum(map(dur, calls)) / len(calls) / 1e3, "calls": len(calls),
           "hand_launches": sum(c["attrs"]["hand_launches"] for c in calls) / len(calls)}
    for stage in ("llh.lanes", "llh.correct", "llh.post_split", "llh.spectrum",
                  "llh.multinomial"):
        out[f"{stage}_us"] = sum(map(dur, named(records, stage))) / len(calls) / 1e3
    roots = [r for r in records if r["parent"] is None]
    if any(r["name"] == "sweep" for r in roots):  # each sweep, by its tables, iterations, calls
        out["uncovered_pct"] = max(
            uncovered_pct(r["start"], r["end"], [
                c for c in records if c["request"] == r["id"]
                and c["name"] in ("sweep.tables", "nm.iter", "llh")])
            for r in roots if r["name"] == "sweep")
    else:  # the fit, by its spec, its likelihood and its solve
        p = got["plain"]
        out["uncovered_pct"] = uncovered_pct(round(p["t0"] * 1e9), round(p["t1"] * 1e9), [
            r for r in roots if r["name"] in ("spec.build", "likelihood.build", "solve")])
    return out


def nm_host_us_per_iter(got) -> dict:
    """The optimiser's own host time of a Nelder-Mead iteration (`nm.iter`
    less its `llh` and `nm.live_read`), us, and its host read's."""
    records = got["records"]
    iters = named(records, "nm.iter")
    if not iters:
        return None
    own = sum(self_ns(records, it, "llh", "nm.live_read") for it in iters)
    read = sum(dur(c) for it in iters for c in children(records, it, "nm.live_read"))
    return {"value": own / len(iters) / 1e3, "live_read_us": read / len(iters) / 1e3,
            "iters": len(iters)}


def llh_idle_pct(got) -> dict:
    """The card's idle time inside `llh` spans over all its idle time in the
    profiled run, %, and every gap put down to the innermost port span or
    aten op (`idle_by_span`).  None where the profiler missed kernels."""
    trace = got["trace"]
    if not trace.complete:
        return None
    by, in_llh = idle_by_span(trace, got["names"])
    idle = sum(by.values())
    if not idle:
        return None
    stretch = (trace.device[-1][1] - trace.host[0][0]) / 1e9
    return {"value": 100 * in_llh / idle, "idle_s": idle,
            "python_pct": 100 * by.get(PYTHON, 0.0) / idle,
            "stretch_s": stretch, "busy_s": trace.busy_s(), "idle_by_span": by}
