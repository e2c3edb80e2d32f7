"""One cell's run, in stages: set-up, the measured window, the traced
request and its per-layer metrics, and the judge."""

from __future__ import annotations

import sys
import time

import numpy as np

from benchmark.harness import drivers, judge, layout, profiling
from benchmark.harness.traffic import Requests
from benchmark.reference.readers import read_jafs_rows

# top-level module names the process may not hold once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "misti_tpu")


def forbidden_modules() -> list:
    """The forbidden top-level names in ``sys.modules``, compared whole
    (``misti_tpu_torch`` is not ``misti_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Cell:
    def __init__(self, bench: dict, name: str, seed: int, seconds: float, *,
                 device: str = "cuda", dtype=None):
        import torch

        self.bench, self.name, self.seed, self.seconds = bench, name, seed, seconds
        entry = layout.cell(bench, name)
        self.config = layout.config(bench, entry["config"])
        self.mix = layout.traffic(entry["traffic"])
        self.limits = layout.limits(name)
        dtype = getattr(torch, self.config["dtype"]) if dtype is None else dtype
        rows = np.asarray(read_jafs_rows(self.config["paths"]["jsfs"]), float)
        self.requests = Requests(self.mix, self.config, rows, seed)
        if self.mix["kind"] == "sweep":
            self.driver = drivers.Sweep(self.config, self.mix, device, dtype)
        else:
            self.driver = drivers.Fit(self.config, self.mix, device, dtype,
                                      self.requests.spectra)
        self.records, self.window_s, self.done = [], None, None

    def warm_up(self):
        """Every shape the window uses: the mix's set-up requests, kept out
        of the judged answers."""
        for i in range(self.mix["warm_requests"]):
            self.driver.serve(self.requests.warm(i), keep=False)

    def run_window(self, requests: int | None = None):
        """Requests back to back for ``seconds`` (the last one started in
        time runs to its end), or exactly ``requests`` of them.  The
        window's length is the time from its start to the end of its last
        request; each request is drawn inside it."""
        t0 = time.perf_counter()
        i = 0
        while (i < requests) if requests is not None else (
                time.perf_counter() - t0 < self.seconds):
            self.records.append(self.driver.serve(self.requests.window(i)))
            i += 1
        self.window_s = time.perf_counter() - t0

    def attempted_failed(self) -> tuple:
        return len(self.records), sum(not r["finite"] for r in self.records)

    def end_to_end(self) -> dict:
        """Every end-to-end metric but set-up, over all the window's work."""
        out = {}
        if self.mix["kind"] == "sweep":
            cells = sum(r["cells"] for r in self.records)
            out["sweep_cells_per_s"] = cells / self.window_s
        else:
            out["fit_ms_p90"] = float(np.percentile(self.fit_ms(), 90))
        return out

    def fit_ms(self) -> list:
        return [1e3 * (r["t1"] - r["t0"]) for r in self.records]

    def traced(self) -> tuple:
        """(per-layer metrics, device busy s, traced window s, breakdown):
        one more request, served once as the window serves it (``plain``,
        whose wall the idle share is taken over: the profiler slows the
        host) and then under the profiler, again up to twice while the
        profiler misses kernels; then each per-layer metric's reader."""
        req = self.requests.profile()
        plain = self.driver.serve(req, keep=False)
        for _ in range(3):
            rec, trace = profiling.profile(lambda: self.driver.serve(req, keep=False))
            if trace.complete:
                break
        ctx = dict(cell=self.name, kind=self.mix["kind"], records=self.records,
                   window_s=self.window_s, plain=plain, profiled=rec, trace=trace,
                   driver=self.driver, request=req, config=self.config, mix=self.mix)
        metrics = {}
        for m in layout.per_layer(self.bench, self.name):
            got = layout.reader(m["name"])(ctx)
            if got is None:
                continue
            got = dict(got) if isinstance(got, dict) else {"value": float(got)}
            metrics[m["name"]] = {**got, "unit": m["unit"]}
        breakdown = dict(device_ops=trace.device_ops(), idle_gaps=trace.idle_gaps())
        return metrics, trace.busy_s(), trace.wall_s, breakdown

    def free(self):
        """Drop the program's state, keeping the window's answers."""
        self.done, self.driver = self.driver.done, None

    def judge(self, workers: int | None = None) -> tuple:
        """(correct, {number: {"value", "limit"}}, {number read beside: value})
        of the window's answers."""
        done = self.driver.done if self.driver is not None else self.done
        if self.mix["kind"] == "sweep":
            jobs, pairs = judge.sweep_jobs(self.config, self.mix, done, self.seed)
            numbers = judge.sweep_numbers(done, pairs, judge.run_jobs(jobs, workers))
        else:
            jobs, groups = judge.fit_jobs(self.config, self.mix, done,
                                          self.requests.spectra, self.seed)
            numbers = judge.fit_numbers(done, groups, judge.run_jobs(jobs, workers))
        return judge.verdict(numbers, self.limits)
