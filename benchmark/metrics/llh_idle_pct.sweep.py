"""llh_idle_pct.sweep: the card's idle time inside objective calls (``llh``
spans) over all its idle time in one more sweep, profiled with the port's
spans recorded, %; beside it ``idle_by_span``, every idle gap put down to
the innermost port span or aten op running in its middle
(benchmark/harness/spans.py; the profiler's annotation ranges are no device
time).  Nothing to read where the port has no spans or the profiler missed
kernels.  Layer: the device (H100)."""

from benchmark.harness.spans import llh_idle_pct, runs


def read(ctx):
    got = runs(ctx)
    return None if got is None else llh_idle_pct(got)
