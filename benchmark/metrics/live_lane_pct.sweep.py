"""live_lane_pct.sweep: the lanes still live over the lanes evaluated in
the Nelder-Mead iterations of a sweep (the port's ``nm.lanes_live`` and
``nm.lanes_evaluated`` counters, summed on the card and read when the sweep
ends), %: the lockstep optimiser's useful share of its evaluations.  From
one more request served as the window serves it
(benchmark/harness/spans.py); nothing to read where the port has no spans.
Layer: the optimiser (engine/optimize.py)."""

from benchmark.harness.spans import runs


def read(ctx):
    got = runs(ctx)
    if got is None:
        return None
    counters = [r["counters"] for r in got["records"] if "counters" in r]
    live = sum(c.get("nm.lanes_live", 0) for c in counters)
    evaluated = sum(c.get("nm.lanes_evaluated", 0) for c in counters)
    if not evaluated:
        return None
    return {"value": 100 * live / evaluated, "lanes_live": live, "lanes_evaluated": evaluated}
