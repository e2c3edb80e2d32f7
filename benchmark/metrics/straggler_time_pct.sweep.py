"""straggler_time_pct.sweep: the share of a sweep's wall spent in its
compaction stages (``sweep.stage`` spans of stage 2 on, over the ``sweep``
span), %, from the port's spans of one more request served as the window
serves it (benchmark/harness/spans.py); beside it each stage's cells, lanes
per call, objective calls, unconverged cells at its end and ms.  Nothing to
read where the port has no spans.  Layer: the sweep driver
(engine/bootstrap.py)."""

from benchmark.harness.spans import children, dur, named, runs


def read(ctx):
    got = runs(ctx)
    if got is None:
        return None
    records = got["records"]
    sweeps = named(records, "sweep")
    if not sweeps:
        return None
    stages = [s for r in sweeps for s in children(records, r, "sweep.stage")]
    late = sum(dur(s) for s in stages if s["attrs"]["stage"] >= 2)
    return {"value": 100 * late / sum(map(dur, sweeps)),
            "stages": [dict(s["attrs"], ms=dur(s) / 1e6) for s in stages],
            "stage_calls": sum(s["attrs"]["calls"] for s in stages),
            "sweep_calls": got["plain"]["calls"]}
