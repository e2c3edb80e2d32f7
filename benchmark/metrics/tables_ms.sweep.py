"""tables_ms.sweep: a sweep's per-split tables (``sweep.tables``: the
per-split specs, the stacked tables and their upload in
``build_fused_sweep``), ms, from the port's spans of one more request served
as the window serves it (benchmark/harness/spans.py).  Nothing to read where
the port has no spans.  Layer: the sweep driver (engine/bootstrap.py)."""

from benchmark.harness.spans import dur, named, runs


def read(ctx):
    got = runs(ctx)
    if got is None:
        return None
    records = got["records"]
    tables, sweeps = named(records, "sweep.tables"), named(records, "sweep")
    if not tables or not sweeps:
        return None
    return {"value": sum(map(dur, tables)) / len(sweeps) / 1e6,
            "spec_build_ms": sum(map(dur, named(records, "spec.build"))) / len(sweeps) / 1e6}
