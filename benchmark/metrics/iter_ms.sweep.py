"""iter_ms.sweep: the window's sweep wall over its objective calls, ms per
lockstep Nelder-Mead iteration (per-split tables and compaction included).
Layer: the optimiser (engine/optimize.py)."""


def read(ctx):
    calls = sum(r["calls"] for r in ctx["records"])
    return 1e3 * sum(r["t1"] - r["t0"] for r in ctx["records"]) / calls if calls else None
