"""calls_per_sweep: batched objective calls (Nelder-Mead steps over the
whole grid) per sweep, the mean of ``SweepResult.calls`` over the window's
sweeps.  Layer: the sweep driver (engine/bootstrap.py)."""


def read(ctx):
    calls = [r["calls"] for r in ctx["records"]]
    return sum(calls) / len(calls) if calls else None
