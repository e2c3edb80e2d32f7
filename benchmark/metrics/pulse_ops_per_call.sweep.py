"""pulse_ops_per_call.sweep: the pulse operators an objective call of a
sweep applies, per call: the port's ``correction.pulse_rows`` counter
(lanes x pre-split rows of each call that launched the correction kernel's
pulse instance) and ``spectrum.pulse_ops`` (lanes x pulse sites of each
call's spectrum), summed over the request and over its ``llh`` calls; each
counter per call beside it.  From one more request served as the window
serves it (benchmark/harness/spans.py); nothing to read where the port has
no such counters.  Layer: the likelihood (engine/sweep_fused.py,
engine/likelihood.py)."""

from benchmark.harness.spans import named, runs

COUNTERS = ("correction.pulse_rows", "spectrum.pulse_ops")


def read(ctx):
    got = runs(ctx)
    if got is None:
        return None
    counters = [r["counters"] for r in got["records"] if "counters" in r]
    sums = {k: sum(c.get(k, 0) for c in counters) for k in COUNTERS}
    calls = len(named(got["records"], "llh"))
    if not calls or not any(any(k in c for k in COUNTERS) for c in counters):
        return None
    out = {"value": sum(sums.values()) / calls, "calls": calls}
    out.update({f"{k}_per_call": v / calls for k, v in sums.items()})
    return out
