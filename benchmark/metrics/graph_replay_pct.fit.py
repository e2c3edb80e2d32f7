"""graph_replay_pct.fit: the share of a fit's objective calls that a CUDA
graph replay served, %: the port's ``llh.graph_replays`` counter over its
``llh`` spans, summed over the request; the captures
(``llh.graph_captures``) and the calls beside it.  From one more request
served as the window serves it (benchmark/harness/spans.py); nothing to
read where the port has no such counter.  Layer: the likelihood
(engine/sweep_fused.py, engine/likelihood.py)."""

from benchmark.harness.spans import named, runs


def read(ctx):
    got = runs(ctx)
    if got is None:
        return None
    counters = [r["counters"] for r in got["records"] if "counters" in r]
    calls = len(named(got["records"], "llh"))
    if not calls or not any("llh.graph_replays" in c for c in counters):
        return None
    replays = sum(c.get("llh.graph_replays", 0) for c in counters)
    return {"value": 100 * replays / calls, "calls": calls, "replays": replays,
            "captures": sum(c.get("llh.graph_captures", 0) for c in counters)}
