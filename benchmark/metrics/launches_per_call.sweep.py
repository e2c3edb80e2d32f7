"""launches_per_call.sweep: the CUDA launches of one profiled sweep (the
runtime's launch calls in torch.profiler's trace) over its objective calls.
Layer: the likelihood (engine/sweep_fused.py, engine/likelihood.py)."""


def read(ctx):
    calls = ctx["profiled"]["calls"]
    return ctx["trace"].launches / calls if calls and ctx["trace"].launches else None
