"""launches_per_call.fit: the CUDA launches of one profiled fit
(``build_spec``, ``build_likelihood`` and ``solve``) over its objective
calls (``SolveResult.nit``).  Layer: the likelihood (engine/likelihood.py)."""


def read(ctx):
    calls = ctx["profiled"]["nit"]
    return ctx["trace"].launches / calls if calls and ctx["trace"].launches else None
