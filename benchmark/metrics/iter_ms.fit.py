"""iter_ms.fit: the fits' wall inside ``solve`` over their Nelder-Mead
iterations (``SolveResult.nit``, one objective call each), ms.
Layer: the optimiser (engine/optimize.py)."""


def read(ctx):
    nit = sum(r["nit"] for r in ctx["records"])
    return 1e3 * sum(r["solve_s"] for r in ctx["records"]) / nit if nit else None
