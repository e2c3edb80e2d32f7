"""nm_iters_per_fit: the mean of ``SolveResult.nit`` over the window's fits.
Layer: the optimiser (engine/optimize.py)."""


def read(ctx):
    nit = [r["nit"] for r in ctx["records"]]
    return sum(nit) / len(nit) if nit else None
