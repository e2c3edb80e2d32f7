"""nm_host_us_per_iter.sweep: the optimiser's own host time of a Nelder-Mead
iteration in a sweep (each ``nm.iter`` span less its ``llh`` and
``nm.live_read``), us, and beside it the iteration's host read
(``live_read_us``, where the host waits for the card), from the port's
spans of one more request served as the window serves it
(benchmark/harness/spans.py).  Nothing to read where the port has no spans.
Layer: the optimiser (engine/optimize.py)."""

from benchmark.harness.spans import nm_host_us_per_iter, runs


def read(ctx):
    got = runs(ctx)
    return None if got is None else nm_host_us_per_iter(got)
