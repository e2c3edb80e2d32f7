"""host_us_per_call.fit: the host time of an objective call in a fit
(``llh`` span), us, and beside it the same by stage (``llh.lanes``,
``llh.correct``, ``llh.post_split``, ``llh.spectrum``,
``llh.multinomial``), the hand kernels' launches per call and the part of
the request no layer span covers, from the port's spans of one more request
served as the window serves it (benchmark/harness/spans.py).  Nothing to
read where the port has no spans.  Layer: the likelihood
(engine/sweep_fused.py, engine/likelihood.py)."""

from benchmark.harness.spans import host_us_per_call, runs


def read(ctx):
    got = runs(ctx)
    return None if got is None else host_us_per_call(got)
