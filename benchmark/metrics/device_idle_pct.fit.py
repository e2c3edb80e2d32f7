"""device_idle_pct.fit: the share of one fit's wall, served as the window
serves it, in which no operation ran on the card; the busy time is the
profiled run's of the same fit, and nothing is read where the profiler
missed kernels.  Layer: the device (H100)."""

from benchmark.harness.profiling import idle_pct


def read(ctx):
    return idle_pct(ctx["trace"], ctx["plain"]["t1"] - ctx["plain"]["t0"])
