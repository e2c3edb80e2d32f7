"""Benchmark: batched likelihood evaluations per second on the GPU.

    python -m misti_tpu_torch.bench

The workload of the JAX package's ``bench.py``: one corrected likelihood
(cpfit) over 64 merged time intervals, split at 28, one optimised migration
band, evaluated for a batch of 4096 migration-rate candidates.
``MISTI_BENCH_MODE`` = ``ect`` takes the expected-coalescence-time residual
(upstream's default), ``trueeps`` skips the correction; ``MISTI_BENCH_BATCH``
and ``MISTI_BENCH_REPS`` set the batch and the timed repetitions.

Prints ONE json line: {"metric", "value", "unit", "vs_baseline", "device"}.
There is no fallback: without a card, or if the kernel fails, it raises.
Where a sweep's or a fit's time goes is read by ``benchmark/run.py --trace 1``
and by the sweep CLI's ``--profile``.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

BASELINE_EVALS_PER_S = 5.7  # the reference, one CPU core (BASELINE.md)
N_INTERVALS = 64
SPLIT = 28


def bench_spec(mode: str = ""):
    """The bench workload's ModelSpec; ``mode`` is '', 'ect' or 'trueeps'."""
    from .engine.spec import build_spec

    rng = np.random.default_rng(11)
    grid = 0.008 * (1.06 ** np.arange(N_INTERVALS)) - 0.008
    times = list(np.diff(grid))
    tt = np.cumsum([0.0] + times)
    lams = np.stack(
        [1.0 + 0.5 * np.sin(tt * 12.0) * np.exp(-tt * 3),
         1.1 + 0.4 * np.cos(tt * 9.0) * np.exp(-tt * 2)], axis=1)
    sfs = [0.0, *rng.integers(200, 6000, size=7).astype(float)]
    return build_spec(
        times, [list(v) for v in lams], sfs, SPLIT,
        [[1, 2, SPLIT, 0.3, 1]], [], unfolded=True, cpfit=mode != "ect",
        smooth=False, correct=mode != "trueeps")


def bench_params(batch: int, device, dtype) -> torch.Tensor:
    """The candidate migration rates, (batch, 1)."""
    return torch.linspace(0.05, 1.2, batch, dtype=torch.float64)[:, None].to(
        device=device, dtype=dtype)


def metric_name(mode: str) -> str:
    return {"trueeps": "llh_evals_per_s_64int_trueeps",
            "ect": "llh_evals_per_s_64int_ect"}.get(mode, "llh_evals_per_s_64int_corrected")


def main() -> int:
    from .engine.likelihood import build_likelihood

    mode = os.environ.get("MISTI_BENCH_MODE", "")
    batch = int(os.environ.get("MISTI_BENCH_BATCH", "4096"))
    reps = int(os.environ.get("MISTI_BENCH_REPS", "60"))
    lik = build_likelihood(bench_spec(mode))  # CUDA, float64; raises without a card
    params = bench_params(batch, lik.device, lik.dtype)

    out = lik.llh_batch(params)  # builds and loads the kernel
    torch.cuda.synchronize()
    n_ok = int(torch.isfinite(out).sum())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = lik.llh_batch(params)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0

    evals_per_s = batch * reps / dt
    print(json.dumps({
        "metric": metric_name(mode),
        "value": round(evals_per_s, 2),
        "unit": "evals/s",
        "vs_baseline": round(evals_per_s / BASELINE_EVALS_PER_S, 2),
        "device": torch.cuda.get_device_name(lik.device),
    }))
    print(f"# batch={batch} reps={reps} time={dt:.3f}s finite={n_ok}/{batch}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
