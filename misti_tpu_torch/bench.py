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
With ``--profile`` it also writes where one ``llh_batch`` spends its time to
stderr: the device busy share, the stages (CUDA events) and the top ops by
device time (torch.profiler).
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


def profile(lik, params, reps: int = 10) -> None:
    """Stage times and the device's busy share for one llh_batch.

    The work is launch-bound on the host, so stages are timed on the host
    clock around ``reps`` calls ending in a synchronize; the busy share is
    the kernels' device time (torch.profiler, device events only) over the
    unprofiled wall time of one ``llh_batch``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from .engine.likelihood import SpectrumBasis
    from .kernels.correction_fused import correction_sweep, sweep_inputs
    from .kernels.expm import expm_action_pair

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    s = lik.spec.splitT
    mi, pu = lik.map_params(params)
    lc, _, _ = lik.correct(mi, pu)
    basis = SpectrumBasis(lik.device, lc.dtype)
    t = s // 2  # one pre-split interval of the spectrum: the 44-state action
    coeffs = torch.cat([lc[:, t], mi[:, t]], dim=-1)
    p0 = torch.zeros((params.shape[0], 44), dtype=lc.dtype, device=lik.device)
    p0[:, 2] = 1.0
    stages = {
        "llh_batch": ms(lambda: lik.llh_batch(params)),
        "map_params": ms(lambda: lik.map_params(params)),
        "correct": ms(lambda: lik.correct(mi, pu)),
        "spectrum": ms(lambda: lik.spectrum(lc, mi, pu)),
        f"expm_action_pair (44 states, interval {t})": ms(
            lambda: expm_action_pair(basis.sp2, coeffs, basis.norms2, float(lik.spec.times[t]),
                                     p0)),
    }
    if lik.spec.correct and s:
        inp = sweep_inputs(mi[:, :s], pu[:, :s], *lik.sweep_tables)
        stages["correction_sweep kernel"] = ms(lambda: correction_sweep(inp, **lik.sweep_opts))
    for k, v in stages.items():
        print(f"# stage {k}: {v:.3f} ms (host clock, {reps} reps)", file=sys.stderr)

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        lik.llh_batch(params)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    wall = stages["llh_batch"]
    print(f"# llh_batch: device busy {busy:.3f} ms of {wall:.3f} ms wall "
          f"({100 * busy / wall:.1f}% busy, {100 * (1 - busy / wall):.1f}% idle), "
          f"{sum(e.count for e in kernels)} kernel launches", file=sys.stderr)
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]:
        print(f"#   {e.key[:70]:70s} {e.self_device_time_total / 1e3:8.3f} ms "
              f"{e.count:6d} launches", file=sys.stderr)


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
    if "--profile" in sys.argv[1:]:
        profile(lik, params)
    return 0


if __name__ == "__main__":
    sys.exit(main())
