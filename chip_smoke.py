#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (misti_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build the CUDA kernels (one nvcc per library, all started together) and
     print each template instance's registers, spill bytes and resident
     blocks per SM (an ``attrs`` line each; a float32 spill fails);
  2. each kernel variant against its plain torch version on the card, in
     float64 and float32, at s = 28 intervals and 512 lanes;
  3. the main path at full size -- the bench workload (64 intervals, split
     28, one band, 4096 candidates) through ``build_likelihood(...).llh_batch``
     for cpfit, ECT and trueEPS -- with launch counts, timings and the
     float32 run held against the port's own float64 run on the card;
  4. real inputs (tests/fixtures/sweep*.psmc, sweep.jsfs) through the port's
     readers and ``build_spec`` with smoothing on;
  5. float32 ``torch.log`` against float64 on the card.
Prints a ``kernels`` JSON line, the card's name and power limit, and as the
last line ``{"ok": true, "device": {...}}``.  Exits nonzero without a card.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
KERNEL_S, KERNEL_B = 28, 512
MAIN_BATCH = 4096
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS = {"float32": 67e12, "float64": 34e12}  # non-tensor-core FP rates, H100 SXM
SOURCE = "misti_tpu_torch/kernels/csrc/correction_sweep.cu"
REPLACES = "misti_tpu/kernels/correction_pallas.py:798"


def log(*a):
    print(*a, flush=True)


def require(ok, msg):
    """A failed check ends the run (an exception: not dropped under -O)."""
    if not ok:
        raise RuntimeError(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (after one warm-up)."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_close(name, got, want, rtol, atol):
    """Finite entries within atol + rtol*|want|; NaN and +-inf masks equal.
    Returns the max abs error over finite entries."""
    import torch

    require(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    require(torch.equal(torch.isnan(got), torch.isnan(want)), f"{name}: NaN masks differ")
    require(torch.equal(torch.isposinf(got), torch.isposinf(want)), f"{name}: +inf masks differ")
    require(torch.equal(torch.isneginf(got), torch.isneginf(want)), f"{name}: -inf masks differ")
    fin = torch.isfinite(want)
    err = (got[fin] - want[fin]).abs()
    excess = err - (atol + rtol * want[fin].abs())
    worst = float(excess.max()) if err.numel() else -1.0
    require(worst <= 0, f"{name}: exceeds rtol={rtol} atol={atol} by {worst:.3e}")
    return float(err.max()) if err.numel() else 0.0


def lanes_off(got, want, rel=1e-6) -> int:
    """Lanes whose lc differs from the plain version's by more than ``rel``
    relative in some interval (where an LM accept flipped near a tie)."""
    fin = want[:2].isfinite()
    off = ((got[:2] - want[:2]).abs() > rel * want[:2].abs()) & fin
    return int(off.any(0).any(0).sum())


def kernel_inputs(rng, s, B, *, mig, pulse, per_lane, dtype, device):
    """(7, s, B) sweep input on the bench workload's grid: T, lh from the
    first s intervals; per-lane migration rates (1 in 8 lanes without);
    optional pulses; optional per-lane tables with T == 0 padding rows."""
    import torch

    grid = 0.008 * (1.06 ** np.arange(64)) - 0.008
    times = np.diff(grid)[:s]
    tt = np.cumsum([0.0] + list(np.diff(grid)))[:s]
    lh0 = 1.0 + 0.5 * np.sin(tt * 12.0) * np.exp(-tt * 3)
    lh1 = 1.1 + 0.4 * np.cos(tt * 9.0) * np.exp(-tt * 2)
    T = np.repeat(times[:, None], B, 1)
    L0 = np.repeat(lh0[:, None], B, 1)
    L1 = np.repeat(lh1[:, None], B, 1)
    if per_lane:
        L0 = L0 * rng.uniform(0.8, 1.25, (1, B))
        L1 = L1 * rng.uniform(0.8, 1.25, (1, B))
        for b in range(B):
            pad = b % 5
            if pad:
                T[s - pad:, b] = 0.0
    M0 = np.zeros((s, B))
    M1 = np.zeros((s, B))
    if mig:
        M0[2:] = rng.uniform(0.05, 1.2, (1, B))
        M0[:, ::8] = 0.0
        M1[10:20, 1::2] = rng.uniform(0.0, 0.5, (1, B // 2))
    P0 = np.zeros((s, B))
    P1 = np.zeros((s, B))
    if pulse:
        P1[4] = rng.uniform(0.0, 0.3, B)
        P0[12] = rng.uniform(0.0, 0.2, B)
    inp = np.stack([T, L0, L1, M0, M1, P0, P1])
    return torch.tensor(inp, dtype=dtype, device=device).contiguous()


def phase_attrs(cf, torch):
    """Registers, spill bytes and resident blocks per SM of every template
    instance at s = 28 (misti_correction_sweep_attrs), one line each; no
    float32 instance may spill."""
    for dtype in (torch.float32, torch.float64):
        for cpfit in (True, False):
            lib = f"correction_sweep_{str(dtype)[6:]}_{'cpfit' if cpfit else 'ect'}"
            for a in cf.kernel_attrs(dtype, cpfit, KERNEL_S):
                log("attrs " + json.dumps({"library": lib, "s": KERNEL_S, **a}))
                require(dtype == torch.float64 or a["local_bytes"] == 0,
                        f"{lib} {a}: a float32 instance uses local memory")


def phase_kernels(cf, torch, dev):
    """Every variant of the sweep kernel against its plain version."""
    rng = np.random.default_rng(SEED)
    variants = []
    for cpfit in (True, False):
        for snm in (False, True):
            for pulse in (False, True):
                variants.append(dict(cpfit=cpfit, static_no_mig=snm, has_pulse=pulse,
                                     mig=not snm, per_lane=False))
        variants.append(dict(cpfit=cpfit, static_no_mig=False, has_pulse=True,
                             mig=True, per_lane=True))
    before = cf.correction_sweep.launches
    n = 0
    for v in variants:
        seed_state = rng.bit_generator.state
        for dtype, rtol, atol in ((torch.float64, 1e-6, 1e-9), (torch.float32, 1e-4, 1e-6)):
            rng.bit_generator.state = seed_state  # same draws for both dtypes
            inp = kernel_inputs(rng, KERNEL_S, KERNEL_B, mig=v["mig"], pulse=v["has_pulse"],
                                per_lane=v["per_lane"], dtype=dtype, device=dev)
            opts = dict(cpfit=v["cpfit"], static_no_mig=v["static_no_mig"],
                        has_pulse=v["has_pulse"])
            got = cf.correction_sweep(inp, **opts)
            torch.cuda.synchronize()
            n += 1
            want = cf.correction_sweep_plain(inp, **opts)
            tag = (f"{'cpfit' if v['cpfit'] else 'ect'} snm={int(v['static_no_mig'])} "
                   f"pulse={int(v['has_pulse'])} per_lane={int(v['per_lane'])} "
                   f"{str(dtype)[6:]}")
            e_lc = check_close(tag + " lc", got[:2], want[:2], rtol, atol)
            e_pa = check_close(tag + " p_after", got[2:], want[2:], rtol, atol)
            finite = float(torch.isfinite(got[:2]).float().mean())
            log(f"kernel-vs-plain {tag}: max|dlc|={e_lc:.3e} max|dp|={e_pa:.3e} "
                f"lanes with lc off by > 1e-6 rel {lanes_off(got, want)}/{KERNEL_B} "
                f"finite lc {finite:.3f} (rtol {rtol:g} atol {atol:g})")
    moved = cf.correction_sweep.launches - before
    require(moved == n, f"launch counter moved {moved}, expected {n}")
    log(f"kernel-vs-plain: {n} comparisons passed, launch counter +{moved}")


def phase_main_path(cf, torch, dev, bench):
    """The bench workload through llh_batch; returns per-kernel records."""
    from misti_tpu_torch import build_likelihood

    batch = MAIN_BATCH
    records = {}
    for mode in ("", "ect", "trueeps"):
        name = bench.metric_name(mode)
        spec = bench.bench_spec(mode)
        lik = build_likelihood(spec, device=dev, dtype=torch.float32)
        params = bench.bench_params(batch, dev, lik.dtype)
        out = lik.llh_batch(params)  # warm-up
        torch.cuda.synchronize()
        reps = 3
        cf.correction_sweep.launches = 0
        t0 = time.perf_counter()
        for _ in range(reps):
            out = lik.llh_batch(params)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = cf.correction_sweep.launches
        evals = batch * reps / dt
        lik64 = build_likelihood(spec, device=dev, dtype=torch.float64)
        out64 = lik64.llh_batch(bench.bench_params(batch, dev, torch.float64))
        fin32, fin64 = torch.isfinite(out), torch.isfinite(out64)
        require(torch.equal(fin32, fin64), f"{name}: -inf masks differ f32 vs f64")
        require(int(fin64.sum()) > 0, f"{name}: no finite llh")
        rel = float(((out.double() - out64).abs() / out64.abs())[fin64].max())
        require(rel <= 1e-5, f"{name}: max rel dllh {rel:.3e} > 1e-5")
        am32 = int(torch.argmax(torch.where(fin32, out.double(), -math.inf)))
        am64 = int(torch.argmax(torch.where(fin64, out64, -math.inf)))
        require(am32 == am64, f"{name}: argmax {am32} (f32) != {am64} (f64)")

        mi, pu = lik.map_params(params)
        lc, _, _ = lik.correct(mi, pu)
        spec_ms = cuda_ms(lambda: lik.spectrum(lc, mi, pu), 3)
        corr_ms = cuda_ms(lambda: lik.correct(mi, pu), 3)
        line = (f"main path {name}: {evals:.1f} evals/s (batch {batch}, {reps} reps, "
                f"{dt / reps * 1e3:.2f} ms/llh_batch), f32 vs f64 max rel dllh {rel:.3e}, "
                f"finite {int(fin32.sum())}/{batch}, argmax {am32}, correction {corr_ms:.3f} ms, "
                f"spectrum {spec_ms:.3f} ms, sweep launches {launches}")
        if spec.correct:
            require(launches == reps, f"{name}: sweep kernel launched {launches} times in {reps} batches")
            s = spec.splitT
            inp = cf.sweep_inputs(mi[:, :s], pu[:, :s], *lik.sweep_tables)
            opts = lik.sweep_opts
            k_ms = cuda_ms(lambda: cf.correction_sweep(inp, **opts), 5)
            p_ms = cuda_ms(lambda: cf.correction_sweep_plain(inp, **opts), 1)
            err = check_close(name + " sweep", cf.correction_sweep(inp, **opts),
                              cf.correction_sweep_plain(inp, **opts), 1e-4, 1e-6)
            work = cf.sweep_work(inp, **opts)
            ops = cf.sweep_ops(work, s, batch, **opts)
            nbytes = 15 * s * batch * inp.element_size()
            t_ops, t_bytes = ops / PEAK_OPS["float32"], nbytes / HBM_BYTES_PER_S
            records[name] = {
                "name": "correction_sweep_" + ("cpfit" if spec.cpfit else "ect"),
                "route": "cuda", "source": SOURCE, "replaces": REPLACES,
                "launches": launches, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": max(t_ops, t_bytes) * 1e3,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": None,
            }
            records[name]["share_of_bound"] = records[name]["bound_ms"] / k_ms
            line += (f"; kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms, bound "
                     f"{records[name]['bound_ms']:.5f} ms ({ops:.3e} ops, {nbytes} bytes), "
                     f"work {json.dumps(work)}")
        log(line)
    return [records[k] for k in sorted(records)]


def phase_real_inputs(torch, dev):
    """The sweep fixtures through the port's readers and build_spec."""
    from misti_tpu_torch import build_likelihood, build_spec
    from misti_tpu_torch.io import jsfs as io_jsfs
    from misti_tpu_torch.io import psmc as io_psmc

    fix = os.path.join(HERE, "tests", "fixtures")
    data = io_psmc.read_psmc(os.path.join(fix, "sweep1.psmc"),
                             os.path.join(fix, "sweep2.psmc"), 0, -1)
    sfs = list(io_jsfs.read_jafs(os.path.join(fix, "sweep.jsfs")).summed())
    split = 24
    spec = build_spec(data.times, data.lambdas, sfs, split, [[1, 4, split, 3.0, 1]], [],
                      smooth=True, unfolded=True, sample_date=data.sample_date_discr,
                      thrh=(data.theta, data.rho))
    params = torch.linspace(0.05, 6.0, 1024, dtype=torch.float64)[:, None]
    out32 = build_likelihood(spec, device=dev, dtype=torch.float32).llh_batch(
        params.float().to(dev))
    out64 = build_likelihood(spec, device=dev, dtype=torch.float64).llh_batch(params.to(dev))
    fin64 = torch.isfinite(out64)
    require(int(fin64.sum()) > 0, "real inputs: no finite f64 llh")
    require(bool(torch.isfinite(out32)[fin64].all()), "real inputs: f32 not finite where f64 is")
    rel = float(((out32.double() - out64).abs() / out64.abs())[fin64].max())
    log(f"real inputs (sweep fixtures, split {split}, ECT, smoothing): "
        f"{int(fin64.sum())}/1024 finite, f32 vs f64 max rel dllh {rel:.3e}")


def phase_log(torch, dev):
    """float32 torch.log within 4 ulp of the float64 log on the card."""
    x64 = np.concatenate([np.logspace(-6, 6, 4001), np.linspace(0.03, 0.3, 1000)])
    x = x64.astype(np.float32)
    got = torch.log(torch.tensor(x, device=dev)).cpu().numpy().astype(np.float64)
    ref = np.log(x.astype(np.float64))
    ulp = np.abs(got - ref) / np.spacing(np.abs(ref).astype(np.float32))
    require(ulp.max() < 4.0, f"float32 log error {ulp.max()} ulp")
    log(f"float32 torch.log on the card: max {ulp.max():.3f} ulp over {x.size} inputs")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from misti_tpu_torch import bench
    from misti_tpu_torch.kernels import correction_fused as cf

    dev = torch.device("cuda", 0)
    gpu = gpu_line()
    log(f"gpu: {gpu}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    report = cf.build(force=True)
    log(f"build: {time.perf_counter() - t0:.1f} s wall for {len(report)} libraries")
    for lib, (secs, ptxas, _) in sorted(report.items()):
        lines = [ln.strip() for ln in ptxas.splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        log(f"  {lib}: {secs:.1f} s")
        for ln in lines:
            log(f"    {ln}")

    phase_attrs(cf, torch)
    phase_kernels(cf, torch, dev)
    kernels = phase_main_path(cf, torch, dev, bench)
    phase_real_inputs(torch, dev)
    phase_log(torch, dev)

    log("kernels " + json.dumps({"kernels": kernels}))
    log(json.dumps({"kernels": kernels}))
    log(gpu)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
