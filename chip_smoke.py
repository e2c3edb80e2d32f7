#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (misti_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build the CUDA kernels (one nvcc per library, all started together) and
     print each template instance's registers, spill bytes and resident
     blocks per SM (an ``attrs`` line each, the post-split fit's ECT kernel
     at every G threads a solve and its cpfit kernel too, with resident
     clusters; a spill in a float32 instance of the correction sweep, in
     ``expm_action`` or in either ``post_fit`` kernel fails);
  2. each variant of the correction sweep against its plain torch version
     on the card, in float64 and float32, at s = 28 intervals and 512
     lanes; ``row_matmul`` (float64 only) at each of the spectrum's products
     and ``expm_action`` (float64 only) at both of the spectrum's bases
     (per-lane interval lengths with zeros, runaway lanes, a NaN in a p0 at
     t == 0), and ``post_fit`` (the post-split fit, float64 only) in both
     residual modes with shared and per-lane tables (T == 0 rows, rates on
     both sides of the raw-rate guard at 100, x = lam T around 1/4, a NaN
     lane; and a per-lane case of 200 intervals, two a warp), at every G
     threads a solve bitwise the same, with every prefix of SUB_WIDTHS
     lanes bitwise what it is in the whole batch, and float32 operands
     refused;
  3. the main path at full size -- the bench workload (64 intervals, split
     28, one band, 4096 candidates) through ``build_likelihood(...).llh_batch``
     for cpfit, ECT and trueEPS -- with launch counts, timings, and the
     float32 run (float32 parameters, a float64 likelihood) bitwise equal to
     the float64 run on the same parameters, its llh in LLH_DTYPE;
  4. real inputs (tests/fixtures/sweep*.psmc, sweep.jsfs) through the port's
     readers and ``build_spec`` with smoothing on;
  5. float32 ``torch.log`` against float64 on the card;
  6. the sweep path: upstream's north-star bootstrap x split-time sweep
     (tests/fixtures/sweep*.psmc + sweep.jsfs, ``--splits 20 27 -bs 100
     -mi 1 4 ST 3 1 -uf``, bootstrap seed 0) through
     ``misti_tpu_torch.engine.bootstrap.sweep`` in the run's default dtype
     (float64), cpfit with ``--maxiter 256`` and ECT, each held against the
     JAX package's float64 CPU table of the same command
     (scripts/sweep1band_f64_cpu_cap256.npz, scripts/sweep_ect_f64_cpu.npz,
     made by scripts/jax_f64_reference.py; its float32 TPU tables
     scripts/sweep1band_r05_cap256.npz and sweep_ect_r05.npz compared on an
     info line), with the
     kernels timed at the sweep's first-stage width, no cell left
     unconverged, that iteration's lanes bitwise the same alone, in
     sub-batches and in the whole batch, and a small staged-vs-uninterrupted
     ECT sweep, bitwise;
  7. the single-fit path in float64 through the port's CLIs
     (``misti_tpu_torch.cli.misti`` / ``cli.testmodel`` ``main``, default
     platform): upstream's fits of tests/test_cli.py against its .mi files
     and --debug golden, the north-star command at split 24 (cpfit, ECT, and
     cpfit with one optimised pulse) against the JAX package's CPU float64
     fits (tests/fixtures/torch_single_fit_ref.json) with per-fit timings,
     launches per objective call and the kernels at that instance, and the
     testmodel README oracle;
  8. the sharded sweep: phase 6's cpfit sweep through the sweep CLI as
     SHARDED_RANKS ranks of ``python -m torch.distributed.run`` on the one
     card, in the default dtype, held to phase 6's gates against the same
     table and compared with
     phase 6's one-process table (cells bitwise equal, max |dllh|, both
     walls, each rank's objective calls and kernel launches) on the spectra
     the ranks wrote, and the per-lane kernel at a rank's stage-1 width
     (404 cells x 6 = 2424 lanes) against its plain version;
  9. the --scenarios path: two scenarios of the 16-scenario matrix
     (MATRIX_SCENARIOS: two bands, and no migration) resident in one process
     through ``sweep_many`` at full width, ``--maxiter`` MATRIX_MAXITER, in
     the default dtype, with the no-migration scenario's argmax histogram
     held to the JAX package's float64 matrix reference
     (MATRIX_jax_f64_cpu.json) and the kernels at the two-band scenario's
     first-stage width.
Every path requires each of its kernels (the correction sweep, ``row_matmul``,
``expm_action``, ``post_fit``) to have launched, the post-split fit exactly
once per objective call, and prints their launches per objective call;
phases 3, 6, 7 and 9 hold ``post_fit`` against its plain version on the
real inputs of one objective call and record that instance, at every G
bitwise the same (and, where G > 1, timed at G = 1 beside it), with its
launch shape (G, blocks, clusters, waves) and, in ECT, `warp_branch_mix`
under the PR 9 kernel's thread mapping and the lane-major one (phase 6
also prints the CUDA launches of one objective call as torch.profiler
sees them).  Each kernel record carries ``ms``
(CUDA events around back-to-back calls), ``device_ms`` (the kernels' own
device time per call, from torch.profiler, or from CUDA events behind a
spin kernel on both sides of the record where the profiler's launch count
fails) and ``host_us`` (the wrapper's host time per call, no
synchronise), and the library call's
``library_ms``, ``library_device_ms`` and ``library_host_us`` where there
is one.  Prints each phase's wall, a
``kernels`` JSON line, the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``.  Exits nonzero without a card.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import signal
import subprocess
import sys
import tempfile
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
# row_matmul stands for the JAX package's spectrum matvec, an XLA dot (no
# pallas_call): on the card it keeps a lane's value independent of its batch
RM_SOURCE = "misti_tpu_torch/kernels/csrc/row_matmul.cu"
RM_REPLACES = "misti_tpu/kernels/expm.py:277"
# expm_action stands for the JAX package's spectrum sub-step loop (an XLA
# while loop of matvecs, no pallas_call): one launch per interval
EA_SOURCE = "misti_tpu_torch/kernels/csrc/expm_action.cu"
EA_REPLACES = "misti_tpu/kernels/expm.py:235"
# post_fit stands for the JAX package's post-split stage (plain XLA inside
# its compiled likelihood, no pallas_call): one launch per objective call
PF_SOURCE = "misti_tpu_torch/kernels/csrc/post_fit.cu"
PF_REPLACES = "misti_tpu/engine/likelihood.py:328"
# widths at which a lane's value must be bitwise what it is in the whole batch
SUB_WIDTHS = (1, 6, 42, 960)
# one-call profiles that count a library call's kernel launches per call
SINGLE_PROFILES = 5
# per-lane table cases of phase 2: the sweep path's s_max and its narrowest
# and widest kernel batches (odd widths: not multiples of a block's 8 lanes)
PER_LANE_S, PER_LANE_B = 27, (6, 4851)
# phase 2's post_fit case past 144 intervals (two intervals a warp): (B, per lane, n)
POST_FIT_WIDE = (45, True, 200)
# the north-star sweep of phase 6 (upstream's test.bs bootstrap-CI command)
SWEEP_SPLITS = [float(v) for v in range(20, 28)]
SWEEP_MI = [["1", "4", "ST", "3", "1"]]
SWEEP_REPLICATES = 100
STAGED_MAXITER = 64  # the iteration budget of phase 6's staged-vs-uninterrupted check
SHARDED_RANKS = 2  # phase 8: processes of the sharded sweep, all on the one card
SHARDED_TIMEOUT_S = 420
# phase 9: two scenarios of the matrix through sweep_many (two bands; none)
MATRIX_SCENARIOS = ("pair3.mi2", "pair2.no.mig")
MATRIX_MAXITER = 32
# the matrix's float64 reference (scripts/jax_f64_reference.py) and the
# JAX package's float32 TPU table, which phase 9 only prints
MATRIX_REFERENCE = "MATRIX_jax_f64_cpu.json"
MATRIX_OLD_TABLE = "MATRIXBENCH_r05.json"
SWEEP_RUNS = (  # (mode, spec flags, --maxiter, the JAX package's float64 CPU table,
    #              its float32 TPU table of the same command: printed, not gated)
    ("cpfit", dict(cpfit=True), 256, "scripts/sweep1band_f64_cpu_cap256.npz",
     "scripts/sweep1band_r05_cap256.npz"),
    ("ect", dict(cpfit=False), 1000, "scripts/sweep_ect_f64_cpu.npz",
     "scripts/sweep_ect_r05.npz"),
)
# the single-fit path of phase 7: tests/test_cli.py's commands on the synth
# fixtures (after the three input files; default platform, i.e. the card),
# each with upstream's .mi, and its --debug golden
_UNITS = ["--funits", "/nonexistent"]
UPSTREAM_FITS = (
    ("ref_fit", ["8", "-uf", "-mi", "1", "2", "8", "0.3", "1", "-bs", "0"] + _UNITS,
     "ref_fit.mi"),
    ("ref_fit_pu", ["8", "-uf", "-pu", "2", "4", "0.2", "1", "-pu", "1", "6", "0.1", "0",
                    "--cpfit", "-bs", "0"] + _UNITS, "ref_fit_pu.mi"),
    ("ref_fit_sdate", ["8", "-uf", "--sdate", "80", "-mi", "1", "4", "8", "0.3", "1", "-bs",
                       "0"] + _UNITS, "ref_fit_sdate.mi"),
)
DEBUG_ARGS = ["8", "-uf", "-mi", "1", "2", "8", "0.3", "0", "-bs", "0", "--debug"] + _UNITS
# the JAX package's CPU float64 fits of the north-star command at split 24
# (scripts/make_torch_single_fit_ref.py)
SINGLE_FIT_REF = "tests/fixtures/torch_single_fit_ref.json"
README_MS = ("-n 1 10 -n 2 4.5 -eN 0.025 0.2 -ej 0.045 2 1 -eN 0.175 3 "
             "-eN 0.625 1.8 -eN 3 3.2 -eN 8 5.5")
README_LLH = -5.6330938966336905
README_JSFS = [0.229988, 0.082942, 0.228294, 0.131016, 0.121698, 0.083215, 0.122846]


def log(*a):
    print(*a, flush=True)


def parse_fit_stdout(lines) -> dict:
    """The numbers of a single-fit CLI run's stdout (either package's):
    the estimate line's parameters and llh, the solver summary's iterations
    and evaluations, and the Report() counters (which include the -bs 0
    re-evaluation)."""

    def grab(prefix):
        hits = [ln for ln in lines if ln.startswith(prefix)]
        require(len(hits) == 1, f"expected one line starting {prefix!r}, got {len(hits)}")
        return hits[0]

    est = grab("bs_id =")
    m = re.search(r"optim = \[(.*?)\]", est)
    return {
        "x": [float(v) for v in m.group(1).split(", ")] if m else [],
        "llh": float(est.rsplit("llh =", 1)[1]),
        "converged": any(ln == "Optimization terminated successfully." for ln in lines),
        "nit": int(grab("         Iterations:").split()[-1]),
        "nfev": int(grab("         Function evaluations:").split()[-1]),
        "calls": int(grab("Total number of likelihood function calls is").split()[-1]),
        "corr_called": int(grab("Lambda correction called").split()[-2]),
        "corr_failed": int(grab("Lambda correction failed").split()[-2]),
    }


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


def _kernels_seen(fn, calls: int) -> dict:
    """{CUDA kernel name: (launches, device us)} that torch.profiler saw
    over ``calls`` calls of ``fn``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.count, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def host_us(fn, reps: int) -> float:
    """Host time per call of ``fn`` after one warm-up, with the host clock
    over ``reps`` enqueues and no synchronise: the median of 5 rounds (the
    host's times spread)."""
    import torch

    fn()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(5):
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        rounds.append((time.perf_counter() - t) / reps * 1e6)
        torch.cuda.synchronize()
    return float(np.median(rounds))


def profiled_ms(fn, reps: int, one_kernel: bool):
    """(device ms per call or None, what the profiler saw) of ``fn`` from
    torch.profiler's kernel events over ``reps`` calls.  On the H100 hosts
    this ran on, the profiler missed some kernels (from 1 in 10 to 8 in
    10, the most after phase 8's ranks), so each kernel's launches per call
    are counted apart from its time: 1 where the call launches
    ``one_kernel`` (a hand kernel's wrapper), else for each kernel name the
    most seen in any of SINGLE_PROFILES profiles of one call.  The time is
    then, summed over the names, the mean time of the launches of that
    name seen over the ``reps`` calls times its launches per call.  None
    where it saw under half of the launches so expected, missed a name, or
    saw more of a name than expected (a count from one call that fell
    short)."""
    seen = _kernels_seen(fn, reps)
    if one_kernel:
        per_call = {k: 1 for k in seen}
        ok = len(seen) <= 1
    else:
        per_call = {}
        for _ in range(SINGLE_PROFILES):
            for k, (c, _) in _kernels_seen(fn, 1).items():
                per_call[k] = max(per_call.get(k, 0), c)
        ok = all(seen.get(k, (0, 0))[0] <= c * reps for k, c in per_call.items())
    got = sum(c for c, _ in seen.values())
    want = sum(per_call.values()) * reps if per_call else reps
    how = f"saw {got} of {want} launches over {reps} calls"
    if not (ok and set(seen) == set(per_call) and 2 * got >= want):
        return None, how
    return sum(us / c * per_call[k] for k, (c, us) in seen.items()) / 1e3, how


def events_ms(fn, reps: int, enqueue_us: float) -> float:
    """Device ms per call of ``fn`` from CUDA events around ``reps`` calls
    queued behind a spin kernel, so that the device runs them back to back
    (the gaps between its kernels included)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e6 + 4e3 * enqueue_us * reps))  # ~1 ms plus twice the enqueue time
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_record(rec, kernel, reps: int, library=None, library_reps: int = 1):
    """``rec`` with the kernel's ``device_ms``, ``host_us`` and
    ``device_ms_by`` and, where a library call computes the same function,
    that call's ``library_device_ms``, ``library_host_us`` and
    ``library_device_ms_by``.  ``device_ms`` is `profiled_ms` (the kernel:
    one launch per call) on both sides, or `events_ms` on both sides where
    the profiler's count fails on either, so that one record never compares
    two methods.  (``ms`` times back-to-back calls with events and no queue
    ahead: for a kernel of a few microseconds that is the wrapper's host
    time.)"""
    sides = [("", kernel, reps, True)]
    if library is not None:
        sides.append(("library_", library, library_reps, False))
    hosts = [host_us(fn, r) for _, fn, r, _ in sides]
    prof = [profiled_ms(fn, r, one) for _, fn, r, one in sides]
    by_events = any(ms is None for ms, _ in prof)
    for (pre, fn, r, _), h, (ms, how) in zip(sides, hosts, prof):
        if by_events:
            ms, how = events_ms(fn, r, h), f"events ({how})"
        else:
            how = f"profiler ({how})"
        rec[pre + "device_ms"], rec[pre + "host_us"], rec[pre + "device_ms_by"] = ms, h, how
    if library is None:
        rec["library_device_ms"] = rec["library_host_us"] = rec["library_device_ms_by"] = None
    return rec


def tolerance(dtype):
    """(rtol, atol, peak FP rate) of a kernel instance of this dtype."""
    f64 = str(dtype) == "torch.float64"
    return (1e-6, 1e-9, PEAK_OPS["float64"]) if f64 else (1e-4, 1e-6, PEAK_OPS["float32"])


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


def same_bits(x, y) -> bool:
    """Bitwise equal: the same shape and NaN mask, and the same bits
    everywhere else (so -0 is not +0, nor inf the largest double)."""
    import torch

    if x.shape != y.shape or x.dtype != y.dtype:
        return False
    nan = x.isnan()
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]
    return torch.equal(nan, y.isnan()) and torch.equal(x.view(ints)[~nan], y.view(ints)[~nan])


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


def capture_row_matmul(fn, shape=(44, 8)):
    """Run ``fn()`` and return the arguments of its first ``row_matmul``
    product with a ``shape`` matrix (default the collapse map, once per
    likelihood call): that instance at a path's shapes and values."""
    from misti_tpu_torch.engine import likelihood as lk

    orig, seen = lk.row_matmul, []

    def rec(v, K, cs=None):
        if not seen and tuple(K.shape) == tuple(shape):
            seen.append((v, K, cs))
        return orig(v, K, cs)

    lk.row_matmul = rec
    try:
        fn()
    finally:
        lk.row_matmul = orig
    return seen[0]


def capture_expm_action(fn, n: int = 44, pick: int = 24):
    """Run ``fn()`` and return (args, kwargs) of its ``pick``-th spectrum
    interval (``expm_action_pair`` call) at ``n`` states, the last if there
    are fewer: the kernel's instance at a path's shapes and values."""
    from misti_tpu_torch.engine import likelihood as lk

    orig, seen, count = lk.expm_action_pair, [], [0]

    def rec(*a, **kw):
        if a[4].shape[-1] == n:
            if count[0] <= pick:
                seen[:] = [(a, kw)]
            count[0] += 1
        return orig(*a, **kw)

    lk.expm_action_pair = rec
    try:
        fn()
    finally:
        lk.expm_action_pair = orig
    return seen[0]


def expm_action_record(ea, torch, name, captured, launches):
    """``expm_action`` on one instance of a path: held against its plain
    version (the same sparse series in torch ops: rtol 1e-6 / atol 1e-9 in
    float64, NaN masks equal; whether bitwise is logged), each prefix of
    SUB_WIDTHS lanes bitwise equal to its rows of the whole batch, timed
    beside the plain version and one library call
    (``torch.linalg.matrix_exp`` of the (B, 2n, 2n) block generators
    [[M t, t I], [0, 0]], which hold e^{Mt} and N1), and held to its bound
    (`expm_action_ops`, the work the function needs, over the FP64 rate,
    `expm_action_bytes` over HBM)."""
    from misti_tpu_torch.kernels import expm as kexpm

    from misti_tpu_torch.engine.likelihood import SpectrumBasis

    a, kw = captured
    basis, coeffs, norms, t, p0 = a
    require(p0.dtype == torch.float64, f"{name}: expm_action runs in float64, not {p0.dtype}")
    rtol, atol = 1e-6, 1e-9
    B, n = p0.shape
    C = coeffs.shape[1]
    cm = kw.get("catmask")
    Q = kw["jsfs"].shape[1] if kw.get("jsfs") is not None else 0
    run = lambda: ea.expm_action(*a, **kw)  # noqa: E731
    plain = lambda: kexpm.expm_action_pair_plain(*a, **kw)  # noqa: E731
    got, want = run(), plain()
    errs = [check_close(f"{name} {o}", g, w, rtol, atol)
            for o, g, w in zip(("E p0", "N1 p0", "projection"), got, want) if g is not None]
    bitwise = all(same_bits(g, w) for g, w in zip(got, want) if g is not None)
    per_lane_t = t.numel() == B and B > 1
    for w in SUB_WIDTHS:
        if w < B:
            kw_w = dict(kw, catmask=cm[:w]) if cm is not None and cm.dim() == 2 else kw
            part = ea.expm_action(basis, coeffs[:w], norms, t[:w] if per_lane_t else t, p0[:w],
                                  **kw_w)
            require(all(same_bits(x, y[:w]) for x, y in zip(part, got) if x is not None),
                    f"{name}: the first {w} lanes differ from their rows of the {B}-lane batch")
    k_ms = cuda_ms(run, 20)
    p_ms = cuda_ms(plain, 3)
    tt = (t if per_lane_t else t.reshape(-1)[:1].expand(B)).to(p0.dtype)
    dense = SpectrumBasis(p0.device, p0.dtype)
    kmat = dense.k2 if n == dense.k2.shape[0] else dense.k1
    gen = torch.einsum("bc,kcm->bkm", coeffs * tt[:, None], kmat.view(n, C, n))
    aug = torch.zeros((B, 2 * n, 2 * n), dtype=p0.dtype, device=p0.device)
    aug[:, :n, :n] = gen
    aug[:, n:, :n] = tt[:, None, None] * torch.eye(n, dtype=p0.dtype, device=p0.device)
    library = lambda: torch.linalg.matrix_exp(aug)  # noqa: E731
    lib_ms = cuda_ms(library, 3)
    m, _ = kexpm.substep_counts(coeffs, norms, t)
    ops = ea.expm_action_ops(basis, coeffs, norms, t, Q=Q)
    nbytes = ea.expm_action_bytes(B, basis, itemsize=p0.element_size(), per_lane_t=per_lane_t,
                                  Q=Q, per_lane_catmask=cm is not None and cm.dim() == 2)
    t_ops = ops / PEAK_OPS["float64"]
    t_bytes = nbytes / HBM_BYTES_PER_S
    rec = {"name": name, "route": "cuda", "source": EA_SOURCE, "replaces": EA_REPLACES,
           "launches": launches, "max_abs_err": max(errs), "ms": k_ms, "plain_ms": p_ms,
           "bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": lib_ms}
    rec["share_of_bound"] = rec["bound_ms"] / k_ms
    timed_record(rec, run, 20, library, 3)
    log(f"{name} at B = {B}, n = {n}, C = {C}, {str(p0.dtype)[6:]}, sub-steps per lane "
        f"{int(m.min())}-{int(m.max())} (sum {int(m.sum())}), t == 0 on "
        f"{int((t == 0).sum()) if per_lane_t else int(bool((t == 0).all())) * B} lanes: "
        f"{k_ms:.4f} ms (device {rec['device_ms']:.4f} ms by {rec['device_ms_by']}, host "
        f"{rec['host_us']:.1f} us), the plain version {p_ms:.4f} ms, library {lib_ms:.4f} ms "
        f"(device {rec['library_device_ms']:.4f} ms by {rec['library_device_ms_by']}, host "
        f"{rec['library_host_us']:.1f} us), "
        f"bound {rec['bound_ms']:.5f} ms ({rec['bound_by']}; {ops:.3e} ops, {nbytes} bytes), "
        f"{rec['share_of_bound']:.1%} of bound ({rec['bound_ms'] / rec['device_ms']:.1%} of "
        f"device_ms), max|d| {max(errs):.3e}, bitwise equal to the plain version {bitwise}, "
        f"{launches} launches on the path; widths "
        f"{[w for w in SUB_WIDTHS if w < B]} bitwise as in the batch")
    return rec


def row_matmul_record(rm, torch, name, args, launches):
    """``row_matmul`` (float64) on one instance of a path: held against its
    plain version (rtol 1e-6 / atol 1e-9), each prefix of SUB_WIDTHS lanes
    bitwise equal to its rows of the whole batch, timed beside the plain
    version and one library call (``torch.matmul`` without weights,
    ``torch.einsum`` with them) and held to its bound."""
    v, K, cs = args
    got, want = rm.row_matmul(v, K, cs), rm.row_matmul_plain(v, K, cs)
    err = check_close(name, got, want, 1e-6, 1e-9)
    B, n = v.shape
    C = 1 if cs is None else cs.shape[1]
    m = K.shape[1] // C
    for w in SUB_WIDTHS:
        if w < B:
            part = rm.row_matmul(v[:w], K, None if cs is None else cs[:w])
            require(torch.equal(part, got[:w]), f"{name}: the first {w} lanes differ from "
                                                f"their rows of the {B}-lane batch")
    kernel = lambda: rm.row_matmul(v, K, cs)  # noqa: E731
    k_ms = cuda_ms(kernel, 50)
    p_ms = cuda_ms(lambda: rm.row_matmul_plain(v, K, cs), 50)
    if cs is None:
        library = lambda: torch.matmul(v, K)  # noqa: E731
    else:
        k3 = K.view(n, C, m)
        library = lambda: torch.einsum("bk,kcm,bc->bm", v, k3, cs)  # noqa: E731
    lib_ms = cuda_ms(library, 50)
    nbytes = (B * n + n * C * m + (0 if cs is None else B * C) + B * m) * v.element_size()
    ops = 2 * B * m * C * n + (0 if cs is None else 2 * B * m * C)
    t_ops = ops / PEAK_OPS["float64"]
    t_bytes = nbytes / HBM_BYTES_PER_S
    rec = {"name": name, "route": "cuda", "source": RM_SOURCE, "replaces": RM_REPLACES,
           "launches": launches, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
           "bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": lib_ms}
    rec["share_of_bound"] = rec["bound_ms"] / k_ms
    timed_record(rec, kernel, 50, library, 50)
    log(f"{name} at B = {B}, n = {n}, C = {C}, m = {m}, {str(v.dtype)[6:]}: {k_ms:.4f} ms "
        f"(device {rec['device_ms']:.4f} ms by {rec['device_ms_by']}, host "
        f"{rec['host_us']:.1f} us), plain "
        f"{p_ms:.4f} ms, library {lib_ms:.4f} ms (device {rec['library_device_ms']:.4f} ms by "
        f"{rec['library_device_ms_by']}, host {rec['library_host_us']:.1f} us), bound "
        f"{rec['bound_ms']:.5f} ms "
        f"({rec['bound_by']}; {ops:.3e} ops, {nbytes} bytes), {rec['share_of_bound']:.1%} of "
        f"bound, max|d| {err:.3e}, {launches} launches on the path; widths "
        f"{[w for w in SUB_WIDTHS if w < B]} bitwise as in the batch")
    return rec


def post_fit_inputs(torch, dev, B, n, per_lane, seed):
    """(nc (B, 2), lh_post (L, n, 2), T_post (L, n)), float64, L = B or 1:
    carries over three nats, a genome far below the other (lane 2), a NaN
    lane (4, as a failed pre-split sweep leaves one); a T == 0 row
    mid-table (3) and two at the end, rates straddling 100 (row 5, C1's
    branch rule: x0 below 100 in some lanes' weights and above in others')
    and both above (row 6), x = lam T around 1/4 (row 4, the series
    switch); per lane, each lane's own T == 0 padding past its rows."""
    rng = np.random.default_rng(seed)
    L = B if per_lane else 1
    T = rng.uniform(0.005, 0.6, (L, n))
    lh = rng.uniform(0.2, 3.0, (L, n, 2)) * 10.0 ** rng.uniform(-0.5, 0.5, (L, n, 1))
    T[:, 3] = 0.0
    T[:, -2:] = 0.0
    lh[:, 5] = [60.0, 180.0]
    lh[:, 6] = [150.0, 300.0]
    T[:, 5:7] = 0.01
    T[:, 4] = 0.25 / lh[:, 4].mean(-1) * rng.uniform(0.9, 1.1, L)
    if per_lane:
        for b in range(B):
            if b % 3:
                T[b, n - 1 - b % 4:] = 0.0
    nc = np.stack([-rng.uniform(0.0, 3.0, B), -rng.uniform(0.0, 3.0, B)], -1)
    nc[2, 1] = -40.0
    nc[4] = np.nan
    return tuple(torch.tensor(a, dtype=torch.float64, device=dev) for a in (nc, lh, T))


def check_post_fit(pf, lk, torch, name, args, kw, want=None):
    """The post-split fit's kernel against its plain version on one input
    (``want``, where it is already computed): rtol 1e-6 / atol 1e-9 with
    equal NaN masks on lc and the final carry, the largest relative
    difference at most 1e-12 (cpfit bitwise), every G
    (threads a solve) bitwise equal to the batch's own, and each prefix of
    SUB_WIDTHS lanes bitwise as in the whole batch.  Returns (max abs
    error, max relative error, bitwise, launches made)."""
    nc, lh, T = args
    B, per_lane = nc.shape[0], lh.shape[0] > 1
    got = pf.post_fit(*args, **kw)
    if want is None:
        want = lk.post_split_fit_plain(*args, **kw)
    errs = [check_close(f"{name} {o}", g, w, 1e-6, 1e-9)
            for o, g, w in zip(("lc", "nc_fin"), got, want)]
    rel = 0.0
    for g, w in zip(got, want):
        fin = torch.isfinite(w) & (w != 0)
        if fin.any():
            rel = max(rel, float(((g - w).abs() / w.abs())[fin].max()))
    bitwise = all(same_bits(g, w) for g, w in zip(got, want))
    require(bitwise or not kw["cpfit"], f"{name}: cpfit not bitwise equal to its plain version")
    require(rel <= 1e-12, f"{name}: largest relative difference {rel:.3e} > 1e-12")
    n = 1
    for g in pf.GROUPS:
        other = pf.post_fit(*args, group=g, **kw)
        n += 1
        require(all(same_bits(x, y) for x, y in zip(other, got)),
                f"{name}: G = {g} threads a solve differ from the batch's own")
    for k in SUB_WIDTHS:
        if k < B:
            part = pf.post_fit(nc[:k], lh[:k] if per_lane else lh, T[:k] if per_lane else T,
                               **kw)
            n += 1
            require(all(same_bits(x, y[:k]) for x, y in zip(part, got)),
                    f"{name}: the first {k} lanes differ from their rows of the {B}-lane batch")
    return max(errs), rel, bitwise, n


def capture_post_fit(fn):
    """Run ``fn()`` and return (args, kwargs) of its first post-split fit
    (the kernel's wrapper as engine/likelihood.py calls it)."""
    from misti_tpu_torch.engine import likelihood as lk

    orig, seen = lk.post_fit, []

    def rec(*a, **kw):
        if not seen:
            seen.append((a, kw))
        return orig(*a, **kw)

    lk.post_fit = rec
    try:
        fn()
    finally:
        lk.post_fit = orig
    require(seen, "no post-split fit in the call")
    return seen[0]


def post_fit_record(pf, torch, name, captured, launches, calls):
    """The post-split fit's kernel on one instance of a path: held against
    its plain version (`check_post_fit`), timed beside it and held to its
    bound (`post_fit_ops`, the work the function needs, over the FP64 rate;
    `post_fit_bytes` over HBM).  No single PyTorch call does the bracketed
    root solves: no library call.  Where the wrapper takes G > 1 threads a
    solve, the same call at G = 1 is timed beside it (device time by events
    on both, in turns G, 1, 1, G).  ``launches`` over ``calls`` objective
    calls must be one per call."""
    from misti_tpu_torch.engine import likelihood as lk

    require(launches == calls, f"{name}: {launches} post_fit launches for {calls} objective "
                               f"calls")
    a, kw = captured
    nc, lh, T = a
    B, (L, n) = nc.shape[0], T.shape
    want = lk.post_split_fit_plain(*a, **kw)
    err, rel, bitwise, _ = check_post_fit(pf, lk, torch, name, a, kw, want)
    shape = pf.launch_shape(B, n, cpfit=kw["cpfit"])
    mix = {}
    if not kw["cpfit"]:
        for layout in ("old", "lane"):
            mix[layout] = pf.warp_branch_mix(*a, layout=layout, group=shape.get("group", 1),
                                             lc=want[0])
    run = lambda: pf.post_fit(*a, **kw)  # noqa: E731
    k_ms = cuda_ms(run, 10)
    p_ms = cuda_ms(lambda: lk.post_split_fit_plain(*a, **kw), 1)
    ops = pf.post_fit_ops(*a, **kw)
    nbytes = pf.post_fit_bytes(B, L, n, itemsize=nc.element_size())
    t_ops, t_bytes = ops / PEAK_OPS["float64"], nbytes / HBM_BYTES_PER_S
    rec = {"name": name, "route": "cuda", "source": PF_SOURCE, "replaces": PF_REPLACES,
           "launches": launches, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
           "bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None,
           "max_rel_err": rel, "launch": shape, "warp_branch_mix": mix}
    rec["share_of_bound"] = rec["bound_ms"] / k_ms
    timed_record(rec, run, 10)
    if shape.get("group", 1) > 1:
        run1 = lambda: pf.post_fit(*a, group=1, **kw)  # noqa: E731
        enq = max(rec["host_us"], host_us(run1, 10))
        ev = [events_ms(f, 20, enq) for f in (run, run1, run1, run)]
        rec["g1_vs_g"] = {"G": shape["group"], "device_ms_ev": [ev[0], ev[3]],
                          "g1_device_ms_ev": [ev[1], ev[2]], "ms": k_ms,
                          "g1_ms": cuda_ms(run1, 10)}
        log(f"{name} G = {shape['group']} against G = 1: {json.dumps(rec['g1_vs_g'])}")
    log(f"{name} at B = {B}, n = {n}, {'per-lane' if L > 1 else 'shared'} tables, "
        f"{'cpfit' if kw['cpfit'] else 'ECT'}, T == 0 rows {int((T == 0).sum())}: {k_ms:.4f} ms "
        f"(device {rec['device_ms']:.4f} ms by {rec['device_ms_by']}, host "
        f"{rec['host_us']:.1f} us), the plain version {p_ms:.3f} ms, bound "
        f"{rec['bound_ms']:.5f} ms ({rec['bound_by']}; {ops:.4e} ops, {nbytes} bytes), "
        f"{rec['share_of_bound']:.1%} of bound ({rec['bound_ms'] / rec['device_ms']:.1%} of "
        f"device_ms), max|d| {err:.3e}, max rel d {rel:.3e}, bitwise equal to the plain "
        f"version {bitwise}, {launches} launches for {calls} objective calls; widths "
        f"{[k for k in SUB_WIDTHS if k < B]} bitwise as in the batch; every G bitwise the "
        f"same")
    log(f"{name} launch: {json.dumps(shape)}")
    for layout, m in mix.items():
        log(f"{name} warp_branch_mix {layout}: {json.dumps(m)}")
    return rec


def phase_attrs(cf, rm, ea, torch):
    """Registers, spill bytes and resident blocks per SM of every template
    instance of the correction sweep at s = 28 (misti_correction_sweep_attrs),
    of expm_action, of row_matmul (float64 only) and of the post-split fit's
    two kernels, one line each; no float32 instance of the sweep and no
    instance of expm_action may spill."""
    from misti_tpu_torch.kernels import post_fit as pf

    for a in pf.kernel_attrs():
        log("attrs " + json.dumps({"library": "post_fit_float64", **a}))
        require(a["local_bytes"] == 0, f"post_fit {a}: uses local memory")
    for a in ea.kernel_attrs():
        log("attrs " + json.dumps({"library": "expm_action_float64", **a}))
        require(a["local_bytes"] == 0, f"expm_action {a}: uses local memory")
    log("attrs " + json.dumps({"library": "row_matmul_float64", "n": 44, "m": 44,
                               **rm.kernel_attrs()}))
    for dtype in (torch.float32, torch.float64):
        for cpfit in (True, False):
            lib = f"correction_sweep_{str(dtype)[6:]}_{'cpfit' if cpfit else 'ect'}"
            for a in cf.kernel_attrs(dtype, cpfit, KERNEL_S):
                log("attrs " + json.dumps({"library": lib, "s": KERNEL_S, **a}))
                require(dtype == torch.float64 or a["local_bytes"] == 0,
                        f"{lib} {a}: a float32 instance uses local memory")


def phase_kernels(cf, rm, ea, torch, dev):
    """Every variant of the sweep kernel against its plain version; then
    ``row_matmul`` at each of the spectrum's instances and ``expm_action`` at
    both of its bases against their plain versions, with every prefix of
    SUB_WIDTHS lanes bitwise as in the batch."""
    rng = np.random.default_rng(SEED)
    variants = []
    for cpfit in (True, False):
        for snm in (False, True):
            for pulse in (False, True):
                variants.append(dict(cpfit=cpfit, static_no_mig=snm, has_pulse=pulse,
                                     mig=not snm, per_lane=False))
        variants.append(dict(cpfit=cpfit, static_no_mig=False, has_pulse=True,
                             mig=True, per_lane=True))
        for b in PER_LANE_B:
            variants.append(dict(cpfit=cpfit, static_no_mig=False, has_pulse=False,
                                 mig=True, per_lane=True, s=PER_LANE_S, B=b))
    before = cf.correction_sweep.launches
    n = 0
    for v in variants:
        seed_state = rng.bit_generator.state
        s, B = v.get("s", KERNEL_S), v.get("B", KERNEL_B)
        for dtype, rtol, atol in ((torch.float64, 1e-6, 1e-9), (torch.float32, 1e-4, 1e-6)):
            rng.bit_generator.state = seed_state  # same draws for both dtypes
            inp = kernel_inputs(rng, s, B, mig=v["mig"], pulse=v["has_pulse"],
                                per_lane=v["per_lane"], dtype=dtype, device=dev)
            opts = dict(cpfit=v["cpfit"], static_no_mig=v["static_no_mig"],
                        has_pulse=v["has_pulse"])
            got = cf.correction_sweep(inp, **opts)
            torch.cuda.synchronize()
            n += 1
            want = cf.correction_sweep_plain(inp, **opts)
            tag = (f"{'cpfit' if v['cpfit'] else 'ect'} snm={int(v['static_no_mig'])} "
                   f"pulse={int(v['has_pulse'])} per_lane={int(v['per_lane'])} "
                   f"s={s} B={B} {str(dtype)[6:]}")
            e_lc = check_close(tag + " lc", got[:2], want[:2], rtol, atol)
            e_pa = check_close(tag + " p_after", got[2:], want[2:], rtol, atol)
            finite = float(torch.isfinite(got[:2]).float().mean())
            log(f"kernel-vs-plain {tag}: max|dlc|={e_lc:.3e} max|dp|={e_pa:.3e} "
                f"lanes with lc off by > 1e-6 rel {lanes_off(got, want)}/{B} "
                f"finite lc {finite:.3f} (rtol {rtol:g} atol {atol:g})")
    moved = cf.correction_sweep.launches - before
    require(moved == n, f"launch counter moved {moved}, expected {n}")
    log(f"kernel-vs-plain: {n} comparisons passed, launch counter +{moved}")

    from misti_tpu_torch.engine.likelihood import SpectrumBasis

    before, n = rm.row_matmul.launches, 0
    for dtype, rtol, atol in ((torch.float64, 1e-6, 1e-9),):  # built in float64 only
        basis = SpectrumBasis(dev, dtype)
        for B in PER_LANE_B:
            gen = torch.Generator().manual_seed(SEED + B)
            for kname, K, C in (("k2", basis.k2, 4), ("k1", basis.k1, 1),
                                ("jsfs2", basis.jsfs2, 0), ("jsfs1", basis.jsfs1, 0),
                                ("ancientT", basis.ancientT, 0), ("collapseT", basis.collapseT, 0)):
                draw = lambda *shape: torch.rand(*shape, generator=gen,  # noqa: E731
                                                 dtype=torch.float64).to(dev, dtype)
                v = draw(B, K.shape[0])
                cs = draw(B, C) if C else None
                got = rm.row_matmul(v, K, cs)
                want = rm.row_matmul_plain(v, K, cs)
                n += 1
                tag = f"row_matmul {kname} B={B} {str(dtype)[6:]}"
                err = check_close(tag, got, want, rtol, atol)
                for w in SUB_WIDTHS:
                    if w < B:
                        part = rm.row_matmul(v[:w], K, cs[:w] if C else None)
                        n += 1
                        require(torch.equal(part, got[:w]),
                                f"{tag}: the first {w} lanes differ from the batch's")
                log(f"kernel-vs-plain {tag} (n = {K.shape[0]}, C = {max(C, 1)}, m = "
                    f"{K.shape[1] // max(C, 1)}): max|d|={err:.3e} (rtol {rtol:g} atol {atol:g}), "
                    f"prefixes of {[w for w in SUB_WIDTHS if w < B]} lanes bitwise as in the batch")
    moved = rm.row_matmul.launches - before
    require(moved == n, f"row_matmul launch counter moved {moved}, expected {n}")
    basis = SpectrumBasis(dev, torch.float32)
    x = torch.ones((6, 44), dtype=torch.float32, device=dev)
    try:
        rm.row_matmul(x, basis.collapseT)
        refused = False
    except TypeError:
        refused = True
    require(refused, "row_matmul took float32 operands: it is built in float64 only")
    require(rm.row_matmul.launches == before + n, "a refused row_matmul call counted")
    log(f"row_matmul kernel-vs-plain: {n} launches, launch counter +{moved}; float32 refused")

    from misti_tpu_torch.kernels import expm as kexpm

    before, n = ea.expm_action.launches, 0
    for dtype, rtol, atol in ((torch.float64, 1e-6, 1e-9),):  # built in float64 only
        basis = SpectrumBasis(dev, dtype)
        for B in PER_LANE_B:
            for kname, K, norms, J in (("k2", basis.sp2, basis.norms2, basis.jsfs2),
                                       ("k1", basis.sp1, basis.norms1, basis.jsfs1)):
                # rates over three decades (ragged sub-step counts), every 5th
                # lane t == 0, a lane past the sub-step cap, a lane with a NaN
                # rate, a lane with t == 0 and a NaN in p0 (it runs the series)
                gen = np.random.default_rng(SEED + B)
                C = norms.shape[0]
                coeffs = gen.uniform(0.0, 1.0, (B, C)) * 10.0 ** gen.uniform(-1, 2, (B, 1))
                t = gen.uniform(0.01, 0.5, B)
                t[::5] = 0.0
                coeffs[3], coeffs[min(7, B - 1), 0] = 1e6, np.nan
                p0 = gen.uniform(0.0, 1.0, (B, K.n))
                p0 /= p0.sum(-1, keepdims=True)
                p0[min(5, B - 1), 1] = np.nan
                cm = (gen.uniform(0.0, 1.0, (B, 7)) > 0.3).astype(float)
                coeffs, t, p0, cm = (torch.tensor(x, dtype=dtype, device=dev)
                                     for x in (coeffs, t, p0, cm))
                got = ea.expm_action(K, coeffs, norms, t, p0, jsfs=J, catmask=cm)
                n += 1
                want = kexpm.expm_action_pair_plain(K, coeffs, norms, t, p0, jsfs=J, catmask=cm)
                tag = f"expm_action {kname} B={B} {str(dtype)[6:]}"
                errs = [check_close(f"{tag} {o}", g, w, rtol, atol)
                        for o, g, w in zip(("E p0", "N1 p0", "projection"), got, want)]
                bitwise = all(same_bits(g, w) for g, w in zip(got, want))
                for w in SUB_WIDTHS:
                    if w < B:
                        part = ea.expm_action(K, coeffs[:w], norms, t[:w], p0[:w], jsfs=J,
                                              catmask=cm[:w])
                        n += 1
                        require(all(same_bits(x, y[:w]) for x, y in zip(part, got)),
                                f"{tag}: the first {w} lanes differ from the batch's")
                log(f"kernel-vs-plain {tag}: max|d| {max(errs):.3e} (rtol {rtol:g} atol "
                    f"{atol:g}), NaN lanes {int(got[0].isnan().any(-1).sum())}, bitwise equal "
                    f"to the plain version {bitwise}; prefixes of "
                    f"{[w for w in SUB_WIDTHS if w < B]} lanes bitwise as in the batch")
    moved = ea.expm_action.launches - before
    require(moved == n, f"expm_action launch counter moved {moved}, expected {n}")
    basis = SpectrumBasis(dev, torch.float32)
    x = torch.ones((6, 44), dtype=torch.float32, device=dev) / 44
    try:
        ea.expm_action(basis.sp2, x[:, :4], basis.norms2, 0.1, x)
        refused = False
    except TypeError:
        refused = True
    require(refused, "expm_action took float32 operands: it is built in float64 only")
    require(ea.expm_action.launches == before + n, "a refused expm_action call counted")
    log(f"expm_action kernel-vs-plain: {n} launches, launch counter +{moved}; float32 refused")

    from misti_tpu_torch.engine import likelihood as lk
    from misti_tpu_torch.kernels import post_fit as pf

    before, n = pf.post_fit.launches, 0
    cases = [(B, per_lane, n_post) for B in PER_LANE_B
             for per_lane, n_post in ((False, 35), (True, 33))] + [POST_FIT_WIDE]
    for B, per_lane, n_post in cases:
        args = post_fit_inputs(torch, dev, B, n_post, per_lane, SEED + B)
        for cpfit in (False, True):
            tag = (f"post_fit {'cpfit' if cpfit else 'ect'} B={B} n={n_post} "
                   f"{'per-lane' if per_lane else 'shared'} float64")
            err, rel, bitwise, k = check_post_fit(pf, lk, torch, tag, args, dict(cpfit=cpfit))
            n += k
            log(f"kernel-vs-plain {tag}: max|d| {err:.3e}, max rel d {rel:.3e} (rtol 1e-6 "
                f"atol 1e-9, NaN masks equal), bitwise equal to the plain version "
                f"{bitwise}; G = {list(pf.GROUPS)} bitwise the same; prefixes of "
                f"{[w for w in SUB_WIDTHS if w < B]} lanes bitwise as in the batch")
    moved = pf.post_fit.launches - before
    require(moved == n, f"post_fit launch counter moved {moved}, expected {n}")
    x = post_fit_inputs(torch, dev, 6, 35, False, SEED)
    try:
        pf.post_fit(*(a.float() for a in x), cpfit=False)
        refused = False
    except TypeError:
        refused = True
    require(refused, "post_fit took float32 operands: it is built in float64 only")
    require(pf.post_fit.launches == before + n, "a refused post_fit call counted")
    log(f"post_fit kernel-vs-plain: {n} launches, launch counter +{moved}; float32 refused")


def phase_main_path(cf, rm, ea, torch, dev, bench):
    """The bench workload through llh_batch; returns per-kernel records."""
    from misti_tpu_torch import build_likelihood
    from misti_tpu_torch.config import LLH_DTYPE
    from misti_tpu_torch.kernels import post_fit as pf

    batch = MAIN_BATCH
    records = {}
    pf_records = []
    for mode in ("", "ect", "trueeps"):
        name = bench.metric_name(mode)
        spec = bench.bench_spec(mode)
        lik = build_likelihood(spec, device=dev, dtype=torch.float32)
        params = bench.bench_params(batch, dev, lik.dtype)
        out = lik.llh_batch(params)  # warm-up
        torch.cuda.synchronize()
        reps = 3
        cf.correction_sweep.launches = 0
        rm.row_matmul.launches = 0
        ea.expm_action.launches = 0
        pf.post_fit.launches = 0
        t0 = time.perf_counter()
        for _ in range(reps):
            out = lik.llh_batch(params)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = cf.correction_sweep.launches
        rm_launches = rm.row_matmul.launches
        ea_launches = ea.expm_action.launches
        pf_launches = pf.post_fit.launches
        require(rm_launches > 0, f"{name}: row_matmul never launched")
        require(ea_launches > 0, f"{name}: expm_action never launched")
        require(pf_launches == reps, f"{name}: post_fit launched {pf_launches} times in {reps} "
                                     f"batches")
        if mode in ("", "ect"):
            pf_records.append(post_fit_record(
                pf, torch, f"post_fit_{'cpfit' if spec.cpfit else 'ect'}_bench",
                capture_post_fit(lambda: lik.llh_batch(params)), pf_launches, reps))
        if spec.cpfit and spec.correct:
            rm_case = (lik, params, rm_launches, ea_launches)
        evals = batch * reps / dt
        # the float32 run's parameters, which float64 holds exactly: a run's
        # dtype rounds only its parameters, so the llh must be the same bits
        require(out.dtype == LLH_DTYPE, f"{name}: llh in {out.dtype}, not {LLH_DTYPE}")
        lik64 = build_likelihood(spec, device=dev, dtype=torch.float64)
        out64 = lik64.llh_batch(params.double())
        fin32, fin64 = torch.isfinite(out), torch.isfinite(out64)
        require(int(fin64.sum()) > 0, f"{name}: no finite llh")
        diff = float((out - out64)[fin64].abs().max())
        require(torch.equal(out, out64), f"{name}: the float32 run differs from the float64 "
                                         f"run on the same parameters (max |dllh| {diff:.3e})")
        am32 = int(torch.argmax(torch.where(fin32, out, -math.inf)))

        mi, pu = lik.map_params(params)
        lc, _, _ = lik.correct(mi, pu)
        spec_ms = cuda_ms(lambda: lik.spectrum(lc, mi, pu), 3)
        corr_ms = cuda_ms(lambda: lik.correct(mi, pu), 3)
        line = (f"main path {name}: {evals:.1f} evals/s (batch {batch}, {reps} reps, "
                f"{dt / reps * 1e3:.2f} ms/llh_batch), the float32 run bitwise the float64 one, "
                f"finite {int(fin32.sum())}/{batch}, argmax {am32}, correction {corr_ms:.3f} ms, "
                f"spectrum {spec_ms:.3f} ms, sweep launches {launches}, row_matmul launches "
                f"{rm_launches} ({rm_launches / reps:g} per llh_batch), expm_action launches "
                f"{ea_launches} ({ea_launches / reps:g} per llh_batch), post_fit launches "
                f"{pf_launches} (1 per llh_batch)")
        if spec.correct:
            require(launches == reps, f"{name}: sweep kernel launched {launches} times in {reps} batches")
            s = spec.splitT
            inp = cf.sweep_inputs(mi[:, :s], pu[:, :s], *lik.sweep_tables)
            opts = lik.sweep_opts
            k_ms = cuda_ms(lambda: cf.correction_sweep(inp, **opts), 5)
            p_ms = cuda_ms(lambda: cf.correction_sweep_plain(inp, **opts), 1)
            rtol, atol, peak = tolerance(inp.dtype)  # float64: the likelihood's dtype
            err = check_close(name + " sweep", cf.correction_sweep(inp, **opts),
                              cf.correction_sweep_plain(inp, **opts), rtol, atol)
            work = cf.sweep_work(inp, **opts)
            ops = cf.sweep_ops(work, s, batch, **opts)
            nbytes = 15 * s * batch * inp.element_size()
            t_ops, t_bytes = ops / peak, nbytes / HBM_BYTES_PER_S
            records[name] = {
                "name": "correction_sweep_" + ("cpfit" if spec.cpfit else "ect"),
                "route": "cuda", "source": SOURCE, "replaces": REPLACES,
                "launches": launches, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": max(t_ops, t_bytes) * 1e3,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": None,
            }
            records[name]["share_of_bound"] = records[name]["bound_ms"] / k_ms
            timed_record(records[name], lambda: cf.correction_sweep(inp, **opts), 5)
            line += (f"; kernel {k_ms:.3f} ms (device {records[name]['device_ms']:.4f} ms, host "
                     f"{records[name]['host_us']:.1f} us), plain {p_ms:.1f} ms, bound "
                     f"{records[name]['bound_ms']:.5f} ms ({ops:.3e} ops, {nbytes} bytes), "
                     f"work {json.dumps(work)}")
        log(line)
    lik, params, rm_launches, ea_launches = rm_case
    args = capture_row_matmul(lambda: lik.llh_batch(params))
    ea_args = capture_expm_action(lambda: lik.llh_batch(params), 44, 14)
    return [records[k] for k in sorted(records)] + [
        row_matmul_record(rm, torch, "row_matmul_collapse_bench", args, rm_launches),
        expm_action_record(ea, torch, "expm_action_k2_bench", ea_args, ea_launches),
        *pf_records]


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
        f"{int(fin64.sum())}/1024 finite, the parameters' float32 rounding moves the llh by "
        f"at most {rel:.3e} relative")


def phase_log(torch, dev):
    """float32 torch.log within 4 ulp of the float64 log on the card."""
    x64 = np.concatenate([np.logspace(-6, 6, 4001), np.linspace(0.03, 0.3, 1000)])
    x = x64.astype(np.float32)
    got = torch.log(torch.tensor(x, device=dev)).cpu().numpy().astype(np.float64)
    ref = np.log(x.astype(np.float64))
    ulp = np.abs(got - ref) / np.spacing(np.abs(ref).astype(np.float32))
    require(ulp.max() < 4.0, f"float32 log error {ulp.max()} ulp")
    log(f"float32 torch.log on the card: max {ulp.max():.3f} ulp over {x.size} inputs")


def _sweep_kernel_record(cf, torch, fs, points, st_idx, launches, name):
    """The per-lane kernel on the input of a first Nelder-Mead iteration's
    objective call over the cells of ``points`` (W cells x 6 trial points;
    phase 6: 808 cells = 4848 lanes, s = 27), timed and held against its
    plain version.  Returns its record for the ``kernels`` line."""
    W, P, n = points.shape
    inp = fs.kernel_input(st_idx.repeat_interleave(P), points.reshape(W * P, n))
    opts = fs.kernel_opts
    s, B = inp.shape[1], inp.shape[2]
    got = cf.correction_sweep(inp, **opts)
    want = cf.correction_sweep_plain(inp, **opts)
    rtol, atol, peak = tolerance(inp.dtype)
    err = check_close(name, got, want, rtol, atol)
    k_ms = cuda_ms(lambda: cf.correction_sweep(inp, **opts), 10)
    p_ms = cuda_ms(lambda: cf.correction_sweep_plain(inp, **opts), 1)
    work = cf.sweep_work(inp, **opts)
    ops = cf.sweep_ops(work, s, B, **opts)
    nbytes = 15 * s * B * inp.element_size()
    t_ops, t_bytes = ops / peak, nbytes / HBM_BYTES_PER_S
    rec = {"name": name, "route": "cuda", "source": SOURCE,
           "replaces": REPLACES, "launches": launches, "max_abs_err": err, "ms": k_ms,
           "plain_ms": p_ms, "bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None}
    rec["share_of_bound"] = rec["bound_ms"] / k_ms
    timed_record(rec, lambda: cf.correction_sweep(inp, **opts), 10)
    log(f"{name} at s = {s}, B = {B}: {k_ms:.4f} ms (device {rec['device_ms']:.4f} ms by "
        f"{rec['device_ms_by']}, host "
        f"{rec['host_us']:.1f} us), plain {p_ms:.1f} ms, "
        f"bound {rec['bound_ms']:.5f} ms ({rec['bound_by']}; {ops:.3e} ops, {nbytes} bytes), "
        f"{rec['share_of_bound']:.1%} of bound, lanes with lc off by > 1e-6 rel "
        f"{lanes_off(got, want)}/{B}, max|dlc| {err:.3e}, work {json.dumps(work)}")
    return rec


def _nm_iteration_ms(torch, fs, cells, data, st_all, x0_all):
    """Wall of one lockstep Nelder-Mead iteration over ``cells``: the
    difference of a 4-iteration and a 1-iteration fit from the start, over 3.
    Returns (ms, the first iteration's trial points (W, 6, n))."""
    from misti_tpu_torch.engine.bootstrap import _lane_objective
    from misti_tpu_torch.engine.optimize import nelder_mead

    f = _lane_objective(fs.llh, st_all[cells], data[cells], [0])
    seen = []

    def obj(points):
        seen.append(points)
        return f(points)

    x0 = x0_all[cells]

    walls = []
    for iters in (1, 4):
        torch.cuda.synchronize()
        t = time.perf_counter()
        nelder_mead(obj, x0, maxiter=iters)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    return (walls[1] - walls[0]) / 3 * 1e3, seen[1]


def _ci_of(bootstrap, llh, splits, data, times, scale):
    res = bootstrap.SweepResult(split_times=np.asarray(splits), params=None, llh=llh, data=data)
    return bootstrap.split_time_confidence_interval(res, times, scale)


def _sweep_llh64(torch, inp, data, flags, x, sel, device):
    """The north-star sweep's float64 llh at parameters ``x`` (S, B, 1) on
    the flat cells ``sel``."""
    from misti_tpu_torch.engine.sweep_fused import build_fused_sweep

    fs64 = build_fused_sweep(inp.times, inp.lambdas, SWEEP_SPLITS, SWEEP_MI,
                             sample_date=inp.sample_date_discr, unfolded=True, smooth=True,
                             device=device, dtype=torch.float64, **flags)
    st_all = np.repeat(np.arange(len(SWEEP_SPLITS)), data.shape[0])
    x = np.asarray(x, float).reshape(-1, 1)[sel]
    d64 = np.tile(data, (len(SWEEP_SPLITS), 1))[sel]
    return fs64.llh(st_all[sel], x, d64).cpu().numpy()


def _hist_of(splits, llh) -> dict:
    splits = np.asarray(splits)
    return {float(k): int(v) for k, v in zip(*np.unique(splits[np.asarray(llh).argmax(0)],
                                                          return_counts=True))}


def _hold_to_table(torch, dev, bootstrap, inp, data, name, flags, maxiter, ref, llh, params,
                   converged, cpu_check=False):
    """The north-star sweep's gates against the JAX package's float64 CPU
    table ``ref`` (scripts/jax_f64_reference.py): the same replicate
    spectra, all llh finite, the same argmax histogram, the CI within 0.01
    generations and, on cells converged in both runs, in float64 on the
    card, no fit worse than the table's by more than 5e-2 nats (cpfit and
    ECT).  ``cpu_check`` also holds the card's float64 llh at the table's
    parameters to the CPU's (limit 1e-6).  Printed, not gated: the card's
    float64 llh at the table's parameters against the table's own llh, and
    the share of cells whose llh is within 1e-6 nats of the table's.
    Returns them as one phrase for the caller's log line."""
    require(np.array_equal(data, ref["data"]), f"{name}: replicate spectra differ from the table")
    require(np.isfinite(llh).all(), f"{name}: non-finite llh")
    splits = np.asarray(SWEEP_SPLITS)
    hist, hist_ref = _hist_of(splits, llh), _hist_of(ref["split_times"], ref["llh"])
    require(hist == hist_ref, f"{name}: argmax histogram {hist} != {hist_ref}")
    ci = _ci_of(bootstrap, llh, splits, data, inp.times, inp.scale_time)
    ci_ref = _ci_of(bootstrap, ref["llh"].astype(float), ref["split_times"], data,
                    ref["times"], float(ref["scale_time"]))
    d_ci = max(abs(ci["mean"] - ci_ref["mean"]),
               *(abs(a - b) for a, b in zip(ci["ci"], ci_ref["ci"])))
    require(d_ci <= 0.01, f"{name}: CI off by {d_ci} generations")
    conv_ref = ref["converged"]
    both = converged & conv_ref
    require(both.any(), f"{name}: no cell converged in both runs")
    dllh = np.abs(llh.astype(float) - ref["llh"].astype(float))
    # The two optima are compared in float64 on the card: the llh of this
    # run's fit against that of the table's fit, on cells converged in both.
    # The card's float64 path is tied to the JAX package through the port's
    # CPU path (tests/test_torch_sweep.py): at the table's own parameters
    # the two must agree.
    sel = np.flatnonzero(both.ravel())
    n_rows = data.shape[0]
    ref64 = _sweep_llh64(torch, inp, data, flags, ref["params"], sel, dev)
    if cpu_check:
        t_cpu = time.perf_counter()
        ref64_cpu = _sweep_llh64(torch, inp, data, flags, ref["params"], sel, "cpu")
        t_cpu = time.perf_counter() - t_cpu
        d_cpu = float(np.abs(ref64 - ref64_cpu).max())
        log(f"{name}: float64 llh at the table's parameters on {sel.size} cells, card vs "
            f"CPU: max |dllh| {d_cpu:.3e} (limit 1e-6; CPU {t_cpu:.1f} s)")
        require(d_cpu <= 1e-6, f"{name}: card and CPU float64 llh differ by {d_cpu:.3e}")
    d_jax = np.abs(ref64 - ref["llh"].ravel()[sel])
    gain64 = _sweep_llh64(torch, inp, data, flags, params, sel, dev) - ref64  # > 0: ours better
    worst = [dict(split=float(SWEEP_SPLITS[c // n_rows]), row=int(c % n_rows),
                  params=float(params.ravel()[c]),
                  table_params=float(ref["params"].ravel()[c]),
                  llh=float(llh.ravel()[c]), table_llh=float(ref["llh"].ravel()[c]),
                  gain64=float(g))
             for c, g in sorted(zip(sel.tolist(), gain64), key=lambda t: t[1])[:5]]
    log(f"{name}: the 5 cells where this fit is furthest below the table's "
        f"(float64) {json.dumps(worst)}")
    require(gain64.min() >= -5e-2,
            f"{name}: a fit is {-gain64.min():.3e} nats below the table's (float64)")
    return (
        f"argmax {hist} (table {hist_ref}), split mean {ci['mean']:.6f} gens CI "
        f"[{ci['ci'][0]:.6f}, {ci['ci'][1]:.6f}] (table {ci_ref['mean']:.6f} "
        f"[{ci_ref['ci'][0]:.6f}, {ci_ref['ci'][1]:.6f}]), unconverged "
        f"{int((~converged).sum())} (table {int((~conv_ref).sum())}), cells whose llh is "
        f"within 1e-6 of the table's {float(np.mean(dllh <= 1e-6)):.4f}, |dllh| on "
        f"{int(both.sum())} cells converged in both: median {np.median(dllh[both]):.3e} max "
        f"{dllh[both].max():.3e}, the card's float64 llh at the table's parameters minus the "
        f"table's llh: max |d| {d_jax.max():.3e}, float64 llh of this fit minus the table's: "
        f"median {np.median(gain64):.3e} min {gain64.min():.3e} max {gain64.max():.3e}")


def _print_old_table(torch, dev, bootstrap, inp, data, name, flags, maxiter, old, llh, params,
                     converged):
    """An info line: this run against the JAX package's float32 TPU table
    of the same command (its histogram, CI, and this fit's float64 llh minus
    that of the table's fit on the cells converged in both).  Not gated."""
    splits = np.asarray(SWEEP_SPLITS)
    ci = _ci_of(bootstrap, llh, splits, data, inp.times, inp.scale_time)
    ci_old = _ci_of(bootstrap, old["llh"].astype(float), old["split_times"], data, old["times"],
                    float(old["scale_time"]))
    conv_old = old["nfev"] < 2 + 6 * maxiter  # no flags there; one parameter: 2 + 6 per iteration
    sel = np.flatnonzero((converged & conv_old).ravel())
    gain = (_sweep_llh64(torch, inp, data, flags, params, sel, dev)
            - _sweep_llh64(torch, inp, data, flags, old["params"], sel, dev))
    log(f"{name}: against the JAX package's float32 TPU table (info, not gated): argmax "
        f"{_hist_of(splits, llh)} (TPU table {_hist_of(old['split_times'], old['llh'])}), CI "
        f"[{ci['ci'][0]:.6f}, {ci['ci'][1]:.6f}] (TPU table [{ci_old['ci'][0]:.6f}, "
        f"{ci_old['ci'][1]:.6f}]), float64 llh of this fit minus the TPU table's fit on "
        f"{sel.size} cells: min {gain.min():.3e} median {np.median(gain):.3e} max "
        f"{gain.max():.3e}")


def phase_sweep(cf, rm, ea, torch, dev):
    """The north-star bootstrap x split-time sweep on the card (the run's
    default dtype, float64), cpfit (--maxiter 256) and ECT, each against the
    JAX package's float64 CPU table of the same command, with no cell left
    unconverged; the
    per-lane kernel, row_matmul and expm_action (both bases) at the first
    stage's width; each lane of the first iteration bitwise the same alone,
    in sub-batches and in the whole batch; a small staged-vs-uninterrupted
    ECT sweep, bitwise.  Returns the kernel records."""
    from misti_tpu_torch.config import resolve_dtype
    from misti_tpu_torch.engine import bootstrap
    from misti_tpu_torch.engine.sweep_fused import build_fused_sweep
    from misti_tpu_torch.io import jsfs as io_jsfs
    from misti_tpu_torch.io import psmc as io_psmc
    from misti_tpu_torch.kernels import post_fit as pf

    fix = os.path.join(HERE, "tests", "fixtures")
    inp = io_psmc.read_psmc(os.path.join(fix, "sweep1.psmc"), os.path.join(fix, "sweep2.psmc"),
                            0, -1)
    data = bootstrap.make_bootstrap_data(io_jsfs.read_jafs(os.path.join(fix, "sweep.jsfs")),
                                         SWEEP_REPLICATES, seed=0)
    dt = resolve_dtype(dev)  # the run's default: what the sweeps below get
    common = dict(tol=1e-4, device=dev, sample_date=inp.sample_date_discr, unfolded=True,
                  smooth=True, correct=True)
    n_rows = data.shape[0]
    st_all = torch.arange(len(SWEEP_SPLITS), device=dev).repeat_interleave(n_rows)
    data_all = torch.as_tensor(np.tile(data, (len(SWEEP_SPLITS), 1)), dtype=dt, device=dev)
    records = []
    cpfit_run = None
    for mode, flags, maxiter, table, old_table in SWEEP_RUNS:
        ref = np.load(os.path.join(HERE, table))
        buf = io.StringIO()
        cf.correction_sweep.launches = 0
        rm.row_matmul.launches = 0
        ea.expm_action.launches = 0
        pf.post_fit.launches = 0
        t = time.perf_counter()
        with contextlib.redirect_stderr(buf):
            res = bootstrap.sweep(inp.times, inp.lambdas, data, SWEEP_SPLITS, SWEEP_MI, (),
                                  maxiter=maxiter, **common, **flags)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = cf.correction_sweep.launches
        rm_launches = rm.row_matmul.launches
        ea_launches = ea.expm_action.launches
        pf_launches = pf.post_fit.launches
        require(pf_launches == res.calls,
                f"sweep {mode}: {pf_launches} post_fit launches for {res.calls} objective calls")
        require(rm_launches > 0, f"sweep {mode}: row_matmul never launched")
        require(ea_launches > 0, f"sweep {mode}: expm_action never launched")
        stages = [ln for ln in buf.getvalue().splitlines() if ln.startswith("# sweep stage")]
        for ln in stages:
            log(f"sweep {mode} {ln[2:]}")
        cells = res.llh.size
        require(launches == res.calls,
                f"sweep {mode}: {launches} kernel launches for {res.calls} objective calls")
        require(res.params.dtype == np.dtype(str(dt).removeprefix("torch.")),
                f"sweep {mode}: parameters in {res.params.dtype}, not the default {dt}")
        g = _hold_to_table(torch, dev, bootstrap, inp, data, f"sweep {mode}", flags, maxiter,
                           ref, res.llh, res.params, res.converged, cpu_check=True)
        _print_old_table(torch, dev, bootstrap, inp, data, f"sweep {mode}", flags, maxiter,
                         np.load(os.path.join(HERE, old_table)), res.llh, res.params,
                         res.converged)
        stuck = [dict(split=SWEEP_SPLITS[i], row=int(r), params=float(res.params[i, r, 0]),
                      llh=float(res.llh[i, r]), nfev=int(res.nfev[i, r]),
                      table_params=float(ref["params"][i, r, 0]),
                      table_llh=float(ref["llh"][i, r]), table_nfev=int(ref["nfev"][i, r]),
                      table_converged=bool(ref["converged"][i, r]))
                 for i, r in zip(*np.nonzero(~res.converged))]
        log(f"sweep {mode}: cells unconverged at --maxiter {maxiter}: {json.dumps(stuck)}")
        require(not stuck, f"sweep {mode}: {len(stuck)} cells unconverged at --maxiter {maxiter}")
        evals = int(res.nfev.sum())
        log(f"sweep {mode}: {cells} cells, {evals} llh evals (table: {int(ref['nfev'].sum())}), "
            f"{wall:.2f} s wall, {evals / wall:.1f} evals/s, {res.calls} objective calls = "
            f"{launches} kernel launches, {g}, cells with different nfev "
            f"{int((res.nfev != ref['nfev']).sum())}; per objective call: row_matmul "
            f"{rm_launches / res.calls:.2f}, expm_action {ea_launches / res.calls:.2f}, "
            f"post_fit {pf_launches / res.calls:.2f} launches")

        # one Nelder-Mead iteration at the first stage's width and at the
        # narrowest stage width of this run; the per-lane kernel at the first
        fs = build_fused_sweep(inp.times, inp.lambdas, SWEEP_SPLITS, SWEEP_MI,
                               sample_date=inp.sample_date_discr, unfolded=True, smooth=True,
                               device=dev, **flags)
        x0_all = torch.as_tensor(np.tile(fs.init_params, (cells, 1)), dtype=dt, device=dev)
        widths = [int(w) for w in re.findall(r"(\d+) cells resumed", buf.getvalue())] or [cells]
        narrow = min(widths)
        ms_wide, points = _nm_iteration_ms(torch, fs, torch.arange(cells, device=dev),
                                           data_all, st_all, x0_all)
        ms_narrow, _ = _nm_iteration_ms(torch, fs, torch.arange(narrow, device=dev),
                                        data_all, st_all, x0_all)
        log(f"sweep {mode}: one Nelder-Mead iteration {ms_wide:.1f} ms at {cells} cells "
            f"({cells * 6} lanes), {ms_narrow:.1f} ms at {narrow} cells ({narrow * 6} lanes)")
        records.append(_sweep_kernel_record(cf, torch, fs, points, st_all, launches,
                                            f"correction_sweep_{mode}_per_lane"))

        # each lane of the first iteration alone, in sub-batches and in the
        # whole batch: bitwise the same value (the staged compaction's premise)
        W, P, n = points.shape
        st_l, x_l = st_all.repeat_interleave(P), points.reshape(W * P, n)
        d_l = data_all.repeat_interleave(P, dim=0)
        full = fs.llh(st_l, x_l, d_l)
        picks = [torch.arange(w, device=dev) for w in SUB_WIDTHS]
        picks.append(torch.arange(0, W * P, 7, device=dev))
        for sel in picks:
            part = fs.llh(st_l[sel], x_l[sel], d_l[sel])
            require(torch.equal(part, full[sel]),
                    f"sweep {mode}: {sel.numel()} lanes evaluated apart differ from the "
                    f"{W * P}-lane batch (max |dllh| "
                    f"{float((part.double() - full[sel].double()).abs().max()):.3e})")
        log(f"sweep {mode}: the first iteration's lanes alone and in sub-batches of "
            f"{[int(p.numel()) for p in picks]} lanes: bitwise as in the {W * P}-lane batch")
        call = lambda: fs.llh(st_l, x_l, d_l)  # noqa: E731
        seen = _kernels_seen(call, 1)
        log(f"sweep {mode}: one objective call at {W * P} lanes: "
            f"{sum(c for c, _ in seen.values())} CUDA kernel launches seen by torch.profiler "
            f"({sum(us for _, us in seen.values()) / 1e3:.3f} ms of device time), of them "
            f"post_fit 1")
        records.append(post_fit_record(pf, torch, f"post_fit_{mode}_sweep",
                                       capture_post_fit(call), pf_launches, res.calls))
        if mode == "cpfit":
            records.append(row_matmul_record(rm, torch, "row_matmul_collapse_sweep",
                                             capture_row_matmul(call), rm_launches))
            # pre-split interval 24: lanes of splits 20-24 hold T == 0 there;
            # post-split interval 30: lanes of splits 24-27 do
            records.append(expm_action_record(ea, torch, "expm_action_k2_sweep",
                                              capture_expm_action(call, 44, 24), ea_launches))
            records.append(expm_action_record(ea, torch, "expm_action_k1_sweep",
                                              capture_expm_action(call, 8, 30), ea_launches))
        if mode == "cpfit":
            cpfit_run = dict(res=res, wall=wall, fs=fs, points=points, st_all=st_all)

    # staged against uninterrupted, on the card: splits 24-25 x 8 rows, ECT,
    # both to STAGED_MAXITER iterations (~0.5 s each at this width), bitwise
    rows = data[:8]
    kw = dict(common, cpfit=False, maxiter=STAGED_MAXITER)
    with contextlib.redirect_stderr(io.StringIO()):
        r1 = bootstrap.sweep(inp.times, inp.lambdas, rows, [24.0, 25.0], SWEEP_MI, (),
                             phase1_maxiter=STAGED_MAXITER, **kw)
        r2 = bootstrap.sweep(inp.times, inp.lambdas, rows, [24.0, 25.0], SWEEP_MI, (),
                             stage_caps=(4, 8, 16), **kw)
    bitwise = (np.array_equal(r1.llh, r2.llh) and np.array_equal(r1.params, r2.params)
               and np.array_equal(r1.nfev, r2.nfev))
    d = float(np.abs(r1.llh - r2.llh).max())
    require(np.array_equal(r1.converged, r2.converged), "staged sweep: converged flags differ")
    require(bitwise, f"staged sweep: not bitwise the uninterrupted sweep (max |dllh| {d:.3e})")
    log(f"sweep staged (caps 4 8 16 {STAGED_MAXITER}) vs uninterrupted, ECT, splits 24-25 x 8 "
        f"rows, {dt}: bitwise {bitwise}, max |dllh| {d:.3e}, cells with different nfev "
        f"{int((r1.nfev != r2.nfev).sum())}, unconverged {int((~r1.converged).sum())}, "
        f"max nfev {int(r1.nfev.max())}")
    return records, cpfit_run


def _run_cli(main, argv):
    """A CLI's ``main(argv)`` with its stdout captured: (rc, lines, wall s)."""
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue().splitlines(), time.perf_counter() - t


def _check_mi(name, ours, ref, pr_rtol=1e-3, pr_atol=1e-6):
    """tests/test_cli.py's tolerances for a fit's .mi against upstream's.
    Returns each field's largest error as a share of its tolerance."""
    checks = [("llh", [ours.llh], [ref.llh], 2e-6, 0.0),
              ("jafs", ours.jafs, ref.jafs, 5e-5, 1e-7),
              ("lambda1", ours.lambda1, ref.lambda1, 5e-4, 0.0),
              ("lambda2", ours.lambda2, ref.lambda2, 5e-4, 0.0),
              ("pr11", ours.pr11, ref.pr11, pr_rtol, pr_atol)]
    require(ours.split_t == ref.split_t and ours.sample_date == ref.sample_date,
            f"{name}: split or sample date differs from upstream's")
    worst = {}
    for field, a, b, rtol, atol in checks:
        a, b = np.asarray(a, float), np.asarray(b, float)
        require(a.shape == b.shape and np.allclose(a, b, rtol=rtol, atol=atol),
                f"{name}: {field} beyond rtol {rtol} atol {atol} of upstream's")
        worst[field] = float(np.max(np.abs(a - b) / (atol + rtol * np.abs(b))))
    return worst


def _single_fit_lik(torch, dev, argv):
    """The likelihood the single-fit CLI builds for a north-star command
    (split 24, bootstrap row 0, smoothing on, unfolded)."""
    from misti_tpu_torch import build_likelihood, build_spec
    from misti_tpu_torch.io import jsfs as io_jsfs
    from misti_tpu_torch.io import psmc as io_psmc

    fix = os.path.join(HERE, "tests", "fixtures")
    data = io_psmc.read_psmc(os.path.join(fix, "sweep1.psmc"), os.path.join(fix, "sweep2.psmc"),
                             0, -1)
    sfs = list(io_jsfs.read_jafs(os.path.join(fix, "sweep.jsfs")).jafs[0])
    mi = [argv[i + 1:i + 6] for i, a in enumerate(argv) if a == "-mi"]
    pu = [argv[i + 1:i + 5] for i, a in enumerate(argv) if a == "-pu"]
    spec = build_spec(data.times, data.lambdas, sfs, 24, mi, pu, cpfit="--cpfit" in argv,
                      smooth=True, unfolded=True, sample_date=data.sample_date_discr,
                      thrh=(data.theta, data.rho))
    return build_likelihood(spec, device=dev, dtype=torch.float64)


def _objective_launches(torch, lik, points) -> int:
    """CUDA kernel launches of one objective call (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    lik.llh_flags_batch(points)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        lik.llh_flags_batch(points)
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)


def phase_single_fit(cf, rm, ea, torch, dev):
    """The single-fit path on the card, float64, through the port's CLIs:
    upstream's fits (tests/test_cli.py's commands) against its .mi files and
    --debug golden; the north-star command at split 24 (cpfit, ECT, cpfit
    with one optimised pulse) against the JAX package's CPU float64 fits
    (SINGLE_FIT_REF); the testmodel README oracle.  Returns the kernel
    records of the north-star fits' instances."""
    from misti_tpu_torch.cli import misti, testmodel
    from misti_tpu_torch.io import mi_format
    from misti_tpu_torch.io.units import Units
    from misti_tpu_torch.kernels import post_fit as pf

    fix = os.path.join(HERE, "tests", "fixtures")
    synth = [os.path.join(fix, f) for f in ("synth1.psmc", "synth2.psmc", "synth.jsfs")]
    records = []
    with tempfile.TemporaryDirectory() as tmp:
        # a. upstream's own fits
        for name, args, ref_file in UPSTREAM_FITS:
            Units.reset()
            out_mi = os.path.join(tmp, name + ".mi")
            cf.correction_sweep.launches = 0
            pf.post_fit.launches = 0
            rc, lines, wall = _run_cli(misti.main, synth + args + ["-o", out_mi])
            launches = cf.correction_sweep.launches
            require(rc == 0, f"{name}: rc {rc}")
            fit = parse_fit_stdout(lines)
            require(launches == fit["nit"] + 1 == pf.post_fit.launches,
                    f"{name}: {launches} kernel launches and {pf.post_fit.launches} post_fit "
                    f"launches for {fit['nit'] + 1} objective calls")
            worst = _check_mi(name, mi_format.read_migration(out_mi),
                              mi_format.read_migration(os.path.join(fix, ref_file)))
            log(f"single fit {name} (float64, card): x {fit['x']} llh {fit['llh']!r}, nit "
                f"{fit['nit']} nfev {fit['nfev']} calls {fit['calls']} corr {fit['corr_called']}/"
                f"{fit['corr_failed']}, {launches} kernel launches, {wall:.2f} s; largest error "
                f"against upstream's .mi as a share of its tolerance {json.dumps(worst)}")

        Units.reset()
        ref_lines = open(os.path.join(fix, "ref_debug_stdout.txt")).read().splitlines()
        cf.correction_sweep.launches = 0
        pf.post_fit.launches = 0
        rc, lines, wall = _run_cli(misti.main, synth + DEBUG_ARGS)
        launches = cf.correction_sweep.launches
        require(rc == 0, f"debug golden: rc {rc}")
        require(pf.post_fit.launches == 3, f"debug golden: {pf.post_fit.launches} post_fit "
                                           f"launches, expected 3")

        def grab(ls, prefix):
            hits = [ln for ln in ls if ln.startswith(prefix)]
            require(len(hits) == 1, f"debug golden: no single line {prefix!r}")
            return hits[0]

        ours, ref = grab(lines, "bs_id ="), grab(ref_lines, "bs_id =")
        require(ours.rsplit("llh =", 1)[0] == ref.rsplit("llh =", 1)[0],
                "debug golden: estimate line differs before the llh")
        d_llh = abs(float(ours.rsplit("llh =", 1)[1]) / float(ref.rsplit("llh =", 1)[1]) - 1)
        require(d_llh <= 2e-6, f"debug golden: llh off by {d_llh:.3e} relative")
        for prefix in ("Total number of likelihood function calls is",
                       "Lambda correction called", "Lambda correction failed"):
            require(grab(lines, prefix) == grab(ref_lines, prefix),
                    f"debug golden: {prefix!r} line differs")
        require(launches == 3, f"debug golden: {launches} kernel launches, expected 3")
        log(f"single fit debug golden (float64, card): estimate line and Report() lines as "
            f"upstream's, llh rel diff {d_llh:.3e}, {launches} kernel launches, {wall:.2f} s")

        # b. the north-star command as one user fit, against the JAX package's
        with open(os.path.join(HERE, SINGLE_FIT_REF)) as f:
            jax_fits = json.load(f)["fits"]
        for name, ref in jax_fits.items():
            Units.reset()
            argv = [os.path.join(HERE, a) if a.startswith("tests/") else a for a in ref["argv"]]
            out_mi = os.path.join(tmp, name + ".mi")
            cf.correction_sweep.launches = 0
            rm.row_matmul.launches = 0
            ea.expm_action.launches = 0
            pf.post_fit.launches = 0
            torch.cuda.synchronize()
            rc, lines, wall = _run_cli(misti.main, argv + ["-o", out_mi])
            launches = cf.correction_sweep.launches
            rm_launches = rm.row_matmul.launches
            ea_launches = ea.expm_action.launches
            pf_launches = pf.post_fit.launches
            require(rm_launches > 0, f"north-star {name}: row_matmul never launched")
            require(ea_launches > 0, f"north-star {name}: expm_action never launched")
            require(rc == 0, f"north-star {name}: rc {rc}")
            fit = parse_fit_stdout(lines)
            calls = fit["nit"] + 1  # the simplex's calls and the -bs 0 re-evaluation
            require(launches == calls,
                    f"north-star {name}: {launches} kernel launches for {calls} objective calls")
            d_llh = abs(fit["llh"] / ref["llh"] - 1)
            d_x = max(abs(a - b) for a, b in zip(fit["x"], ref["x"]))
            require(len(fit["x"]) == len(ref["x"]) and d_x <= 1e-3,
                    f"north-star {name}: x {fit['x']} vs the JAX package's {ref['x']}")
            require(d_llh <= 1e-6, f"north-star {name}: llh {fit['llh']} vs {ref['llh']}")
            counters = {k: (fit[k], ref[k]) for k in ("nit", "nfev", "calls", "corr_called",
                                                     "corr_failed")}

            lik = _single_fit_lik(torch, dev, argv)
            x = torch.tensor(ref["x"], dtype=torch.float64, device=dev)
            n = x.numel()
            # an iteration's n + 5 trial points around the optimum
            points = x * (1.0 + 0.01 * torch.arange(n + 5, dtype=torch.float64,
                                                    device=dev))[:, None]
            per_call = _objective_launches(torch, lik, points)
            s = lik.spec.splitT
            mi, pu = lik.map_params(points)
            inp = cf.sweep_inputs(mi[:, :s], pu[:, :s], *lik.sweep_tables)
            opts = lik.sweep_opts
            err = check_close(f"north-star {name} sweep", cf.correction_sweep(inp, **opts),
                              cf.correction_sweep_plain(inp, **opts), 1e-6, 1e-9)
            k_ms = cuda_ms(lambda: cf.correction_sweep(inp, **opts), 20)
            p_ms = cuda_ms(lambda: cf.correction_sweep_plain(inp, **opts), 1)
            B = inp.shape[2]
            work = cf.sweep_work(inp, **opts)
            ops = cf.sweep_ops(work, s, B, **opts)
            nbytes = 15 * s * B * inp.element_size()
            t_ops, t_bytes = ops / PEAK_OPS["float64"], nbytes / HBM_BYTES_PER_S
            rec = {"name": f"correction_sweep_{name}_single_fit_f64", "route": "cuda",
                   "source": SOURCE, "replaces": REPLACES, "launches": launches,
                   "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                   "bound_ms": max(t_ops, t_bytes) * 1e3,
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": None}
            rec["share_of_bound"] = rec["bound_ms"] / k_ms
            timed_record(rec, lambda: cf.correction_sweep(inp, **opts), 20)
            records.append(rec)
            call = lambda: lik.llh_flags_batch(points)  # noqa: E731
            records.append(post_fit_record(pf, torch, f"post_fit_{name}_single_fit_f64",
                                           capture_post_fit(call), pf_launches, calls))
            if name == "cpfit":
                records.append(row_matmul_record(rm, torch, "row_matmul_collapse_single_fit_f64",
                                                 capture_row_matmul(call), rm_launches))
                records.append(expm_action_record(ea, torch, "expm_action_k2_single_fit_f64",
                                                  capture_expm_action(call, 44, 12),
                                                  ea_launches))
            log(f"north-star {name} (float64, card): x {fit['x']} llh {fit['llh']!r}; JAX "
                f"package x {ref['x']} llh {ref['llh']!r}; rel dllh {d_llh:.3e}, max |dx| "
                f"{d_x:.3e}; (card, JAX) {json.dumps(counters)}; converged {fit['converged']}")
            log(f"north-star {name} timing: {wall:.3f} s wall, {calls} objective calls, "
                f"{wall / calls * 1e3:.1f} ms per objective call, {fit['calls'] / wall:.1f} "
                f"evals/s, {per_call} kernel launches per objective call ({n + 5} lanes), of "
                f"them row_matmul {rm_launches / calls:.2f}, expm_action "
                f"{ea_launches / calls:.2f} and post_fit {pf_launches / calls:.2f}; "
                f"correction kernel at s = {s}, B = {B}, float64, shared tables: {k_ms:.4f} ms "
                f"(device {rec['device_ms']:.4f} ms, host {rec['host_us']:.1f} us), "
                f"plain {p_ms:.1f} ms, bound {rec['bound_ms']:.5f} ms ({rec['bound_by']}; "
                f"{ops:.3e} ops, {nbytes} bytes), {rec['share_of_bound']:.1%} of bound, "
                f"max|d| {err:.3e}")

        # c. the testmodel README oracle
        Units.reset()
        out_mi = os.path.join(tmp, "tm.mi")
        rc, lines, wall = _run_cli(testmodel.main, [README_MS, "-uf", "-o", out_mi,
                                                    "--funits", "/nonexistent"])
        require(rc == 1, f"testmodel: rc {rc} (the reference's is 1)")
        tm = mi_format.read_migration(out_mi)
        d_llh = abs(tm.llh / README_LLH - 1)
        d_jafs = float(np.max(np.abs(np.asarray(tm.jafs) - README_JSFS)))
        require(d_llh <= 1e-10, f"testmodel: llh {tm.llh!r}, README's {README_LLH!r}")
        require(d_jafs <= 1e-6, f"testmodel: expected JSFS off the README's by {d_jafs:.3e}")
        log(f"testmodel README oracle (float64, card): llh {tm.llh!r} (rel diff {d_llh:.3e}), "
            f"max |dJSFS| {d_jafs:.3e} against the README's, {wall:.2f} s")
    return records


def _run_ranks(cmd, timeout):
    """Run a ``torch.distributed.run`` command in a session of its own:
    (rc, stdout, stderr, wall s).  On a timeout every process of the session
    (torchrun and its ranks) is killed and the phase fails."""
    t = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True,
                            env=dict(os.environ, PYTHONPATH=HERE))
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise RuntimeError(f"{' '.join(cmd[:6])} ...: no end within {timeout} s")
    finally:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)  # a rank left behind
    return proc.returncode, out, err, time.perf_counter() - t


def phase_sharded_sweep(cf, rm, ea, torch, dev, cpfit_run):
    """Phase 6's north-star cpfit sweep (--maxiter 256, the CLI's default
    dtype, bootstrap seed 0) through ``misti_tpu_torch.cli.sweep`` as
    SHARDED_RANKS ranks of ``torch.distributed.run`` on the one card, held to
    phase 6's gates against the same JAX float64 table on the spectra the
    ranks fitted, and compared
    with phase 6's one-process table; then the per-lane kernel at the width
    a rank launches it in stage 1 (808 / SHARDED_RANKS cells x 6 trial
    points), held against its plain version on every rank's block.  Returns
    that instance's record, with the ranks' launches."""
    from misti_tpu_torch.engine import bootstrap
    from misti_tpu_torch.io import jsfs as io_jsfs
    from misti_tpu_torch.io import psmc as io_psmc

    fix = os.path.join(HERE, "tests", "fixtures")
    inp = io_psmc.read_psmc(os.path.join(fix, "sweep1.psmc"), os.path.join(fix, "sweep2.psmc"),
                            0, -1)
    data = bootstrap.make_bootstrap_data(io_jsfs.read_jafs(os.path.join(fix, "sweep.jsfs")),
                                         SWEEP_REPLICATES, seed=0)
    mode, flags, maxiter, table, _ = SWEEP_RUNS[0]
    ref = np.load(os.path.join(HERE, table))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "sweep.npz")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(SHARDED_RANKS), "-m", "misti_tpu_torch.cli.sweep",
               *(os.path.join(fix, f) for f in ("sweep1.psmc", "sweep2.psmc", "sweep.jsfs")),
               "--splits", "20", "27", "-bs", str(SWEEP_REPLICATES), "-mi", *SWEEP_MI[0], "-uf",
               "--cpfit", "--maxiter", str(maxiter), "--seed", "0", "--funits", "/nonexistent",
               "-o", out]
        rc, stdout, stderr, wall = _run_ranks(cmd, SHARDED_TIMEOUT_S)
        for ln in stderr.splitlines():
            if ln.startswith("# sweep stage"):
                log(f"sharded sweep {ln[2:]}")
        require(rc == 0, f"sharded sweep: rc {rc}\n{stdout[-4000:]}\n{stderr[-4000:]}")
        summary = json.loads([ln for ln in stdout.splitlines() if ln.startswith("{")][-1])
        z = {k: v for k, v in np.load(out).items()}
    require(summary["processes"] == SHARDED_RANKS, f"sharded sweep: {summary['processes']} ranks")
    cells = sum(ln.startswith("bs_id = ") for ln in stdout.splitlines())
    require(cells == len(SWEEP_SPLITS) * data.shape[0], f"sharded sweep: {cells} cell lines")
    launches, calls = summary["kernel_launches"], summary["objective_calls"]
    require(min(launches) > 0 and sum(launches) == calls["sum"],
            f"sharded sweep: kernel launches {launches} for objective calls {calls}")
    for k in ("row_matmul_launches", "expm_action_launches"):
        require(min(summary[k]) > 0, f"sharded sweep: {k} per rank {summary[k]}")
    require(summary["post_fit_launches"] == launches,
            f"sharded sweep: post_fit launches per rank {summary['post_fit_launches']}, "
            f"kernel launches {launches}: one each per objective call")
    require(np.array_equal(z["data"], data),
            "sharded sweep: the ranks' spectra differ from make_bootstrap_data(seed=0)")
    conv = z["nfev"] < 2 + 6 * maxiter  # one parameter: 2 + 6 per iteration
    g = _hold_to_table(torch, dev, bootstrap, inp, z["data"], "sharded sweep", flags, maxiter,
                       ref, z["llh"], z["params"], conv)
    one = cpfit_run["res"]
    same = (z["llh"] == one.llh) & (z["params"][..., 0] == one.params[..., 0])
    d_one = float(np.abs(z["llh"].astype(float) - one.llh.astype(float)).max())
    log(f"sharded sweep ({SHARDED_RANKS} ranks on one card, cpfit, --maxiter {maxiter}): "
        f"{z['llh'].size} cells, {int(z['nfev'].sum())} llh evals, wall {wall:.2f} s with "
        f"start-up (the CLI's sweep wall {summary['wallclock_s']} s; one process, phase 6: "
        f"{cpfit_run['wall']:.2f} s), objective calls busiest rank {calls['max']} / all ranks "
        f"{calls['sum']} (one process {one.calls}), kernel launches per rank {launches}, "
        f"expm_action launches per rank {summary['expm_action_launches']} "
        f"({sum(summary['expm_action_launches']) / calls['sum']:.2f} per objective call); "
        f"against phase 6's table: {int(same.sum())}/{same.size} cells bitwise equal, max "
        f"|dllh| {d_one:.3e}, cells with different nfev {int((z['nfev'] != one.nfev).sum())}; "
        f"{g}; the CLI's summary {json.dumps(summary)}")

    # the kernel at a rank's stage-1 width: each rank's contiguous block of
    # the first iteration's trial points (phase 6's, cells in the CLI's
    # split-major order), rank 0's block timed
    fs, points, st_all = cpfit_run["fs"], cpfit_run["points"], cpfit_run["st_all"]
    per = points.shape[0] // SHARDED_RANKS
    rec = None
    for r in range(SHARDED_RANKS):
        blk = slice(r * per, (r + 1) * per)
        r_rec = _sweep_kernel_record(cf, torch, fs, points[blk], st_all[blk], sum(launches),
                                     f"correction_sweep_{mode}_per_lane_rank_block")
        rec = rec or r_rec
        rec["max_abs_err"] = max(rec["max_abs_err"], r_rec["max_abs_err"])
    rec["launches_sharded"] = launches  # per rank; "launches" is their sum
    return rec


def phase_scenarios(cf, rm, ea, torch, dev):
    """The --scenarios path: two scenarios of the 16-scenario matrix
    (tests/fixtures/matrix/matrix.json; MATRIX_SCENARIOS) resident in one
    process through ``sweep_many``, at full width (808 cells each, bootstrap
    seed 0, ``-bs 100 -uf --nosmooth --cpfit``) and ``--maxiter``
    MATRIX_MAXITER, the default dtype: every llh finite, kernel launches
    equal to the objective calls, the no-migration scenario's argmax
    histogram equal to the JAX package's float64 reference
    (MATRIX_REFERENCE; its float32 TPU table MATRIX_OLD_TABLE printed), and
    the per-lane kernel at the two-band scenario's first-stage width against
    its plain version.  Returns that instance's record."""
    from misti_tpu_torch.engine import bootstrap
    from misti_tpu_torch.engine.sweep_fused import build_fused_sweep
    from misti_tpu_torch.io import jsfs as io_jsfs
    from misti_tpu_torch.io import psmc as io_psmc
    from misti_tpu_torch.kernels import post_fit as pf

    mdir = os.path.join(HERE, "tests", "fixtures", "matrix")
    with open(os.path.join(mdir, "matrix.json")) as f:
        manifest = {e["name"]: e for e in json.load(f)}
    with open(os.path.join(HERE, MATRIX_REFERENCE)) as f:
        table = {e["scenario"]: e for k, e in json.load(f)["entries"].items()
                 if k.startswith("cpfit:")}
    with open(os.path.join(HERE, MATRIX_OLD_TABLE)) as f:
        old = {e["scenario"]: e for e in json.load(f)["per_scenario"] if "scenario" in e}
    scenarios, inputs = [], {}
    for name in MATRIX_SCENARIOS:
        e = manifest[name]
        inp = io_psmc.read_psmc(os.path.join(mdir, e["fpsmc1"]), os.path.join(mdir, e["fpsmc2"]),
                                0, -1)
        data = bootstrap.make_bootstrap_data(io_jsfs.read_jafs(os.path.join(mdir, e["fjafs"])),
                                             SWEEP_REPLICATES, seed=0)
        splits = [float(v) for v in range(e["splits"][0], e["splits"][1] + 1)]
        inputs[name] = (inp, data, splits, [list(map(str, r)) for r in e["mi"]])
        scenarios.append(dict(name=name, times=inp.times, lambdas=inp.lambdas, data=data,
                              splits=splits, mi_template=inputs[name][3], pu_template=[],
                              sample_date=inp.sample_date_discr, unfolded=True, cpfit=True,
                              smooth=False, correct=True))
    cf.correction_sweep.launches = 0
    rm.row_matmul.launches = 0
    ea.expm_action.launches = 0
    pf.post_fit.launches = 0
    t = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        results = bootstrap.sweep_many(scenarios, maxiter=MATRIX_MAXITER, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = cf.correction_sweep.launches
    rm_launches = rm.row_matmul.launches
    ea_launches = ea.expm_action.launches
    pf_launches = pf.post_fit.launches
    require(rm_launches > 0, "scenarios: row_matmul never launched")
    require(ea_launches > 0, "scenarios: expm_action never launched")
    calls = sum(r.calls for r in results.values())
    for ln in buf.getvalue().splitlines():
        if ln.startswith("# sweep stage"):
            log(f"scenarios {ln[2:]}")
    require(launches == calls, f"scenarios: {launches} kernel launches for {calls} objective calls")
    for name, res in results.items():
        inp, data, splits, _ = inputs[name]
        require(np.isfinite(res.llh).all(), f"scenarios {name}: non-finite llh")
        am = res.llh.argmax(0)
        hist = {str(splits[i]): int((am == i).sum()) for i in sorted(set(am.tolist()))}
        ci = bootstrap.split_time_confidence_interval(res, inp.times, inp.scale_time)
        if res.params.shape[-1] == 0:
            require(hist == table[name]["argmax_hist"],
                    f"scenarios {name}: argmax histogram {hist} != {table[name]['argmax_hist']}")
        log(f"scenarios {name}: {res.llh.size} cells, {res.params.shape[-1]} parameters, "
            f"{int(res.nfev.sum())} llh evals, {res.calls} objective calls, unconverged "
            f"{int((~res.converged).sum())} at --maxiter {MATRIX_MAXITER}, parameters in "
            f"{res.params.dtype}, argmax {hist} (float64 reference {table[name]['argmax_hist']}, "
            f"float32 TPU table {old[name]['argmax_hist']}), split CI [{ci['ci'][0]:.6f}, "
            f"{ci['ci'][1]:.6f}] (float64 reference {table[name]['split_ci_gens']}, float32 TPU "
            f"table {old[name]['split_ci_gens']})")
    log(f"scenarios: {len(results)} scenarios resident in one process, {wall:.2f} s, "
        f"{calls} objective calls = {launches} kernel launches; per objective call: row_matmul "
        f"{rm_launches / calls:.2f}, expm_action {ea_launches / calls:.2f}, post_fit "
        f"{pf_launches / calls:.2f} launches")

    # the per-lane kernel at the two-band scenario's first-stage width
    name = MATRIX_SCENARIOS[0]
    inp, data, splits, mi = inputs[name]
    fs = build_fused_sweep(inp.times, inp.lambdas, splits, mi, sample_date=inp.sample_date_discr,
                           unfolded=True, smooth=False, cpfit=True, device=dev)
    cells = len(splits) * data.shape[0]
    st_all = torch.arange(len(splits), device=dev).repeat_interleave(data.shape[0])
    data_all = torch.as_tensor(np.tile(data, (len(splits), 1)), dtype=fs.dtype, device=dev)
    x0_all = torch.as_tensor(np.tile(fs.init_params, (cells, 1)), dtype=fs.dtype, device=dev)
    ms, points = _nm_iteration_ms(torch, fs, torch.arange(cells, device=dev), data_all, st_all,
                                  x0_all)
    log(f"scenarios {name}: one Nelder-Mead iteration {ms:.1f} ms at {cells} cells "
        f"({points.shape[0] * points.shape[1]} lanes)")
    W, P, n = points.shape
    call = lambda: fs.llh(st_all.repeat_interleave(P), points.reshape(W * P, n),  # noqa: E731
                          data_all.repeat_interleave(P, dim=0))
    return [_sweep_kernel_record(cf, torch, fs, points, st_all, launches,
                                 "correction_sweep_cpfit_per_lane_two_band"),
            row_matmul_record(rm, torch, "row_matmul_collapse_two_band",
                              capture_row_matmul(call), rm_launches),
            expm_action_record(ea, torch, "expm_action_k2_two_band",
                               capture_expm_action(call, 44, 24), ea_launches),
            post_fit_record(pf, torch, "post_fit_cpfit_two_band", capture_post_fit(call),
                            pf_launches, calls)]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from misti_tpu_torch import bench
    from misti_tpu_torch.kernels import correction_fused as cf
    from misti_tpu_torch.kernels import expm_action as ea
    from misti_tpu_torch.kernels import post_fit as pf
    from misti_tpu_torch.kernels import row_matmul as rm

    dev = torch.device("cuda", 0)
    gpu = gpu_line()
    log(f"gpu: {gpu}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    report = cf.compile_libs(cf.build_jobs(force=True) + rm.build_jobs(force=True)
                             + ea.build_jobs(force=True) + pf.build_jobs(force=True))
    log(f"build: {time.perf_counter() - t0:.1f} s wall for {len(report)} libraries")
    for lib, (secs, ptxas, _) in sorted(report.items()):
        lines = [ln.strip() for ln in ptxas.splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        log(f"  {lib}: {secs:.1f} s")
        for ln in lines:
            log(f"    {ln}")

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        log(f"phase {name}: {time.perf_counter() - t:.1f} s wall")
        return out

    phase("1 attrs", phase_attrs, cf, rm, ea, torch)
    phase("2 kernels", phase_kernels, cf, rm, ea, torch, dev)
    kernels = phase("3 main path", phase_main_path, cf, rm, ea, torch, dev, bench)
    phase("4 real inputs", phase_real_inputs, torch, dev)
    phase("5 log", phase_log, torch, dev)
    sweep_records, cpfit_run = phase("6 sweep path", phase_sweep, cf, rm, ea, torch, dev)
    kernels += sweep_records
    kernels += phase("7 single fit", phase_single_fit, cf, rm, ea, torch, dev)
    kernels.append(phase("8 sharded sweep", phase_sharded_sweep, cf, rm, ea, torch, dev,
                         cpfit_run))
    kernels += phase("9 scenarios", phase_scenarios, cf, rm, ea, torch, dev)
    log(f"chip_smoke: {time.perf_counter() - t0:.1f} s wall in all")

    log("kernels " + json.dumps({"kernels": kernels}))
    log(json.dumps({"kernels": kernels}))
    log(gpu)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
