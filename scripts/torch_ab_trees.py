#!/usr/bin/env python3
"""Compare checkouts of the port on one card, in turns (e.g. parent, change,
change, parent).

    python scripts/torch_ab_trees.py TREE [TREE ...] [--out FILE]
        [--device cpu --rows R]   (a dry run: the CPU, R bootstrap rows)

Each TREE is the root of a checkout (the repo itself is "."); each is run in
a process of its own with that checkout's package, in the order given, and
measures on the north-star command (tests/fixtures/sweep*.psmc + sweep.jsfs,
``--splits 20 27 -bs 100 -mi 1 4 ST 3 1 -uf``, bootstrap seed 0):

* one lockstep Nelder-Mead iteration over all 808 cells (4848 lanes) in a
  float32 run, cpfit and ECT: the wall of a 4-iteration fit less that of a
  1-iteration fit, over 3;
* one objective call of that width under torch.profiler (cpfit, ECT): CUDA
  kernel launches, their device time and its share of the call's wall, and
  the five kernels with the most device time (ms, launches);
* the north-star single fit at split 24, row 0, cpfit and ECT (float64,
  as the single-fit CLI runs it): wall, objective calls, ms per call, CUDA
  kernel launches per call (torch.profiler on one call of its 6 lanes),
  and each hand kernel's launches per call where the checkout counts them;
* the post-split fit (``post_split_fit``, the ``post_fit`` kernel on the
  card): its device time in each profiled call, and a digest (SHA-256 of
  the outputs' bytes) of its outputs in both residual modes on chip_smoke.py
  phase 2's synthetic inputs and on the inputs the paths give it (the
  bench's 4096 lanes, the sweep's profiled call, the single fit's), so that
  two checkouts' kernels can be shown bitwise equal.

Prints one JSON object per run and the card's name and power limit; with
``--out`` also writes them to FILE.  Builds each checkout's kernels into its
own build/ at first use.  Needs a card.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import os
import subprocess
import sys
import time

FIX = "tests/fixtures"
SPLITS = [float(v) for v in range(20, 28)]
MI = [["1", "4", "ST", "3", "1"]]
# chip_smoke.py phase 2's post_fit cases: (lanes, per-lane tables, intervals)
PF_CASES = ((6, False, 35), (6, True, 33), (4851, False, 35), (4851, True, 33), (45, True, 200))


def post_fit_inputs(torch, dev, B, n, per_lane, seed):
    """chip_smoke.py's `post_fit_inputs`: (nc, lh_post, T_post), float64."""
    import numpy as np

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


def digest(outs) -> str:
    h = hashlib.sha256()
    for o in outs:
        h.update(o.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


class Capture:
    """Records the arguments of the first post-split fit of the likelihood
    (engine/likelihood.py) and of the grid sweep (engine/sweep_fused.py)
    while active."""

    def __init__(self):
        from misti_tpu_torch.engine import likelihood as lk
        from misti_tpu_torch.engine import sweep_fused as sf

        self.mods, self.seen = (lk, sf), []

    def __enter__(self):
        for m in self.mods:
            orig = m.post_split_fit

            def rec(*a, _orig=orig, **kw):
                if not self.seen:
                    self.seen.append((a, kw))
                return _orig(*a, **kw)

            m.post_split_fit, m._ab_orig = rec, orig
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m.post_split_fit = m._ab_orig


def measure(device: str, rows: int) -> dict:
    """The measurements of this process's checkout (its root is the cwd)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from misti_tpu_torch import build_likelihood, build_spec
    from misti_tpu_torch.engine import bootstrap
    from misti_tpu_torch.engine.bootstrap import _lane_objective
    from misti_tpu_torch.engine.optimize import nelder_mead, solve
    from misti_tpu_torch.engine.sweep_fused import build_fused_sweep
    from misti_tpu_torch.io import jsfs as io_jsfs
    from misti_tpu_torch.io import psmc as io_psmc
    from misti_tpu_torch.kernels import correction_fused, row_matmul

    counters = {"correction_sweep": correction_fused.correction_sweep,
                "row_matmul": row_matmul.row_matmul}
    for name in ("expm_action", "post_fit"):  # hand kernels a checkout may not have
        try:
            counters[name] = getattr(importlib.import_module(f"misti_tpu_torch.kernels.{name}"),
                                     name)
        except ImportError:
            pass

    from misti_tpu_torch.bench import bench_params, bench_spec
    from misti_tpu_torch.engine import likelihood as lk

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    digests = {}

    def post_fit_digests(name, captured):
        (nc, lh, T), kw = captured
        for cpfit in (False, True):
            digests[f"{name}, fit as {'cpfit' if cpfit else 'ect'}"] = digest(
                lk.post_split_fit(nc, lh, T, cpfit=cpfit))

    for B, per_lane, n in PF_CASES:
        post_fit_digests(f"phase2 B={B} n={n} {'per-lane' if per_lane else 'shared'}",
                         (post_fit_inputs(torch, dev, B, n, per_lane, B), {}))
    for mode in ("", "ect"):
        lik = build_likelihood(bench_spec(mode), device=dev, dtype=torch.float64)
        with Capture() as cap:
            lik.llh_batch(bench_params(4096, dev, torch.float64))
        post_fit_digests(f"bench {mode or 'cpfit'}", cap.seen[0])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    inp = io_psmc.read_psmc(f"{FIX}/sweep1.psmc", f"{FIX}/sweep2.psmc", 0, -1)
    data = bootstrap.make_bootstrap_data(io_jsfs.read_jafs(f"{FIX}/sweep.jsfs"), rows, seed=0)
    out = {"checkout": os.getcwd()}

    def profiled(fn):
        fn()
        sync()
        t = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            fn()
            sync()
        ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in ev) / 1e3  # ms
        top = sorted(ev, key=lambda e: e.self_device_time_total, reverse=True)[:5]
        pf = [e for e in ev if "post_fit" in e.key]
        return {"wall_ms": wall * 1e3, "launches": sum(e.count for e in ev),
                "device_ms": busy, "busy_share": busy / (wall * 1e3),
                "post_fit_device_ms": sum(e.self_device_time_total for e in pf) / 1e3,
                "post_fit_launches_seen": sum(e.count for e in pf),
                "top_kernels_ms": {e.key[:80]: [e.self_device_time_total / 1e3, e.count]
                                   for e in top}}

    n_cells = len(SPLITS) * data.shape[0]
    st = torch.arange(len(SPLITS), device=dev).repeat_interleave(data.shape[0])
    d = torch.as_tensor(np.tile(data, (len(SPLITS), 1)), dtype=torch.float32, device=dev)
    for mode, cpfit in (("cpfit", True), ("ect", False)):
        fs = build_fused_sweep(inp.times, inp.lambdas, SPLITS, MI, sample_date=inp.sample_date_discr,
                               unfolded=True, smooth=True, cpfit=cpfit, device=dev,
                               dtype=torch.float32)
        x0 = torch.as_tensor(np.tile(fs.init_params, (n_cells, 1)), dtype=torch.float32,
                             device=dev)
        seen = []
        f = _lane_objective(fs.llh, st, d, [0])

        def obj(points):
            seen.append(points)
            return f(points)

        walls = []
        for iters in (1, 1, 4):  # the first run warms up
            sync()
            t = time.perf_counter()
            nelder_mead(obj, x0, maxiter=iters)
            sync()
            walls.append(time.perf_counter() - t)
        W, P, n = seen[1].shape
        lanes = (st.repeat_interleave(P), seen[1].reshape(W * P, n), d.repeat_interleave(P, dim=0))
        out[f"{mode}_iteration_ms"] = (walls[2] - walls[1]) / 3 * 1e3
        out[f"{mode}_call"] = profiled(lambda: fs.llh(*lanes))
        out[f"{mode}_call"]["lanes"] = W * P
        with Capture() as cap:
            fs.llh(*lanes)
        post_fit_digests(f"sweep {mode}", cap.seen[0])

    sfs = list(io_jsfs.read_jafs(f"{FIX}/sweep.jsfs").jafs[0])
    for mode, cpfit in (("cpfit", True), ("ect", False)):
        spec = build_spec(inp.times, inp.lambdas, sfs, 24, [[1, 4, 24, 3.0, 1]], [],
                          cpfit=cpfit, smooth=True, unfolded=True,
                          sample_date=inp.sample_date_discr, thrh=(inp.theta, inp.rho))
        lik = build_likelihood(spec, device=dev, dtype=torch.float64)
        calls = [0]
        inner = lik.llh_flags_batch

        def counted(p, inner=inner):
            calls[0] += 1
            return inner(p)

        lik.llh_flags_batch = counted
        solve(lik)  # warm-up
        calls[0] = 0
        before = {k: c.launches for k, c in counters.items()}
        sync()
        t = time.perf_counter()
        res = solve(lik)
        sync()
        wall = time.perf_counter() - t
        points = torch.as_tensor(res.x, dtype=torch.float64, device=dev) * (
            1.0 + 0.01 * torch.arange(6, dtype=torch.float64, device=dev))[:, None]
        out[f"single_fit_{mode}"] = {
            "wall_s": wall, "calls": calls[0], "ms_per_call": wall / calls[0] * 1e3,
            "x": res.x.tolist(), "llh": res.llh,
            "hand_kernel_launches_per_call": {k: (c.launches - before[k]) / calls[0]
                                              for k, c in counters.items()},
            "call": profiled(lambda: inner(points))}
        with Capture() as cap:
            inner(points)
        post_fit_digests(f"single fit {mode}", cap.seen[0])
    out["post_fit_digests"] = digests
    return out


def gpu_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("trees", nargs="*")
    p.add_argument("--out", default="")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu (a dry run)")
    p.add_argument("--rows", type=int, default=100, help="bootstrap replicates (default 100)")
    p.add_argument("--inner", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.inner:
        sys.path.insert(0, os.getcwd())
        print(json.dumps(measure(args.device, args.rows)), flush=True)
        return 0
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_ab_trees: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    lines = [gpu_line() if args.device == "cuda" else "cpu"]
    print(lines[0], flush=True)
    for i, tree in enumerate(args.trees):
        root = os.path.abspath(tree)
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--inner", "--device",
                               args.device, "--rows", str(args.rows)], cwd=root,
                              capture_output=True, text=True,
                              env=dict(os.environ, PYTHONPATH=root))
        if proc.returncode != 0:
            print(proc.stdout[-3000:], proc.stderr[-6000:], file=sys.stderr)
            return proc.returncode
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec = {"run": i, "tree": tree, "process_wall_s": time.perf_counter() - t, **rec}
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)
    runs = [json.loads(ln) for ln in lines[1:]]
    if len(runs) > 1:
        same = {k: len({r["post_fit_digests"][k] for r in runs}) == 1
                for k in runs[0]["post_fit_digests"]}
        lines.append(json.dumps({"post_fit_digests_equal": all(same.values()),
                                 "cases": same}))
        print(lines[-1], flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
