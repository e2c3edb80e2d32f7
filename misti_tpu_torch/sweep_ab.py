"""Compare builds of the correction-sweep kernel on one card, in turns.

    python -m misti_tpu_torch.sweep_ab NAME=SOURCE[:FLAG,FLAG...] ... \
        [--cycles 3] [--reps 20] [--out FILE]

Each variant is a kernel source (a path) and extra nvcc flags (``-D`` design
knobs, ``--fmad=false``).  Every (variant, residual mode) library is built
in float64, the likelihood's dtype, with one nvcc, all started together.  On the bench workload's sweep
input (64 intervals, split 28, 4096 candidates, the main path's shapes) the
script then

* times every variant with CUDA events, in turns: each cycle runs the
  variants in order and then in reverse, so drift on the card falls on all
  of them alike;
* holds each against the plain torch version on the same input: max abs
  difference of ``lc`` and of the states, and the number of lanes whose
  ``lc`` differs by more than 1e-6 relative;
* reads each library's registers, spill bytes and resident blocks per SM
  (``misti_correction_sweep_attrs``, where the source has it) and the
  ``ptxas -v`` lines.

Prints the card's name and power limit, one line per measurement, and
writes everything to ``--out`` (JSON).  Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from . import bench
from .engine.likelihood import build_likelihood
from .kernels import correction_fused as cf

S_SPLIT, BATCH = bench.SPLIT, 4096
# older sources take their scalar type from MISTI_T; the current one is
# float64 only and ignores it
BUILD_FLAGS = ("-DMISTI_T=double",)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def parse_variant(text: str):
    name, _, rest = text.partition("=")
    src, _, flags = rest.partition(":")
    return name, Path(src), tuple(f for f in flags.split(",") if f)


def main_path_input(mode: str, dev):
    """The sweep input and options that llh_batch hands the kernel."""
    lik = build_likelihood(bench.bench_spec(mode), device=dev, dtype=torch.float64)
    mi, pu = lik.map_params(bench.bench_params(BATCH, dev, torch.float64))
    s = lik.spec.splitT
    return cf.sweep_inputs(mi[:, :s], pu[:, :s], *lik.sweep_tables), lik.sweep_opts


def launcher(lib, inp, opts):
    s, B = inp.shape[1], inp.shape[2]
    out = torch.empty((8, s, B), dtype=inp.dtype, device=inp.device)

    def run():
        err = lib.sweep(inp.data_ptr(), out.data_ptr(), s, B, int(opts["static_no_mig"]),
                        int(opts["has_pulse"]), float(opts["mixture_th"]), 2, 8, 2, 8,
                        torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out

    return run


def cuda_ms(fn, reps: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ptxas_lines(log: str) -> list:
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "error" in ln.lower()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="+")
    ap.add_argument("--cycles", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default="build/sweep_ab.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_ab: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gpu = gpu_line()
    print(f"gpu: {gpu}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    variants = [parse_variant(v) for v in args.variants]
    modes = ("cpfit", "ect")

    jobs = []
    for name, src, flags in variants:
        for m in modes:
            out = cf.BUILD_DIR / "ab" / f"{name}_{m}.so"
            jobs.append((out, src, (*BUILD_FLAGS, f"-DMISTI_CPFIT={int(m == 'cpfit')}",
                                    *flags)))
    t0 = time.perf_counter()
    report = cf.compile_libs(jobs, check=False)
    print(f"build: {len(jobs)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)
    result = {"gpu": gpu, "variants": [[n, str(s), list(f)] for n, s, f in variants],
              "builds": {}, "cases": []}
    libs = {}
    for (out, *_), (lib_name, (secs, log, ok)) in zip(jobs, report.items()):
        result["builds"][lib_name] = {"seconds": secs, "ok": ok, "ptxas": ptxas_lines(log)}
        print(f"  {lib_name}: {'ok' if ok else 'FAILED'} {secs:.1f} s", flush=True)
        if not ok:
            print(log[-3000:], flush=True)
            continue
        libs[lib_name] = cf.bind(out)
        if libs[lib_name].attrs is not None:
            attrs = cf.lib_attrs(libs[lib_name], S_SPLIT)
            result["builds"][lib_name]["attrs"] = attrs
            for a in attrs:
                print(f"    snm={int(a['static_no_mig'])} pulse={int(a['has_pulse'])}: "
                      f"{a['registers']} registers, {a['local_bytes']} B local, "
                      f"{a['blocks_per_sm']} blocks/SM", flush=True)
        for ln in ptxas_lines(log):
            print(f"    {ln}", flush=True)

    for m in modes:
        inp, opts = main_path_input("" if m == "cpfit" else "ect", dev)
        want = cf.correction_sweep_plain(inp, **opts)
        fin = torch.isfinite(want)
        runs = {}
        for name, _, _ in variants:
            key = f"{name}_{m}.so"
            if key in libs:
                runs[name] = launcher(libs[key], inp, opts)
        times = {n: [] for n in runs}
        order = list(runs)
        for _ in range(args.cycles):
            for n in order + order[::-1]:
                times[n].append(cuda_ms(runs[n], args.reps))
        for n, run in runs.items():
            got = run().clone()
            torch.cuda.synchronize()
            lc, lw = got[:2], want[:2]
            rel = ((lc - lw).abs() / lw.abs())[fin[:2]]
            lanes = int(((lc - lw).abs() > 1e-6 * lw.abs()).logical_and(fin[:2])
                        .any(0).any(0).sum())
            case = {
                "variant": n, "mode": m, "s": inp.shape[1], "B": inp.shape[2],
                "ms": sorted(times[n]), "ms_median": sorted(times[n])[len(times[n]) // 2],
                "max_abs_lc": float((lc - lw)[fin[:2]].abs().max()),
                "max_abs_p": float((got[2:] - want[2:])[fin[2:]].abs().max()),
                "max_rel_lc": float(rel.max()) if rel.numel() else 0.0,
                "lanes_lc_rel_gt_1e-6": lanes,
                "nan_masks_equal": bool(torch.equal(torch.isnan(got), torch.isnan(want))),
            }
            result["cases"].append(case)
            print(f"{m} {n}: median {case['ms_median']:.4f} ms "
                  f"(min {min(times[n]):.4f}, max {max(times[n]):.4f}, {len(times[n])} x "
                  f"{args.reps} launches); vs plain max|dlc| {case['max_abs_lc']:.3e} "
                  f"max|dp| {case['max_abs_p']:.3e} max rel dlc {case['max_rel_lc']:.3e}, "
                  f"{lanes} lanes > 1e-6 rel, NaN masks equal {case['nan_masks_equal']}",
                  flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
