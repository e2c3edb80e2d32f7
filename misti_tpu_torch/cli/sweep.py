"""Bootstrap x split-time sweep CLI: upstream's test.bs workflow on the GPU.

One invocation replaces the reference's nested bash loops
(test.bs/han_fre.bs.sh:29-37: `for bs in {0..100}; for st in {10..17}:
MiSTI.py ... -bs $bs` under GNU Parallel) with one lockstep Nelder-Mead over
the whole grid, and the grep/awk + notebook post-processing with a results
table and a Student-t confidence interval printed directly.

Usage:
    python -m misti_tpu_torch.cli.sweep <fpsmc1> <fpsmc2> <fjafs> \
        --splits 10 17 -bs 100 -mi 1 4 ST 3 1 -uf [--cpfit] -o out.npz \
        [--platform cuda|cpu]

Under ``python -m torch.distributed.run --standalone --nproc-per-node N -m
misti_tpu_torch.cli.sweep ...`` the cells are split over N processes (one
device each, ``cuda:(LOCAL_RANK % device count)``; all share the card of a
one-card machine), and rank 0 prints the cell lines and the summary and
writes ``-o``.  The summary then also gives ``processes``, the objective
calls of the busiest rank and of all ranks, and each rank's kernel launches
(the correction sweep's, ``post_fit``'s, the spectrum's and the Nelder-Mead
update's).

Migration/pulse templates accept the literal ``ST`` for the split index,
like the shell variable in the reference scripts.  Output: greppable
per-cell lines (`bs_id = ... splitT = ... llh = ...`), an .npz results
table, and the split-time CI.  ``--platform`` defaults to ``cuda`` and
raises without a card; ``cpu`` runs on the CPU.  Both run in float64.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Bootstrap x split-time sweep (test.bs workflow on the GPU)."
    )
    p.add_argument("fpsmc1", nargs="?", default=None)
    p.add_argument("fpsmc2", nargs="?", default=None)
    p.add_argument("fjafs", nargs="?", default=None,
                   help="JSFS file with chunk rows (for bootstrap)")
    p.add_argument("--splits", nargs=2, type=float, default=None,
                   metavar=("FIRST", "LAST"),
                   help="inclusive split-time index range")
    p.add_argument("--scenarios", default="",
                   help="JSON manifest of a scenario matrix to run in this "
                        "process (the reference's 16-script test.bs/ suite "
                        "shape): a list of objects with fpsmc1, fpsmc2, "
                        "fjafs, splits=[first, last], name, and optional "
                        "per-scenario mi/pu/sdate/rd overrides "
                        "(engine/bootstrap.py sweep_many)")
    p.add_argument("-bs", "--bsSize", type=int, default=100,
                   help="number of bootstrap replicates (plus the full data row)")
    p.add_argument("-mi", nargs=5, action="append", default=None,
                   help="migration template: srcPop start end|ST rate fixed/opt")
    p.add_argument("-pu", nargs=4, action="append", default=None,
                   help="pulse template: srcPop time rate fixed/opt")
    p.add_argument("-tol", type=float, default=1e-4)
    p.add_argument("-uf", action="store_true", help="unfolded spectrum")
    p.add_argument("--cpfit", action="store_true")
    p.add_argument("--nosmooth", action="store_true")
    p.add_argument("--trueEPS", action="store_true")
    p.add_argument("--sdate", type=float, default=0)
    p.add_argument("-rd", type=int, default=-1)
    p.add_argument("--funits", type=str, default="setunits.txt")
    p.add_argument("--seed", type=int, default=0, help="bootstrap seed")
    p.add_argument("-o", "--fout", default="", help="output .npz results table")
    p.add_argument("--platform", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default; raises without a card) or cpu, "
                        "float64 on both")
    p.add_argument("--profile", default="",
                   help="directory for a torch.profiler trace of the sweep with "
                        "the port's spans (trace.json) and the span records "
                        "(spans.jsonl); the device's busy time over the profiled "
                        "wall and the top kernels go to stderr")
    p.add_argument("--stages", nargs="+", type=int, default=None,
                   metavar="CAP",
                   help="straggler-compaction iteration caps (default "
                        "16 32 64 128 256; the final stage always runs to "
                        "--maxiter)")
    p.add_argument("--maxiter", type=int, default=1000,
                   help="Nelder-Mead iteration budget per fit")
    return p


class _Profile:
    """torch.profiler around the sweep, with the port's spans recorded
    (misti_tpu_torch/spans.py): in ``directory`` a Chrome trace,
    ``trace.json``, which holds the spans as host events beside the kernels,
    and the span records, ``spans.jsonl``; on stderr the device's busy time
    (the union of its operations, the profiler's annotation ranges left
    out) over the profiled wall, the kernels and the top kernels."""

    def __init__(self, directory: str):
        import torch
        from torch.profiler import ProfilerActivity, profile

        from ..spans import recording

        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.recording = recording()

    def __enter__(self):
        self.prof.__enter__()  # starting the tracer takes seconds: not in the wall
        self.records = self.recording.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch
        from torch.autograd import DeviceType

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = (time.perf_counter() - self.t0) * 1e3
        self.recording.__exit__(*exc)
        self.prof.__exit__(*exc)
        self.prof.export_chrome_trace(os.path.join(self.directory, "trace.json"))
        with open(os.path.join(self.directory, "spans.jsonl"), "w") as f:
            for r in self.records:
                f.write(json.dumps(r) + "\n")
        names = {r["name"] for r in self.records}

        def annotation(e):  # a span's range on the device's timeline, not work
            flag = getattr(e, "is_user_annotation", None)
            return e.name() in names or (flag is not None and flag())

        ops = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                     for e in self.prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CUDA and not annotation(e))
        busy, end, by_kernel = 0, 0, {}
        for start, stop, name in ops:  # the union of the operations' intervals
            busy += max(stop - max(start, end), 0)
            end = max(end, stop)
            if not name.startswith(("Memcpy", "Memset")):
                t, k = by_kernel.get(name, (0, 0))
                by_kernel[name] = (t + stop - start, k + 1)
        busy /= 1e6
        print(f"# profile: device busy {busy:.3f} ms over the profiled wall {wall:.3f} ms "
              f"({100 * busy / wall:.1f}% busy), "
              f"{sum(k for _, k in by_kernel.values())} kernels", file=sys.stderr)
        for name, (t, k) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:8]:
            print(f"#   {name[:70]:70s} {t / 1e6:9.3f} ms {k:7d} kernels", file=sys.stderr)


def main(argv=None) -> int:
    clargs = make_parser().parse_args(argv)

    import numpy as np
    import torch

    from ..dist.mesh import all_gather_rows, init_distributed, rank, rank_device, world_size
    from ..engine.bootstrap import (
        make_bootstrap_data,
        split_time_confidence_interval,
        sweep_many,
    )
    from ..io import jsfs as io_jsfs
    from ..io import psmc as io_psmc
    from ..io.units import Units
    from ..kernels.correction_fused import correction_sweep
    from ..kernels.nm_step import nm_step
    from ..kernels.post_fit import post_fit
    from ..kernels.spectrum import spectrum_kernel

    group = init_distributed()  # None unless started by torchrun with WORLD_SIZE > 1
    world, lead = world_size(group), rank(group) == 0
    device = rank_device(clargs.platform)  # raises for cuda without a card

    if lead:
        Units.set_units_from_file(clargs.funits)
        Units.print_units()
    else:
        with contextlib.redirect_stdout(io.StringIO()):
            Units.set_units_from_file(clargs.funits)

    # scenario descriptors: one (single-scenario mode) or a manifest matrix
    if clargs.scenarios:
        with open(clargs.scenarios) as f:
            manifest = json.load(f)
        names = [ent["name"] for ent in manifest]
        if len(set(names)) != len(names):
            dupes = sorted({n for n in names if names.count(n) > 1})
            if lead:
                print(f"error: duplicate scenario names in manifest: {dupes} "
                      "(results are keyed by name)", file=sys.stderr)
            return 2
        mdir = os.path.dirname(os.path.abspath(clargs.scenarios))

        def rel(p):
            return p if os.path.isabs(p) else os.path.join(mdir, p)

        descs = []
        for ent in manifest:
            descs.append(dict(
                name=ent["name"],
                fpsmc1=rel(ent["fpsmc1"]), fpsmc2=rel(ent["fpsmc2"]),
                fjafs=rel(ent["fjafs"]),
                splits=ent["splits"],
                mi=[list(map(str, r)) for r in ent.get("mi", clargs.mi or [])],
                pu=[list(map(str, r)) for r in ent.get("pu", clargs.pu or [])],
                sdate=float(ent.get("sdate", clargs.sdate)),
                rd=int(ent.get("rd", clargs.rd)),
            ))
    else:
        if not (clargs.fpsmc1 and clargs.fpsmc2 and clargs.fjafs
                and clargs.splits):
            if lead:
                print("error: either --scenarios MANIFEST or fpsmc1 fpsmc2 "
                      "fjafs --splits are required", file=sys.stderr)
            return 2
        descs = [dict(name="", fpsmc1=clargs.fpsmc1, fpsmc2=clargs.fpsmc2,
                      fjafs=clargs.fjafs, splits=clargs.splits,
                      mi=[list(r) for r in (clargs.mi or [])],
                      pu=clargs.pu or [], sdate=clargs.sdate, rd=clargs.rd)]

    # host-side IO for every scenario up front
    scenarios = []
    meta = []
    for d in descs:
        data_jafs = io_jsfs.read_jafs(d["fjafs"])
        input_data = io_psmc.read_psmc(d["fpsmc1"], d["fpsmc2"], d["sdate"],
                                       d["rd"])
        data = make_bootstrap_data(data_jafs, clargs.bsSize, seed=clargs.seed)
        splits = [float(v) for v in
                  np.arange(d["splits"][0], d["splits"][1] + 1)]
        scenarios.append(dict(
            name=d["name"], times=input_data.times,
            lambdas=input_data.lambdas, data=data, splits=splits,
            mi_template=d["mi"], pu_template=d["pu"],
            sample_date=input_data.sample_date_discr,
            unfolded=clargs.uf, cpfit=clargs.cpfit,
            smooth=not clargs.nosmooth, correct=not clargs.trueEPS,
        ))
        meta.append(input_data)

    # rank 0 profiles its own process
    prof = _Profile(clargs.profile) if clargs.profile and lead else None
    if prof is not None:
        prof.__enter__()
    t0 = time.time()
    stage_kw = {} if clargs.stages is None else {
        "stage_caps": tuple(clargs.stages)
    }
    per_scn_dt = []
    launches = []
    results = {}
    # one-scenario sweep_many calls rather than one batch call, to time each
    # scenario for the summary
    for sc in scenarios:
        t_sc = time.time()
        kernels = (correction_sweep, post_fit, spectrum_kernel, nm_step)
        before = [k.launches for k in kernels]
        results.update(sweep_many([sc], tol=clargs.tol, maxiter=clargs.maxiter,
                                  device=device, group=group, **stage_kw))
        per_scn_dt.append(time.time() - t_sc)
        n = torch.tensor([[k.launches - b for k, b in zip(kernels, before)]])
        launches.append(all_gather_rows(n, group, world).T.tolist())
    if prof is not None:
        prof.__exit__(None, None, None)
    dt = time.time() - t0
    if not lead:
        return 0

    matrix = []
    for sc, input_data, dt_sc, launched in zip(scenarios, meta, per_scn_dt, launches):
        res = results[sc["name"]]
        splits = sc["splits"]
        data = sc["data"]
        tag = f"scenario = {sc['name']} \t" if sc["name"] else ""
        # per-cell greppable lines (reference MiSTI.py:240 format)
        for si, st in enumerate(splits):
            tgen = sum(input_data.times[0 : int(np.ceil(st))]) \
                * input_data.scale_time
            for b in range(data.shape[0]):
                params = ", ".join(str(v) for v in res.params[si, b])
                # row 0 is the unresampled spectrum = bs 0, rows 1..N the
                # replicates (utils/generateJSFS_bs.py convention)
                print(
                    f"{tag}bs_id = {b} \tsplitT = {st} \ttime = {tgen} "
                    f"\tmigration rates optim = [{params}] "
                    f"\tllh = {res.llh[si, b]}"
                )

        ci = split_time_confidence_interval(res, input_data.times,
                                            input_data.scale_time)
        n_cells = len(splits) * data.shape[0]
        # per-replicate argmax histogram: the spread the Student-t CI is
        # built from (bs_conf_int.ipynb cell 2's value_counts)
        am = res.llh.argmax(axis=0)
        hist = {str(res.split_times[i]): int((am == i).sum())
                for i in sorted(set(am.tolist()))}
        summary = {
            "cells": n_cells,
            "wallclock_s": round(dt_sc, 3),
            "cells_per_s": round(n_cells / dt_sc, 3),
            "split_mean_gens": float(ci["mean"]),
            "split_ci_gens": [float(ci["ci"][0]), float(ci["ci"][1])],
            "ci_level": ci["level"],
            "argmax_hist": hist,
        }
        if sc["name"]:
            summary = {"scenario": sc["name"], **summary}
        if res.nfev is not None:
            # likelihood evaluations performed across all lockstep fits
            # (reference COUNT_LLH; the reference does ~5.7 of these per
            # core-second, BASELINE.md)
            evals = int(res.nfev.sum())
            summary["llh_evals"] = evals
            summary["evals_per_s"] = round(evals / dt_sc, 1)
            summary["vs_baseline_1core"] = round(evals / dt_sc / 5.7, 1)
        if group is not None:
            summary["processes"] = world
            summary["objective_calls"] = {"max": res.calls, "sum": res.calls_sum}
            summary["kernel_launches"] = launched[0]
            summary["post_fit_launches"] = launched[1]
            summary["spectrum_launches"] = launched[2]
            summary["nm_step_launches"] = launched[3]
        print(json.dumps(summary))
        matrix.append(summary)
        if clargs.fout:
            fout = clargs.fout
            if sc["name"]:
                base, ext = os.path.splitext(fout)
                fout = f"{base}.{sc['name']}{ext}"
            extra = {} if res.nfev is None else {"nfev": res.nfev}
            np.savez(
                fout, split_times=res.split_times, params=res.params,
                llh=res.llh, data=res.data,
                times=np.asarray(input_data.times),
                scale_time=input_data.scale_time, **extra,
            )
            print("results table written to", fout)
    if len(scenarios) > 1:
        print(json.dumps({
            "matrix_scenarios": len(scenarios),
            "matrix_wallclock_s": round(dt, 3),
            "matrix_cells": int(sum(m["cells"] for m in matrix)),
            "matrix_llh_evals": int(sum(m.get("llh_evals", 0)
                                        for m in matrix)),
            # distinct grid shapes and static flags: the JAX CLI's count of
            # compiled sweep programs
            "shared_programs": len({r.shape_key for r in results.values()}),
        }))
    return 0


if __name__ == "__main__":
    rc = main()
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    sys.exit(rc)
