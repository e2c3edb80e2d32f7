#!/usr/bin/env python3
"""The 16-scenario sweep matrix through the port's sweep CLI on one card.

    python scripts/torch_matrix_card.py [--only GLOB] [--ect] [--maxiter N] [--out FILE]
    python scripts/torch_matrix_card.py --merge FILE ... [--out MATRIX_torch_h100.json]

Runs ``python -m misti_tpu_torch.cli.sweep --scenarios
tests/fixtures/matrix/matrix.json -bs 100 -uf --nosmooth --cpfit`` (the JAX
package's command of MATRIXBENCH_r05.json; ``--ect`` drops ``--cpfit``), in
this process, on the scenarios whose names match ``--only`` (fnmatch, e.g.
'pair3.*'), float32 parameters on the card (the likelihood computes in
float64), and judges every scenario:

cpfit, against the JAX package's TPU table (MATRIXBENCH_r05.json
``per_scenario``, cell lines in scripts/matrix_r05.out):
  * every llh finite;
  * the argmax histogram equal to the table's;
  * both ends of the CI within 0.01 generations of the table's;
  * on the cells converged in this run, this fit's float64 llh on the card
    no lower than the float64 llh at the table's parameters minus 5e-2.
  Scenarios whose table CI has zero width are marked ``degenerate``: a
  histogram match there is a weak gate.

ECT (no JAX table): every llh finite, and for 3 bootstrap rows x every split
of each fitted scenario a float64 re-fit on the card (the same sweep in
float64, ``--maxiter`` REFIT_MAXITER); on cells converged in both, this run's fit's
float64 llh no lower than the float64 fit's minus 5e-2.

Every entry records the wall, llh evaluations, objective calls and kernel
launches, unconverged cells, the histogram and CI, the judge, and the card's
``nvidia-smi`` name and power limit.  Writes ``--out`` (one entry per scenario
and mode) and exits 1 if a gate failed.  ``--merge`` combines such files into
one (later entries replace earlier ones of the same scenario and mode).

A fitted cpfit scenario takes 0.4-5 s on an H100 (ECT more: its
post-split fit), so the whole cpfit matrix fits in one process; one
scenario group per process, e.g.
    python scripts/torch_matrix_card.py --only 'pair3.*' --out matrix_pair3_cpfit.json
"""

from __future__ import annotations

import argparse
import contextlib
import fnmatch
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFEST = os.path.join(REPO, "tests", "fixtures", "matrix", "matrix.json")
TABLE_JSON = os.path.join(REPO, "MATRIXBENCH_r05.json")
TABLE_OUT = os.path.join(REPO, "scripts", "matrix_r05.out")
BOOTSTRAPS = 100
LLH_LIMIT = 5e-2  # nats, float64, as chip_smoke.py's judge of the north-star sweep
CI_LIMIT = 0.01  # generations
REFIT_ROWS = (0, 1, 2)
REFIT_MAXITER = 200  # iteration budget of the ECT float64 re-fits
_CELL = re.compile(r"scenario = (?P<scenario>\S+) \tbs_id = (?P<bs>\d+) \tsplitT = "
                   r"(?P<split>\S+) \ttime = \S+ \tmigration rates optim = \[(?P<params>[^\]]*)\]"
                   r" \tllh = (?P<llh>\S+)")


def parse_cells(lines) -> dict:
    """Cell lines of the sweep CLI (``scenario = ... bs_id = ... splitT = ...
    migration rates optim = [...] llh = ...``) -> {scenario: {(split, bs):
    (params tuple, llh)}}; other lines are skipped."""
    out: dict = {}
    for ln in lines:
        m = _CELL.match(ln)
        if m is None:
            continue
        params = tuple(float(v) for v in m["params"].split(",") if v.strip())
        out.setdefault(m["scenario"], {})[(float(m["split"]), int(m["bs"]))] = (
            params, float(m["llh"]))
    return out


def table_params(cells: dict, splits, n_rows: int, n_par: int) -> np.ndarray:
    """(S, B, n) parameters of one scenario's table cells."""
    out = np.zeros((len(splits), n_rows, n_par))
    for i, st in enumerate(splits):
        for b in range(n_rows):
            out[i, b] = cells[(float(st), b)][0]
    return out


def argmax_hist(llh, splits) -> dict:
    am = np.asarray(llh).argmax(axis=0)
    return {str(float(splits[i])): int((am == i).sum()) for i in sorted(set(am.tolist()))}


def judge_cpfit(llh, params, converged, splits, ci, table, table_par, llh64) -> dict:
    """The cpfit gates of one scenario against its JAX table entry.

    ``llh`` (S, B) float32 llh of this run, ``params`` (S, B, n), ``converged``
    (S, B), ``ci`` this run's split_time_confidence_interval, ``table`` the
    MATRIXBENCH per_scenario entry, ``table_par`` (S, B, n) its parameters,
    ``llh64(params (S, B, n), cells (k,) flat indices)`` the float64 llh on
    the card.  Returns the gates, their numbers and ``ok``."""
    hist = argmax_hist(llh, splits)
    ci_t = table["split_ci_gens"]
    d_ci = max(abs(ci["ci"][0] - ci_t[0]), abs(ci["ci"][1] - ci_t[1]))
    shape = np.shape(llh)
    every = np.arange(int(np.prod(shape)))
    l_run, l_tab = llh64(params, every), llh64(table_par, every)
    conv = np.flatnonzero(np.asarray(converged).ravel())
    gain = (l_run - l_tab)[conv]
    worst = [dict(split=float(splits[c // shape[1]]), row=int(c % shape[1]),
                  params=np.asarray(params).reshape(len(every), -1)[c].tolist(),
                  table_params=np.asarray(table_par).reshape(len(every), -1)[c].tolist(),
                  gain64=float(g)) for c, g in sorted(zip(conv.tolist(), gain),
                                                      key=lambda t: t[1])[:5]]
    gates = {
        "finite": bool(np.isfinite(llh).all()),
        "argmax_hist": hist == table["argmax_hist"],
        "ci": bool(d_ci <= CI_LIMIT),
        "float64_llh": bool(gain.size == 0 or gain.min() >= -LLH_LIMIT),
    }
    return {"gates": gates, "ok": all(gates.values()), "table_argmax_hist": table["argmax_hist"],
            "table_split_ci_gens": ci_t, "max_ci_diff_gens": d_ci,
            "degenerate": ci_t[0] == ci_t[1],
            "float64_gain": _stats(gain), "float64_judged_cells": int(conv.size),
            "worst_cells": worst,
            # the argmax in float64 at each table's fits, and at the better
            # fit of the two per cell: which table an argmax difference is in
            "float64_argmax_hist": {
                "run": argmax_hist(l_run.reshape(shape), splits),
                "table": argmax_hist(l_tab.reshape(shape), splits),
                "better_of_both": argmax_hist(np.maximum(l_run, l_tab).reshape(shape), splits)}}


def judge_refit(llh64_f32_fit, llh64_refit, both) -> dict:
    """ECT: the float32 fit's float64 llh against the float64 re-fit's, on the
    cells converged in both (``both``, a bool mask)."""
    gain = (np.asarray(llh64_f32_fit) - np.asarray(llh64_refit))[np.asarray(both)]
    ok = bool(gain.size == 0 or gain.min() >= -LLH_LIMIT)
    return {"gates": {"float64_refit": ok}, "ok": ok, "float64_gain": _stats(gain),
            "float64_judged_cells": int(gain.size)}


def _stats(a) -> dict:
    a = np.asarray(a, float)
    if a.size == 0:
        return {"min": None, "median": None, "max": None}
    return {"min": float(a.min()), "median": float(np.median(a)), "max": float(a.max())}


def gpu_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def run(args) -> dict:
    import torch

    from misti_tpu_torch.cli import sweep as cli
    from misti_tpu_torch.engine import bootstrap
    from misti_tpu_torch.engine.sweep_fused import build_fused_sweep
    from misti_tpu_torch.io import psmc as io_psmc
    from misti_tpu_torch.kernels.correction_fused import correction_sweep

    if args.platform == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False: this script needs a card")
    dev = torch.device(args.platform)
    gpu = gpu_line() if dev.type == "cuda" else "cpu (a dry run)"
    mode = "ect" if args.ect else "cpfit"
    with open(MANIFEST) as f:
        manifest = [e for e in json.load(f) if fnmatch.fnmatch(e["name"], args.only)]
    if not manifest:
        raise SystemExit(f"no scenario matches {args.only!r}")
    mdir = os.path.dirname(MANIFEST)
    for e in manifest:
        for k in ("fpsmc1", "fpsmc2", "fjafs"):
            e[k] = os.path.join(mdir, e[k])
    with open(TABLE_JSON) as f:
        table = {e["scenario"]: e for e in json.load(f)["per_scenario"] if "scenario" in e}
    with open(TABLE_OUT) as f:
        table_cells = parse_cells(f)

    # each scenario's SweepResult and kernel launches, as the CLI runs it
    seen = {}
    sweep_many = bootstrap.sweep_many

    def recording(scenarios, **kw):
        n0 = correction_sweep.launches
        out = sweep_many(scenarios, **kw)
        for name, res in out.items():
            seen[name] = (res, correction_sweep.launches - n0)
        return out

    command = (f"python -m misti_tpu_torch.cli.sweep --scenarios "
               f"{os.path.relpath(MANIFEST, REPO)} -bs {args.bs} -uf --nosmooth"
               f"{'' if args.ect else ' --cpfit'} --maxiter {args.maxiter}")
    entries = {}
    with tempfile.TemporaryDirectory() as tmp:
        for e in manifest:
            # one scenario per CLI call, all in this process, so that each
            # scenario's entry is written as soon as it is judged
            name = e["name"]
            mpath = os.path.join(tmp, "matrix.json")
            with open(mpath, "w") as f:
                json.dump([e], f)
            argv = ["--scenarios", mpath, "-bs", str(args.bs), "-uf", "--nosmooth",
                    "--platform", args.platform, "--maxiter", str(args.maxiter),
                    "--funits", os.path.join(tmp, "none"), "-o", os.path.join(tmp, "r.npz")]
            argv += [] if args.ect else ["--cpfit"]
            buf, err = io.StringIO(), io.StringIO()
            bootstrap.sweep_many = recording
            try:
                with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
                    rc = cli.main(argv)
            finally:
                bootstrap.sweep_many = sweep_many
            if rc != 0:
                raise SystemExit(f"the sweep CLI returned {rc}:\n{err.getvalue()[-4000:]}")
            summ = [json.loads(ln) for ln in buf.getvalue().splitlines()
                    if ln.startswith('{"scenario"')][0]
            stage_lines = [ln[2:] for ln in err.getvalue().splitlines()
                           if ln.startswith("# sweep stage")]
            res, launches = seen[name]
            z = np.load(os.path.join(tmp, f"r.{name}.npz"))
            inp = io_psmc.read_psmc(e["fpsmc1"], e["fpsmc2"], 0, -1)
            splits = [float(v) for v in np.arange(e["splits"][0], e["splits"][1] + 1)]
            mi = [list(map(str, r)) for r in e["mi"]]
            n_par = z["params"].shape[-1]
            fs64 = build_fused_sweep(inp.times, inp.lambdas, splits, mi, (),
                                     sample_date=inp.sample_date_discr, unfolded=True,
                                     smooth=False, cpfit=not args.ect, device=dev,
                                     dtype=torch.float64)
            n_rows = z["data"].shape[0]
            d_all = np.tile(z["data"], (len(splits), 1))

            def llh64(params, cells, fs=fs64, d_all=d_all, n_rows=n_rows, n_par=n_par):
                st = torch.as_tensor(cells // n_rows, device=dev)
                x = np.asarray(params, float).reshape(len(d_all), n_par)[cells]
                return fs.llh(st, x, d_all[cells]).cpu().numpy()

            entry = {
                "scenario": name, "mode": mode, "command": command,
                "gpu": gpu, "cells": int(z["llh"].size), "n_params": int(n_par),
                "wall_s": summ["wallclock_s"], "llh_evals": summ.get("llh_evals"),
                "objective_calls": int(res.calls), "kernel_launches": int(launches),
                "calls_equal_launches": int(res.calls) == int(launches),
                "unconverged": int((~res.converged).sum()),
                "argmax_hist": summ["argmax_hist"], "split_mean_gens": summ["split_mean_gens"],
                "split_ci_gens": summ["split_ci_gens"],
                "stages": stage_lines,
            }
            ci = bootstrap.split_time_confidence_interval(res, inp.times, inp.scale_time)
            if args.ect:
                judged = {"gates": {"finite": bool(np.isfinite(z["llh"]).all())}}
                if n_par:
                    rows = list(REFIT_ROWS)
                    t_refit = time.perf_counter()
                    with contextlib.redirect_stderr(io.StringIO()):
                        ref = bootstrap.sweep(inp.times, inp.lambdas, z["data"][rows], splits,
                                              mi, (), tol=1e-4, device=dev, dtype=torch.float64,
                                              sample_date=inp.sample_date_discr, unfolded=True,
                                              smooth=False, cpfit=False,
                                              maxiter=REFIT_MAXITER)
                    cells = (np.arange(len(splits))[:, None] * n_rows
                             + np.asarray(rows)[None, :]).ravel()
                    f32_fit = llh64(z["params"], cells)
                    both = res.converged.ravel()[cells] & ref.converged.ravel()
                    r = judge_refit(f32_fit, ref.llh.ravel(), both)
                    r["refit_rows"], r["refit_unconverged"] = rows, int((~ref.converged).sum())
                    r["refit_wall_s"] = time.perf_counter() - t_refit
                    judged["gates"].update(r.pop("gates"))
                    judged.update(r)
                judged["ok"] = all(judged["gates"].values())
            else:
                t = table[name]
                tp = table_params(table_cells[name], splits, n_rows, n_par)
                judged = judge_cpfit(z["llh"], z["params"], res.converged, splits, ci, t, tp,
                                     llh64)
                judged["table_llh_evals"] = t["llh_evals"]
            judged["gates"]["calls_equal_launches"] = entry["calls_equal_launches"]
            judged["ok"] = all(judged["gates"].values())
            entry.update(judged)
            entries[f"{mode}:{name}"] = entry
            write(entries, args.out)
            print(json.dumps(entry), flush=True)
    return entries


def write(entries: dict, path: str) -> None:
    doc = {"what": "the 16-scenario sweep matrix (tests/fixtures/matrix/matrix.json) through "
                   "misti_tpu_torch.cli.sweep on one card, float32 parameters and a float64 "
                   "likelihood; scripts/torch_matrix_card.py",
           "entries": dict(sorted(entries.items()))}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--only", default="*", help="fnmatch pattern of scenario names")
    p.add_argument("--ect", action="store_true", help="without --cpfit (no JAX table)")
    p.add_argument("--maxiter", type=int, default=1000)
    p.add_argument("--bs", type=int, default=BOOTSTRAPS,
                   help="bootstrap replicates (the table has 100)")
    p.add_argument("--platform", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default) or cpu (a dry run in float64)")
    p.add_argument("--merge", nargs="+", default=None, metavar="FILE",
                   help="combine these result files instead of running")
    p.add_argument("--out", default=os.path.join(REPO, "MATRIX_torch_h100.json"))
    args = p.parse_args(argv)
    if args.merge:
        entries = {}
        for path in args.merge:
            with open(path) as f:
                entries.update(json.load(f)["entries"])
        write(entries, args.out)
        return 0
    sys.path.insert(0, REPO)
    entries = run(args)
    write(entries, args.out)
    bad = [k for k, e in entries.items() if not e["ok"]]
    print(json.dumps({"scenarios": len(entries), "failed": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
