#!/usr/bin/env python3
"""The 16-scenario sweep matrix through the port's sweep CLI on one card.

    python scripts/torch_matrix_card.py [--only GLOB] [--ect] [--dtype D] [--maxiter N] [--out FILE]
    python scripts/torch_matrix_card.py --merge FILE ... [--out MATRIX_torch_h100.json]

Runs ``python -m misti_tpu_torch.cli.sweep --scenarios
tests/fixtures/matrix/matrix.json -bs 100 -uf --nosmooth --cpfit`` (the JAX
package's command of MATRIXBENCH_r05.json; ``--ect`` drops ``--cpfit``), in
this process, on the scenarios whose names match ``--only`` (fnmatch, e.g.
'pair3.*'), in the run's default dtype (float64; ``--dtype float32`` gives
float32 parameters and simplex, the likelihood computes in float64 either
way), and judges every scenario.

The reference is the JAX package's sweep CLI on the CPU in float64
(scripts/jax_f64_reference.py: MATRIX_jax_f64_cpu.json, cell lines in
scripts/matrix_f64_cpu.out).  A scenario with reference cells, every cpfit
one and the ECT ones the reference holds, is held to four gates:
  * every llh finite;
  * the argmax histogram equal to the reference's;
  * both ends of the CI within 0.01 generations of the reference's;
  * on the cells converged in this run and in the reference, this fit's
    float64 llh on the card no lower than the float64 llh on the card at the
    reference's parameters minus 5e-2.
  Scenarios whose reference CI has zero width are marked ``degenerate``: a
  histogram match there is a weak gate.  Not gated, but printed and stored:
  the share of cells whose llh is within 1e-6 nats of the reference's, the
  card's float64 llh at the reference's parameters against the reference's
  llh, and the comparison with the JAX package's float32 TPU table
  (MATRIXBENCH_r05.json, scripts/matrix_r05.out; cpfit only): histogram, CI
  distance and the cells furthest below its fits.

An ECT scenario without reference cells: every llh finite, and for 3
bootstrap rows x every split of each fitted scenario a float64 re-fit on the
card (the same sweep in float64, ``--maxiter`` REFIT_MAXITER); on cells
converged in both, this run's fit's float64 llh no lower than the float64
fit's minus 5e-2.

Every entry records the wall, llh evaluations, objective calls and kernel
launches, the unconverged cells (split, row, parameters, nfev, llh, and the
reference's fit there), the histogram and CI, the judge, the run's dtype and
the card's ``nvidia-smi`` name and power limit.  Writes ``--out`` (one entry
per scenario and mode) and exits 1 if a gate failed.  ``--merge`` combines
such files into one (later entries replace earlier ones of the same scenario
and mode).

A fitted cpfit scenario takes 0.4-5 s on an H100 (ECT more: its
post-split fit), so the whole matrix fits in one process; one scenario group
per process, e.g.
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
TABLE_JSON = os.path.join(REPO, "MATRIX_jax_f64_cpu.json")
TABLE_OUT = os.path.join(REPO, "scripts", "matrix_f64_cpu.out")
# the JAX package's float32 TPU table: compared and printed, not gated
OLD_TABLE_JSON = os.path.join(REPO, "MATRIXBENCH_r05.json")
OLD_TABLE_OUT = os.path.join(REPO, "scripts", "matrix_r05.out")
BOOTSTRAPS = 100
LLH_LIMIT = 5e-2  # nats, float64, as chip_smoke.py's judge of the north-star sweep
CI_LIMIT = 0.01  # generations
SAME_LLH = 1e-6  # nats: a cell's llh "equal" to the reference's (printed, not gated)
REFIT_ROWS = (0, 1, 2)
REFIT_MAXITER = 200  # iteration budget of the ECT float64 re-fits
_CELL = re.compile(r"scenario = (?P<scenario>\S+) \tbs_id = (?P<bs>\d+) \tsplitT = "
                   r"(?P<split>\S+) \ttime = \S+ \tmigration rates optim = \[(?P<params>[^\]]*)\]"
                   r" \tllh = (?P<llh>\S+)")


def parse_cells(lines) -> dict:
    """Cell lines of the sweep CLI (``scenario = ... bs_id = ... splitT = ...
    migration rates optim = [...] llh = ...``) -> {scenario: {(split, bs):
    (params tuple, llh)}}; other lines are skipped.  The reference's ECT
    lines name their scenario ``ect:NAME``."""
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


def table_llh(cells: dict, splits, n_rows: int) -> np.ndarray:
    """(S, B) llh of one scenario's table cells."""
    return np.array([[cells[(float(st), b)][1] for b in range(n_rows)] for st in splits])


def table_converged(entry: dict, splits, n_rows: int) -> np.ndarray:
    """(S, B) convergence flags of a reference entry (its unconverged cells)."""
    conv = np.ones((len(splits), n_rows), bool)
    for c in entry.get("unconverged_cells", []):
        conv[[float(s) for s in splits].index(float(c["split"])), int(c["row"])] = False
    return conv


def argmax_hist(llh, splits) -> dict:
    am = np.asarray(llh).argmax(axis=0)
    return {str(float(splits[i])): int((am == i).sum()) for i in sorted(set(am.tolist()))}


def _worst(cells, gain, params, ref_par, splits, n_rows, k=5) -> list:
    """The ``k`` cells of ``cells`` (flat indices) with the lowest ``gain``."""
    n = len(splits) * n_rows
    return [dict(split=float(splits[c // n_rows]), row=int(c % n_rows),
                 params=np.asarray(params).reshape(n, -1)[c].tolist(),
                 table_params=np.asarray(ref_par).reshape(n, -1)[c].tolist(),
                 gain64=float(g))
            for c, g in sorted(zip(np.asarray(cells).tolist(), gain), key=lambda t: t[1])[:k]]


def judge_table(llh, params, converged, splits, ci, table, table_par, ref_llh, table_conv,
                llh64) -> dict:
    """The four gates of one scenario against its float64 reference entry.

    ``llh`` (S, B) llh of this run, ``params`` (S, B, n), ``converged``
    (S, B), ``ci`` this run's split_time_confidence_interval, ``table`` the
    reference entry (argmax_hist, split_ci_gens), ``table_par`` (S, B, n) /
    ``ref_llh`` (S, B) / ``table_conv`` (S, B) its fits, llh and flags,
    ``llh64(params (S, B, n), cells (k,) flat indices)`` the float64 llh on
    the card.  Returns the gates, their numbers and ``ok``."""
    hist = argmax_hist(llh, splits)
    ci_t = table["split_ci_gens"]
    d_ci = max(abs(ci["ci"][0] - ci_t[0]), abs(ci["ci"][1] - ci_t[1]))
    shape = np.shape(llh)
    every = np.arange(int(np.prod(shape)))
    l_run, l_tab = llh64(params, every), llh64(table_par, every)
    both = np.asarray(converged).ravel() & np.asarray(table_conv).ravel()
    conv = np.flatnonzero(both)
    gain = (l_run - l_tab)[conv]
    with np.errstate(invalid="ignore"):  # -inf - -inf: such a cell fails "finite"
        d_llh = np.abs(np.asarray(llh, float) - np.asarray(ref_llh, float)).ravel()
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
            "worst_cells": _worst(conv, gain, params, table_par, splits, shape[1]),
            # not gated: how many cells reach the reference's llh to 1e-6, and
            # the card's llh at the reference's fits against the reference's
            "share_llh_within_1e-6": float(np.mean(d_llh <= SAME_LLH)),
            "card_vs_table_llh_at_table_params": _stats(
                np.abs(l_tab - np.asarray(ref_llh, float).ravel())),
            "float64_argmax_hist": {
                "run": argmax_hist(l_run.reshape(shape), splits),
                "table": argmax_hist(l_tab.reshape(shape), splits),
                "better_of_both": argmax_hist(np.maximum(l_run, l_tab).reshape(shape), splits)}}


def compare_old_table(llh, params, converged, splits, ci, old, old_par, llh64) -> dict:
    """This run against the JAX package's float32 TPU table entry ``old``
    (MATRIXBENCH_r05.json) and its fits ``old_par``: the histograms, the CI
    distance and the 5 cells furthest below its fits in float64.  Not gated."""
    shape = np.shape(llh)
    every = np.arange(int(np.prod(shape)))
    conv = np.flatnonzero(np.asarray(converged).ravel())
    gain = (llh64(params, every) - llh64(old_par, every))[conv]
    ci_t = old["split_ci_gens"]
    return {"argmax_hist": old["argmax_hist"], "hist_equal": argmax_hist(llh, splits)
            == old["argmax_hist"], "split_ci_gens": ci_t,
            "max_ci_diff_gens": max(abs(ci["ci"][0] - ci_t[0]), abs(ci["ci"][1] - ci_t[1])),
            "float64_gain": _stats(gain),
            "worst_cells": _worst(conv, gain, params, old_par, splits, shape[1]),
            "llh_evals": old["llh_evals"]}


def unconverged_cells(res, splits, table_cells=None) -> list:
    """Each cell this run left unconverged, with the reference's fit there."""
    out = []
    for i, r in zip(*np.nonzero(~np.asarray(res.converged))):
        c = dict(split=float(splits[i]), row=int(r), params=res.params[i, r].tolist(),
                 nfev=int(res.nfev[i, r]), llh=float(res.llh[i, r]))
        if table_cells is not None:
            t_par, t_llh = table_cells[(float(splits[i]), int(r))]
            c["table_params"], c["table_llh"] = list(t_par), t_llh
        out.append(c)
    return out


def judge_refit(llh64_f32_fit, llh64_refit, both) -> dict:
    """ECT without reference cells: this run's fit's float64 llh against the
    float64 re-fit's, on the cells converged in both (``both``, a bool mask)."""
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
    from misti_tpu_torch.config import resolve_dtype
    from misti_tpu_torch.engine import bootstrap
    from misti_tpu_torch.engine.sweep_fused import build_fused_sweep
    from misti_tpu_torch.io import psmc as io_psmc
    from misti_tpu_torch.kernels.correction_fused import correction_sweep

    if args.platform == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False: this script needs a card")
    dev = torch.device(args.platform)
    gpu = gpu_line() if dev.type == "cuda" else "cpu (a dry run)"
    mode = "ect" if args.ect else "cpfit"
    dtype = resolve_dtype(dev, None if args.dtype is None else getattr(torch, args.dtype))
    with open(MANIFEST) as f:
        manifest = [e for e in json.load(f) if fnmatch.fnmatch(e["name"], args.only)]
    if not manifest:
        raise SystemExit(f"no scenario matches {args.only!r}")
    mdir = os.path.dirname(MANIFEST)
    for e in manifest:
        for k in ("fpsmc1", "fpsmc2", "fjafs"):
            e[k] = os.path.join(mdir, e[k])
    with open(TABLE_JSON) as f:
        table = json.load(f)["entries"]
    with open(TABLE_OUT) as f:
        table_cells = parse_cells(f)
    with open(OLD_TABLE_JSON) as f:
        old = {e["scenario"]: e for e in json.load(f)["per_scenario"] if "scenario" in e}
    with open(OLD_TABLE_OUT) as f:
        old_cells = parse_cells(f)

    # each scenario's SweepResult and kernel launches, as the CLI runs it
    seen = {}
    sweep_many = bootstrap.sweep_many

    def recording(scenarios, **kw):
        n0 = correction_sweep.launches
        out = sweep_many(scenarios, **kw, dtype=dtype)
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
            key = f"{mode}:{name}"
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

            ref_cells = table_cells.get(name if mode == "cpfit" else key)
            entry = {
                "scenario": name, "mode": mode, "command": command, "dtype": str(dtype),
                "gpu": gpu, "cells": int(z["llh"].size), "n_params": int(n_par),
                "wall_s": summ["wallclock_s"], "llh_evals": summ.get("llh_evals"),
                "objective_calls": int(res.calls), "kernel_launches": int(launches),
                "calls_equal_launches": int(res.calls) == int(launches),
                "unconverged": int((~res.converged).sum()),
                "unconverged_cells": unconverged_cells(res, splits, ref_cells),
                "argmax_hist": summ["argmax_hist"], "split_mean_gens": summ["split_mean_gens"],
                "split_ci_gens": summ["split_ci_gens"],
                "stages": stage_lines,
            }
            ci = bootstrap.split_time_confidence_interval(res, inp.times, inp.scale_time)
            if ref_cells is not None:
                t = table[key]
                judged = judge_table(z["llh"], z["params"], res.converged, splits, ci, t,
                                     table_params(ref_cells, splits, n_rows, n_par),
                                     table_llh(ref_cells, splits, n_rows),
                                     table_converged(t, splits, n_rows), llh64)
                judged["table_llh_evals"] = t["llh_evals"]
                judged["table_unconverged"] = t["unconverged"]
                if mode == "cpfit":
                    judged["old_table"] = compare_old_table(
                        z["llh"], z["params"], res.converged, splits, ci, old[name],
                        table_params(old_cells[name], splits, n_rows, n_par), llh64)
            else:
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
                    fit = llh64(z["params"], cells)
                    both = res.converged.ravel()[cells] & ref.converged.ravel()
                    r = judge_refit(fit, ref.llh.ravel(), both)
                    r["refit_rows"], r["refit_unconverged"] = rows, int((~ref.converged).sum())
                    r["refit_wall_s"] = time.perf_counter() - t_refit
                    judged["gates"].update(r.pop("gates"))
                    judged.update(r)
            judged["gates"]["calls_equal_launches"] = entry["calls_equal_launches"]
            judged["ok"] = all(judged["gates"].values())
            entry.update(judged)
            entries[key] = entry
            write(entries, args.out)
            print(json.dumps(entry), flush=True)
    return entries


def write(entries: dict, path: str) -> None:
    doc = {"what": "the 16-scenario sweep matrix (tests/fixtures/matrix/matrix.json) through "
                   "misti_tpu_torch.cli.sweep on one card, each entry in its run's dtype (the "
                   "likelihood in float64), held to the JAX package's float64 CPU reference "
                   "(MATRIX_jax_f64_cpu.json); scripts/torch_matrix_card.py",
           "entries": dict(sorted(entries.items()))}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--only", default="*", help="fnmatch pattern of scenario names")
    p.add_argument("--ect", action="store_true", help="without --cpfit")
    p.add_argument("--dtype", default=None, choices=("float32", "float64"),
                   help="the parameters' and the simplex's (default: the run's, float64)")
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
