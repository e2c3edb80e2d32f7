#!/usr/bin/env python3
"""Float64 reference tables of the JAX package, made on the CPU.

    python scripts/jax_f64_reference.py matrix [--only GLOB] [--ect] --part FILE
    python scripts/jax_f64_reference.py merge FILE ...
    python scripts/jax_f64_reference.py sweep {cpfit,ect}

Each run is the JAX package's own sweep CLI (``misti_tpu.cli.sweep``
``main``, in this process) on the CPU in float64 (``--platform cpu``), with
``MISTI_CORRECTION=fused-xla`` (the Pallas kernel's algorithm in plain XLA,
the one the port implements) and bootstrap seed 0:

``matrix``  the 16-scenario matrix, the command of MATRIXBENCH_r05.json
            (``--scenarios tests/fixtures/matrix/matrix.json -bs 100 -uf
            --nosmooth --cpfit``; ``--ect`` drops ``--cpfit``), on the
            scenarios whose names match ``--only`` (fnmatch), all in one CLI
            call (same-shape scenarios share their compiled programs).
            Writes a part file: per scenario the argmax histogram, the CI,
            the wall, the llh evaluations, the stage lines, the unconverged
            cells (split, row, parameters, nfev, llh), and the cell lines.
``merge``   combines part files into MATRIX_jax_f64_cpu.json (keys
            ``cpfit:NAME`` / ``ect:NAME``) and scripts/matrix_f64_cpu.out
            (the CLI's cell lines; an ECT scenario's lines carry
            ``scenario = ect:NAME``).  Later parts replace earlier entries.
``sweep``   the north-star sweep of chip_smoke.py phase 6
            (tests/fixtures/sweep*.psmc + sweep.jsfs, ``--splits 20 27 -bs
            100 -mi 1 4 ST 3 1 -uf``): cpfit with ``--maxiter 256`` into
            scripts/sweep1band_f64_cpu_cap256.npz, ECT with ``--maxiter
            1000`` into scripts/sweep_ect_f64_cpu.npz.  The .npz holds the
            CLI's keys plus ``converged`` (S, B) and ``meta`` (a JSON string).

Every output records its command, its environment, ``jax.__version__``, the
host's CPU and the wall.  The JAX sweep returns no convergence flags, so this
script reads the final stage's ``conv`` as the sweep builds its result.

Wall on 8 cores with nothing else running: one two-band cpfit scenario takes
~8 min, the whole cpfit matrix about an hour.  Run one scenario group per
process, two or three processes at a time, each under ``timeout``, e.g.
    timeout 7200 python scripts/jax_f64_reference.py matrix --only '*.mi2' \\
        --part build/f64_mi2.json
"""

from __future__ import annotations

import argparse
import contextlib
import fnmatch
import io
import json
import os
import platform
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFEST = os.path.join(REPO, "tests", "fixtures", "matrix", "matrix.json")
MATRIX_JSON = os.path.join(REPO, "MATRIX_jax_f64_cpu.json")
MATRIX_OUT = os.path.join(REPO, "scripts", "matrix_f64_cpu.out")
SWEEP_NPZ = {"cpfit": os.path.join(REPO, "scripts", "sweep1band_f64_cpu_cap256.npz"),
             "ect": os.path.join(REPO, "scripts", "sweep_ect_f64_cpu.npz")}
SWEEP_ARGS = ["tests/fixtures/sweep1.psmc", "tests/fixtures/sweep2.psmc",
              "tests/fixtures/sweep.jsfs", "--splits", "20", "27", "-bs", "100",
              "-mi", "1", "4", "ST", "3", "1", "-uf"]
SWEEP_MAXITER = {"cpfit": 256, "ect": 1000}
MATRIX_ARGS = ["-bs", "100", "-uf", "--nosmooth"]
ENV = {"MISTI_CORRECTION": "fused-xla", "JAX_PLATFORMS": "cpu"}


def host() -> dict:
    cpu = platform.processor()
    with contextlib.suppress(OSError), open("/proc/cpuinfo") as f:
        cpu = next((ln.split(":", 1)[1].strip() for ln in f if ln.startswith("model name")),
                   cpu)
    return {"cpu": cpu, "cores": os.cpu_count(), "python": platform.python_version()}


def setup() -> dict:
    """The environment of every run, set before jax is imported."""
    os.environ.update(ENV)
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jaxlib

    keys = sorted(set(ENV) | {k for k in os.environ if k.startswith(("MISTI_", "XLA_"))}
                  | {"OMP_NUM_THREADS"})
    return {"env": {k: os.environ[k] for k in keys if k in os.environ},
            "jax": jax.__version__, "jaxlib": jaxlib.__version__, "dtype": "float64",
            "host": host()}


def run_cli(argv: list) -> tuple:
    """``misti_tpu.cli.sweep.main(argv)`` with its output captured, and each
    scenario's SweepResult with its final ``converged`` flags.  Returns
    (stdout lines, stderr lines, {name: result}, wall s)."""
    from misti_tpu.cli import sweep as cli
    from misti_tpu.engine import bootstrap as jb

    base, sweep_many = jb.SweepResult, jb.sweep_many
    results = {}

    def result(*a, **kw):
        # _sweep_fused builds its result with the final stage's flags in
        # ``conv``; a scenario without parameters has none (every cell done)
        res = base(*a, **kw)
        conv = sys._getframe(1).f_locals.get("conv")
        res.converged = (np.ones(np.shape(res.llh), bool) if conv is None
                         else np.asarray(conv, bool).reshape(np.shape(res.llh)))
        return res

    def recording(scenarios, **kw):
        out = sweep_many(scenarios, **kw)
        results.update(out)
        return out

    out, err = io.StringIO(), io.StringIO()
    jb.SweepResult, jb.sweep_many = result, recording
    t = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(argv)
    finally:
        jb.SweepResult, jb.sweep_many = base, sweep_many
    wall = time.perf_counter() - t
    if rc != 0:
        raise SystemExit(f"the sweep CLI returned {rc}:\n{err.getvalue()[-4000:]}")
    return out.getvalue().splitlines(), err.getvalue().splitlines(), results, wall


def unconverged(res, splits) -> list:
    return [dict(split=float(splits[i]), row=int(r), params=np.asarray(res.params[i, r]).tolist(),
                 nfev=None if res.nfev is None else int(res.nfev[i, r]),
                 llh=float(res.llh[i, r]))
            for i, r in zip(*np.nonzero(~res.converged))]


def shell(argv: list) -> str:
    return " ".join(a if a and not set(a) & set(" *'\"") else repr(a) for a in argv)


def run_matrix(args, meta: dict) -> dict:
    mode = "ect" if args.ect else "cpfit"
    with open(MANIFEST) as f:
        manifest = [e for e in json.load(f) if fnmatch.fnmatch(e["name"], args.only)]
    if not manifest:
        raise SystemExit(f"no scenario matches {args.only!r}")
    mdir = os.path.dirname(MANIFEST)
    for e in manifest:
        for k in ("fpsmc1", "fpsmc2", "fjafs"):
            e[k] = os.path.join(mdir, e[k])
    with tempfile.TemporaryDirectory() as tmp:
        mpath = os.path.join(tmp, "matrix.json")
        with open(mpath, "w") as f:
            json.dump(manifest, f)
        flags = MATRIX_ARGS + ([] if args.ect else ["--cpfit"])
        argv = (["--scenarios", mpath] + flags + ["--platform", "cpu", "--funits",
                                                  os.path.join(tmp, "none")])
        lines, err, results, wall = run_cli(argv)
    command = shell(["python", "-m", "misti_tpu.cli.sweep", "--scenarios",
                     os.path.relpath(MANIFEST, REPO)] + flags + ["--platform", "cpu"])
    summaries = {s["scenario"]: s for s in (json.loads(ln) for ln in lines
                                            if ln.startswith('{"scenario"'))}
    # each scenario's stage lines: a sweep's first stage opens them
    stages, cur = [], None
    for ln in err:
        if ln.startswith("# sweep stage 1/"):
            cur = []
            stages.append(cur)
        if ln.startswith("# sweep stage") and cur is not None:
            cur.append(ln[2:])
    entries, cell_lines = {}, {}
    for k, e in enumerate(manifest):
        name, key = e["name"], f"{mode}:{e['name']}"
        res = results[name]
        s = summaries[name]
        entries[key] = dict(
            scenario=name, mode=mode, command=command, only=args.only,
            cells=s["cells"], n_params=int(np.shape(res.params)[-1]),
            wall_s=s["wallclock_s"], llh_evals=s.get("llh_evals"),
            argmax_hist=s["argmax_hist"], split_mean_gens=s["split_mean_gens"],
            split_ci_gens=s["split_ci_gens"], ci_level=s["ci_level"],
            degenerate=s["split_ci_gens"][0] == s["split_ci_gens"][1],
            unconverged=int((~res.converged).sum()),
            unconverged_cells=unconverged(res, res.split_times),
            stages=stages[k] if k < len(stages) else [], **meta)
        tag = f"scenario = {name} \t"
        ours = [ln for ln in lines if ln.startswith(tag)]
        if args.ect:
            ours = [ln.replace(tag, f"scenario = {key} \t", 1) for ln in ours]
        cell_lines[key] = ours
    part = {"group_wall_s": wall, "entries": entries, "cell_lines": cell_lines}
    os.makedirs(os.path.dirname(os.path.abspath(args.part)), exist_ok=True)
    with open(args.part, "w") as f:
        json.dump(part, f, indent=1)
        f.write("\n")
    for key, ent in entries.items():
        print(json.dumps({k: ent[k] for k in ("scenario", "mode", "wall_s", "llh_evals",
                                              "argmax_hist", "split_ci_gens", "unconverged")}),
              flush=True)
    return part


def merge(paths) -> None:
    entries, cell_lines = {}, {}
    if os.path.exists(MATRIX_JSON):
        with open(MATRIX_JSON) as f:
            entries.update(json.load(f)["entries"])
    if os.path.exists(MATRIX_OUT):
        with open(MATRIX_OUT) as f:
            for ln in f:
                key = ln.split(" \t", 1)[0].removeprefix("scenario = ")
                key = key if ":" in key else f"cpfit:{key}"
                cell_lines.setdefault(key, []).append(ln.rstrip("\n"))
    for path in paths:
        with open(path) as f:
            part = json.load(f)
        entries.update(part["entries"])
        cell_lines.update(part["cell_lines"])
    with open(MANIFEST) as f:
        order = [e["name"] for e in json.load(f)]
    keys = sorted(entries, key=lambda k: (k.split(":")[0] != "cpfit",
                                          order.index(k.split(":", 1)[1])))
    doc = {"what": "the 16-scenario sweep matrix (tests/fixtures/matrix/matrix.json) through "
                   "the JAX package's sweep CLI on the CPU in float64, MISTI_CORRECTION="
                   "fused-xla, bootstrap seed 0; scripts/jax_f64_reference.py",
           "entries": {k: entries[k] for k in keys}}
    with open(MATRIX_JSON, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    with open(MATRIX_OUT, "w") as f:
        for k in keys:
            for ln in cell_lines.get(k, []):
                f.write(ln + "\n")


def run_sweep(mode: str, meta: dict) -> None:
    from misti_tpu.engine.bootstrap import split_time_confidence_interval

    out = SWEEP_NPZ[mode]
    flags = (["--cpfit"] if mode == "cpfit" else []) + ["--maxiter", str(SWEEP_MAXITER[mode])]
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "r.npz")
        files = [os.path.join(REPO, f) for f in SWEEP_ARGS[:3]]
        argv = (files + SWEEP_ARGS[3:] + flags
                + ["--platform", "cpu", "--funits", os.path.join(tmp, "none"), "-o", npz])
        lines, err, results, wall = run_cli(argv)
        z = dict(np.load(npz))
    res = results[""]
    ci = split_time_confidence_interval(res, z["times"], float(z["scale_time"]))
    summary = [json.loads(ln) for ln in lines if ln.startswith('{"cells"')][0]
    info = dict(command=shell(["python", "-m", "misti_tpu.cli.sweep"] + SWEEP_ARGS + flags
                              + ["--platform", "cpu", "-o", os.path.relpath(out, REPO)]),
                wall_s=wall, summary=summary, split_ci_gens=[float(v) for v in ci["ci"]],
                unconverged_cells=unconverged(res, res.split_times),
                stages=[ln[2:] for ln in err if ln.startswith("# sweep stage")], **meta)
    np.savez(out, converged=res.converged, meta=np.array(json.dumps(info)), **z)
    print(json.dumps({k: info[k] for k in ("command", "wall_s", "summary")}), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="what", required=True)
    m = sub.add_parser("matrix", help="scenarios of the matrix into a part file")
    m.add_argument("--only", default="*", help="fnmatch pattern of scenario names")
    m.add_argument("--ect", action="store_true", help="without --cpfit")
    m.add_argument("--part", required=True, help="the part file to write")
    g = sub.add_parser("merge", help="part files into the matrix JSON and .out")
    g.add_argument("parts", nargs="+")
    s = sub.add_parser("sweep", help="the north-star sweep into its .npz")
    s.add_argument("mode", choices=sorted(SWEEP_NPZ))
    args = p.parse_args(argv)
    if args.what == "merge":
        merge(args.parts)
        return 0
    sys.path.insert(0, REPO)
    meta = setup()
    if args.what == "matrix":
        run_matrix(args, meta)
    else:
        run_sweep(args.mode, meta)
    return 0


if __name__ == "__main__":
    sys.exit(main())
