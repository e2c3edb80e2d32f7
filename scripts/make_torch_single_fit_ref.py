#!/usr/bin/env python3
"""Record the JAX package's single fits of the north-star data, the
reference of ``chip_smoke.py`` phase 7b.

    python scripts/make_torch_single_fit_ref.py [--out tests/fixtures/torch_single_fit_ref.json]

Runs ``misti_tpu.cli.misti.main`` on the CPU in float64 with the fused-xla
correction (the CPU form of the sweep algorithm that the PyTorch port runs
as a CUDA kernel) for each command of ``FITS``: upstream's test.bs command
at split 24 (the sweep's argmax) on tests/fixtures/sweep*.psmc and
sweep.jsfs, in cpfit and ECT, and the cpfit band with one optimised pulse.
Each record holds the command, the estimate line's parameters and llh, the
solver summary's iterations and evaluations, the Report() counters and the
.mi file's llh and spectrum.  Takes ~10 min on one CPU core (the ECT
program's XLA compile dominates).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = "tests/fixtures/"
BASE = [FIX + "sweep1.psmc", FIX + "sweep2.psmc", FIX + "sweep.jsfs", "24",
        "-mi", "1", "4", "24", "3", "1", "-uf", "-bs", "0", "--funits", "/nonexistent"]
FITS = {
    "cpfit": BASE + ["--cpfit"],
    "ect": BASE,
    "cpfit_pulse": BASE + ["-pu", "2", "20", "0.2", "1", "--cpfit"],
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, FIX, "torch_single_fit_ref.json"))
    args = ap.parse_args()

    os.chdir(REPO)
    sys.path.insert(0, REPO)
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["MISTI_CORRECTION"] = "fused-xla"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from chip_smoke import parse_fit_stdout
    from misti_tpu.cli import misti as jax_cli
    from misti_tpu.io import mi_format

    records = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, argv in FITS.items():
            out_mi = os.path.join(tmp, name + ".mi")
            buf = io.StringIO()
            t = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = jax_cli.main(argv + ["-o", out_mi])
            wall = time.perf_counter() - t
            if rc != 0:
                raise RuntimeError(f"{name}: the JAX CLI returned {rc}")
            rec = parse_fit_stdout(buf.getvalue().splitlines())
            mi = mi_format.read_migration(out_mi)
            rec.update(argv=argv, mi_llh=mi.llh, jafs=mi.jafs)
            records[name] = rec
            print(f"{name}: {json.dumps(rec)} ({wall:.1f} s)", file=sys.stderr)
    doc = {
        "made_by": "scripts/make_torch_single_fit_ref.py",
        "package": "misti_tpu (JAX), CPU, float64, MISTI_CORRECTION=fused-xla",
        "jax": jax.__version__,
        "fits": records,
    }
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
