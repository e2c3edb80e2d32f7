#!/usr/bin/env python3
"""Generate the inputs of the benchmark's pulse deployment (hanfre_cpfit_pulse).

The deployment is upstream's han_fre bootstrap loop (test.bs/han_fre.bs.sh:
27-37) with upstream's own pulse fit added (tests/fixtures/
generate_cli_fixtures.py: ``-pu 2 4 0.2 1 -pu 1 6 0.1 0 --cpfit`` at split
8), its pulses placed as that fit's spacing scales to the stand-in, whose
split sits at interval 24: ``-pu 2 12 0.2 1 -pu 1 18 0.1 0``.

The PSMC inputs are the han_fre-shaped stand-ins of the repository
(tests/fixtures/sweep1.psmc, sweep2.psmc; scripts/make_sweep_fixture.py),
copied.  The 200-chunk JSFS is drawn here from the deployment's own model,
as scripts/make_sweep_fixture.py draws sweep.jsfs: migration 0.5 on [4, ST)
from population 1, a pulse of 0.1 from population 2 at interval 12 and one
of 0.1 from population 1 at interval 18, cpfit with smoothing (upstream's
default), unfolded.  Each chunk takes split 23, 24 or 25 with
probabilities 0.45 / 0.10 / 0.45, and its length and segment count are
drawn as make_sweep_fixture.py draws them, from a fixed seed.  So the
sweep's fits meet a true pulse rate of 0.1, not a rate that runs to 0.

The model is evaluated with misti_tpu_torch's plain path on the CPU in
float64 (``build_spec`` + ``build_likelihood``); nothing imports JAX.

    python scripts/make_pulse_fixture.py [--out DIR]

writes DIR/sweep1.psmc, DIR/sweep2.psmc and DIR/pulse.jsfs (default:
benchmark/data/hanfre_cpfit_pulse).
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FIXDIR = os.path.join(ROOT, "tests", "fixtures")
OUT = os.path.join(ROOT, "benchmark", "data", "hanfre_cpfit_pulse")

BAND = 0.5  # migration rate on [4, ST) from population 1
PULSES = [[2, 12, 0.1, 0], [1, 18, 0.1, 0]]  # (source population, interval, rate, fixed)
SPLITS, SPLIT_P = (23, 24, 25), (0.45, 0.10, 0.45)
SEED = 13


def model_spectra(psmc1: str, psmc2: str) -> list:
    """The deployment's normalised 7-category spectrum at each of SPLITS."""
    import torch

    sys.path.insert(0, ROOT)
    from misti_tpu_torch.engine.likelihood import build_likelihood
    from misti_tpu_torch.engine.spec import build_spec
    from misti_tpu_torch.io import psmc as io_psmc

    torch.set_num_threads(1)
    d = io_psmc.read_psmc(psmc1, psmc2)
    out = []
    for st in SPLITS:
        spec = build_spec(d.times, d.lambdas, [0.0] + [1.0] * 7, st, [[1, 4, st, BAND, 0]],
                          PULSES, unfolded=True, cpfit=True, smooth=True)
        lik = build_likelihood(spec, device="cpu", dtype=torch.float64)
        _, aux = lik.llh_aux(np.zeros(0))
        p = np.asarray(aux["jafs"], float)
        out.append(p / p.sum())
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    for name in ("sweep1.psmc", "sweep2.psmc"):
        shutil.copyfile(os.path.join(FIXDIR, name), os.path.join(args.out, name))
    spectra = model_spectra(os.path.join(args.out, "sweep1.psmc"),
                            os.path.join(args.out, "sweep2.psmc"))
    for st, sp in zip(SPLITS, spectra):
        print(f"model JSFS at split {st}:", np.round(sp, 4))

    rng = np.random.default_rng(SEED)
    rows = []
    for _ in range(200):
        length = int(rng.uniform(0.8, 1.2) * 13_500_000)
        n_seg = rng.poisson(600)
        k = rng.choice(3, p=list(SPLIT_P))
        rows.append([length, *rng.multinomial(n_seg, spectra[k])])
    with open(os.path.join(args.out, "pulse.jsfs"), "w") as f:
        f.write("#MiSTI_JSFS version 1.0\n")
        f.write("#total\t0100\t1100\t0001\t0101\t1101\t0011\t0111\n")
        for r in rows:
            f.write("\t".join(str(v) for v in r) + "\n")
    print("wrote sweep1.psmc sweep2.psmc pulse.jsfs in", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
