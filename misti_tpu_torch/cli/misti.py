"""Main fit CLI, flag-compatible with the reference MiSTI.py.

Usage:
    python -m misti_tpu_torch.cli.misti <fpsmc1> <fpsmc2> <fjafs> <st> [options] \
        [--platform cuda|cpu]

Parses the same flag surface (MiSTI.py:43-99), prints the same greppable
estimate line (`bs_id = ... llh = ...`, MiSTI.py:240, consumed by the
test.bs awk pipelines), and writes the byte-compatible .mi result file.
The fit runs in float64 on either device (the single-fit policy of the JAX
package); ``--platform`` defaults to ``cuda`` and raises without a card.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Migration inference from PSMC.")
    p.add_argument("fpsmc1", help="psmc file 1")
    p.add_argument("fpsmc2", help="psmc file 2")
    p.add_argument("fjafs", help="joint allele frequency spectrum file")
    p.add_argument("st", type=float, help="split time")
    p.add_argument("-o", "--fout", default="", help="output file, default is stdout")
    p.add_argument("-wd", default="", help="working directory (path to data files)")
    p.add_argument("-tol", type=float, default=1e-4,
                   help="optimisation precision (default is 1e-4)")
    p.add_argument("-mth", type=float, default=0.0,
                   help="mixture treshhold (default is 0.0)")
    p.add_argument("-mi", nargs=5, action="append", default=None,
                   help="migration rate: srcPop start end rate fixed(0)/opt(1)")
    p.add_argument("-pu", nargs=4, action="append", default=None,
                   help="pulse migration: srcPop time rate fixed(0)/opt(1)")
    p.add_argument("--sdate", type=float, default=0,
                   help="dating of the second sample (for ancient genome)")
    p.add_argument("--hetloss", "-hl", nargs=2, type=float, default=None,
                   help="loss of heterozygosity for the two genomes")
    p.add_argument("--discr", "-d", type=int, default=1,
                   help="discretisation of intervals (inert, reference parity)")
    p.add_argument("-rd", type=int, default=-1,
                   help="round (RD) in PSMC file (-1 for the last round)")
    p.add_argument("--funits", type=str, default="setunits.txt",
                   help="units file for time/EPS rescaling")
    p.add_argument("-uf", action="store_true", help="unfolded spectrum")
    p.add_argument("--nosmooth", action="store_true",
                   help="don't make rates constant on the psmc time intervals")
    p.add_argument("--trueEPS", action="store_true",
                   help="treat input as true effective population sizes")
    p.add_argument("--cpfit", action="store_true",
                   help="fit no-coalescence probabilities instead of expected times")
    p.add_argument("--bsMode", "-bs", type=int, default=-1,
                   help="use single bootstrap row")
    p.add_argument("--psmcMode", "-pm", type=int, default=0, help="PSMC mode")
    p.add_argument("--debug", action="store_true", help="debug mode")
    p.add_argument("--aot", action="store_true",
                   help="accepted for command-line compatibility; no effect here")
    p.add_argument("--platform", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default; raises without a card) or cpu; float64 on both")
    return p


def main(argv=None) -> int:
    t0 = time.time()
    clargs = make_parser().parse_args(argv)

    # imports deferred so `--help` stays fast
    import numpy as np
    import torch

    from ..config import resolve_device
    from ..engine.likelihood import build_likelihood
    from ..engine.optimize import solve
    from ..engine.spec import build_spec
    from ..io import jsfs as io_jsfs
    from ..io import mi_format
    from ..io import psmc as io_psmc
    from ..io.units import Units, print_err

    device = resolve_device(clargs.platform)  # raises for cuda without a card
    if clargs.aot:
        print_err("--aot has no effect in misti_tpu_torch (it runs eagerly; "
                  "there is no traced program to cache)")

    Units.set_units_from_file(clargs.funits)
    Units.print_units()
    if clargs.hetloss is not None:
        Units.set_het_loss(clargs.hetloss)

    print(" ".join(sys.argv if argv is None else ["misti"] + list(argv)))
    start = time.strftime("Job run at %H:%M:%S on %d %b %Y")
    if clargs.debug:
        print_err(start)
    print(start)

    fpsmc1 = os.path.join(clargs.wd, clargs.fpsmc1)
    fpsmc2 = os.path.join(clargs.wd, clargs.fpsmc2)
    fjafs = os.path.join(clargs.wd, clargs.fjafs)
    print("Reading from files:")
    print("pop1\t", fpsmc1)
    print("pop2\t", fpsmc2)
    print("jafs\t", fjafs)

    data_jafs = io_jsfs.read_jafs(fjafs)
    if clargs.bsMode == -1:
        input_sfs = list(data_jafs.summed())
    else:
        input_sfs = list(data_jafs.jafs[clargs.bsMode])

    print(
        "IMPORTANT NOTICE!!! Every time you are running MiSTI, make sure that "
        "psmc files are supplied in the same order as populations appear in "
        "the joint allele frequency spectrum."
    )

    fout = clargs.fout
    if fout != "":
        fout = os.path.join(clargs.wd, clargs.fout)

    if clargs.psmcMode == 0:
        input_data = io_psmc.read_psmc(fpsmc1, fpsmc2, clargs.sdate, clargs.rd)
    else:
        input_data = io_psmc.read_psmc1(fpsmc1, fpsmc2, clargs.rd,
                                        divergence_time=clargs.st)
    if input_data.divergence_time == -1:
        input_data.divergence_time = clargs.st

    mi = clargs.mi or []
    pu = clargs.pu or []

    t1 = time.time()
    spec = build_spec(
        input_data.times,
        input_data.lambdas,
        input_sfs,
        input_data.divergence_time,
        mi,
        pu,
        correct=not clargs.trueEPS,
        cpfit=clargs.cpfit,
        smooth=not clargs.nosmooth,
        unfolded=clargs.uf,
        sample_date=input_data.sample_date_discr,
        mixture_th=clargs.mth,
        thrh=(input_data.theta, input_data.rho),
    )
    lik = build_likelihood(spec, device=device, dtype=torch.float64)
    # trace=True: print every evaluated (mu, -llh) like the reference's
    # ObjectiveFunction (MigrationInference.py:713-716); solve() keeps it to
    # the CPU
    sol = solve(lik, clargs.tol, trace=True)
    print(sol)
    corr_called = sol.corr_called
    corr_failed = sol.corr_failed
    nfev = sol.nfev

    if clargs.debug and np.isfinite(sol[1]):
        # expected vs empirical spectrum + neutral-mass sanity prints
        # (reference MigrationInference.py:585-597)
        _, aux = lik.llh_aux(sol[0])
        j = aux["jafs"].cpu().numpy()
        d = spec.data_jafs / spec.data_jafs.sum()
        print("----------", j[0], j[1], sep="\t\t")
        print(j[2], j[3], j[4], sep="\t\t")
        print(j[5], j[6], "----------", sep="\t\t")
        print("----------", d[0], d[1], sep="\t\t")
        print(d[2], d[3], d[4], sep="\t\t")
        print(d[5], d[6], "----------", sep="\t\t")
        hn = 1 + 1 / 2 + 1 / 3
        print("singletons", j[0] + j[2], 1 / hn)
        print("doubletons", j[1] + j[3] + j[5], 1 / (2 * hn))
        print("tripletons", j[4] + j[6], 1 / (3 * hn))

    print("\nParameter estimates:")
    mig_fixed = [float(el[3]) for el in mi if int(el[4]) == 0]
    fixed_str = (
        "fixed = [" + ", ".join(str(v) for v in mig_fixed) + "]" if mig_fixed else ""
    )
    opt_str = (
        "optim = [" + ", ".join(str(v) for v in sol[0]) + "]" if len(sol[0]) else ""
    )
    mig_str = (fixed_str + "\t" + opt_str) if (fixed_str and opt_str) else fixed_str + opt_str

    split_time_gen = (
        sum(input_data.times[0 : math.ceil(input_data.divergence_time)])
        * input_data.scale_time
    )
    print(
        "bs_id =", clargs.bsMode, "\tsplitT =", input_data.divergence_time,
        "\ttime =", split_time_gen, "\tmigration rates", mig_str,
        "\tllh =", sol[1],
    )
    print("\n")
    t2 = time.time()

    if not np.isfinite(sol[1]):
        print("Failed to fit such a model.")
    elif clargs.bsMode == 0:
        # OutputMigration re-evaluates the solution ONLY when parameters
        # were optimised (migrationIO.py:347-350 reuses the stored llh for
        # len(mu) == 0), and the reference's class counters include that
        # re-evaluation; llh_aux is needed for the .mi contents either way
        # but counted only in the optimised case
        llh, aux = lik.llh_aux(sol[0])
        if len(sol[0]):
            nfev += 1
            corr_called += int(aux["corr_called"])
            corr_failed += int(aux["corr_failed"])
        text = mi_format.format_migration(
            llh=float(llh), split_t=spec.splitT, sample_date=spec.sample_date,
            thrh=spec.thrh, jafs=aux["jafs"].cpu().numpy(),
            data_jafs=spec.data_jafs, times=spec.times,
            lc=aux["lc"].cpu().numpy(), lh=spec.lh, mi=aux["mi"].cpu().numpy(),
            pr=aux["pr"].cpu().numpy(), scale_time=input_data.scale_time,
            scale_eps=input_data.scale_eps,
        )
        mi_format.write_migration(fout, text)
    t3 = time.time()

    # Report counters (reference MigrationInference.Report, :735-739),
    # summed over every evaluated candidate point
    print("Total number of likelihood function calls is", int(nfev))
    print("Lambda correction called", int(corr_called), "times.")
    print("Lambda correction failed", int(corr_failed), "times.")
    if clargs.debug:
        print_err("Runtime:   optimisation ", t2 - t1)
        print_err("           total        ", t3 - t0)
    print("Runtime:   optimisation", t2 - t1)
    print("           total       ", t3 - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
