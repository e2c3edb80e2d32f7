"""Plot CLI, flag-compatible with the reference MiSTIPlot.py.

Renders the 5-panel figure from a .mi result file.  The reference's
``--fpsmc`` overlay path is broken (stale ReadPSMC signature,
MiSTIPlot.py:104); here it works: the raw PSMC EPS trajectories are
overlaid on the main panel.
"""

from __future__ import annotations

import argparse
import os
import sys


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Migration inference from PSMC.")
    p.add_argument("fmigr", help="migr file")
    p.add_argument("--fpsmc", "-fp", nargs=2, type=str, default=None,
                   help="psmc files")
    p.add_argument("--funits", type=str, default="setunits.txt",
                   help="units file for time/EPS rescaling")
    p.add_argument("-wd", default="", help="working directory (path to data files)")
    p.add_argument("-o", default="plot.pdf", help="output filename")
    p.add_argument("--sdate", type=float, default=0,
                   help="dating of the second sample (years; set units properly)")
    p.add_argument("-rd", type=int, default=-1, help="round (RD) in PSMC file")
    p.add_argument("--maxY", type=float, default=None)
    p.add_argument("--minY", type=float, default=None)
    p.add_argument("--maxX", type=float, default=None)
    p.add_argument("--minX", type=float, default=None)
    p.add_argument("--hideProbs", "-hp", action="store_true",
                   help="hide probability panels")
    return p


def main(argv=None) -> int:
    clargs = make_parser().parse_args(argv)

    from ..io import mi_format
    from ..io import psmc as io_psmc
    from ..io.units import Units
    from ..plotting import plot_migration

    Units.set_units_from_file(clargs.funits)
    Units.print_units()

    fmigr = os.path.join(clargs.wd, clargs.fmigr)
    fout = os.path.join(clargs.wd, clargs.o)
    print("Output file: ", fout)

    overlay = None
    if clargs.fpsmc is not None:
        overlay = io_psmc.read_psmc(
            os.path.join(clargs.wd, clargs.fpsmc[0]),
            os.path.join(clargs.wd, clargs.fpsmc[1]),
            clargs.sdate, clargs.rd,
        )

    data = mi_format.read_migration(fmigr)
    limits = {
        k: v for k, v in (
            ("maxY", clargs.maxY), ("minY", clargs.minY),
            ("maxX", clargs.maxX), ("minX", clargs.minX),
        ) if v is not None
    }
    title = f"llh = {'-' if data.llh is None else round(data.llh, 1)}\ninput file {fmigr}"
    plot_migration(data, fout, limits=limits, hide_probs=clargs.hideProbs,
                   psmc_overlay=overlay, title=title)
    return 0


if __name__ == "__main__":
    sys.exit(main())
