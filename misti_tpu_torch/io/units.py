"""Units configuration (reference Units class, migrationIO.py:100-176).

A module-level mutable singleton, as the reference uses class-level static
variables shared across the whole program.  Loaded from a ``key=value`` file
(setunits.txt format; keys mutRate, binsize, N0, genTime).
"""

from __future__ import annotations

import sys


class Units:
    mut_rate: float = 1.25e-8
    binsize: float = 100
    n0: float = 10000
    gen_time: float = 1
    hetloss1: float = 0.0
    hetloss2: float = 0.0

    @classmethod
    def theta(cls) -> float:
        return 4.0 * cls.binsize * cls.mut_rate * cls.n0

    @classmethod
    def scale_time(cls) -> float:
        return 2.0 * cls.gen_time * cls.n0

    @classmethod
    def set_het_loss(cls, hl) -> None:
        for i, attr in ((0, "hetloss1"), (1, "hetloss2")):
            if hl[i] is None:
                continue
            if not (0.0 <= hl[i] < 1.0):
                raise ValueError("Hetloss should be between 0 and 1.")
            setattr(cls, attr, float(hl[i]))

    @classmethod
    def set_units_from_file(cls, fn: str) -> None:
        keys = {
            "mutRate": "mut_rate",
            "binsize": "binsize",
            "N0": "n0",
            "genTime": "gen_time",
        }
        try:
            with open(fn) as f:
                for line in f:
                    parts = line.split("=")
                    if len(parts) == 2 and parts[0] in keys:
                        try:
                            setattr(cls, keys[parts[0]], float(parts[1]))
                        except ValueError:
                            print(
                                f"Cannot read {parts[0]} entry from file, "
                                "using default or previous values"
                            )
        except OSError:
            print("Units input file not found, using default values.")

    @classmethod
    def print_units(cls) -> None:
        print(
            "Units: mutation rate =", cls.mut_rate, "\tbinsize =", cls.binsize,
            "\tN0 =", cls.n0, "\tgeneration time =", cls.gen_time,
        )

    @classmethod
    def reset(cls) -> None:
        cls.mut_rate = 1.25e-8
        cls.binsize = 100
        cls.n0 = 10000
        cls.gen_time = 1
        cls.hetloss1 = 0.0
        cls.hetloss2 = 0.0


def print_err(*args, sep="", endl="\n"):
    sys.stderr.write(sep.join(str(a) for a in args) + endl)
