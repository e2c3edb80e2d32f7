"""Frozen copy of the input readers of ``misti_tpu_torch/io/psmc.py`` and
``misti_tpu_torch/io/jsfs.py`` at commit 4de6f0d, for the benchmark's
reference: a later change to the port does not move it.  It imports
nothing of the port.

``read_psmc`` merges two PSMC demographies onto one time grid (upstream's
ReadPSMC, migrationIO.py:224-295) under MiSTI's default units (mutation
rate 1.25e-8, bin size 100, N0 10000, generation time 1), no heterozygosity
loss and no sample date; ``read_jafs_rows`` reads the chunk rows of a JSFS
file of format version 1.0 (migrationIO.py:526-575).
"""

from __future__ import annotations

MUT_RATE, BINSIZE, N0, GEN_TIME = 1.25e-8, 100.0, 10000.0, 1.0
THETA = 4.0 * BINSIZE * MUT_RATE * N0
SCALE_TIME = 2.0 * GEN_TIME * N0


def read_psmc_file(fn: str, rd: int = -1):
    """Parse one psmc output file -> [Tk, Lk, RD, theta, rho]."""
    max_rd = -1
    with open(fn) as f:
        for line in f:
            parts = line.split()
            if parts and parts[0] == "RD":
                max_rd = int(parts[1])
    if max_rd == -1:
        raise ValueError(f"Corrupted or empty input file: {fn}")
    if rd == -1 or rd > max_rd:
        rd = max_rd

    tk, lk, th, rh = [], [], 0.0, 0.0
    with open(fn) as f:
        it = iter(f)
        for line in it:
            parts = line.split()
            if not parts or parts[0] != "RD" or int(parts[1]) != rd:
                continue
            while parts[0] != "RS":
                if parts[0] == "TR":
                    th = float(parts[1])
                    rh = float(parts[2])
                parts = next(it).split()
            while parts[0] != "PA":
                if parts[0] != "RS":
                    raise ValueError("Unexpected line in psmc file.")
                tk.append(float(parts[2]))
                lk.append(float(parts[3]))
                parts = next(it).split()
            break
    return [tk, lk, rd, th, rh]


def read_psmc(fn1: str, fn2: str, rd: int = -1):
    """(times, lambdas, scale_time): the merged grid's interval lengths
    (numT - 1,), the coalescence-rate pairs (numT, 2) and the time scale."""
    d1 = read_psmc_file(fn1, rd)
    d2 = read_psmc_file(fn2, rd)
    d1[0] = [v * d1[3] / THETA for v in d1[0]]
    d1[1] = [v * d1[3] / THETA for v in d1[1]]
    d2[0] = [v * d2[3] / THETA for v in d2[0]]
    d2[1] = [v * d2[3] / THETA for v in d2[1]]

    tk = sorted(d1[0] + d2[0][1:])
    lk1: list = []
    j = 0
    for i in range(len(d1[0]) - 1):
        while tk[j] < d1[0][i + 1]:
            lk1.append(1.0 / d1[1][i])
            j += 1
    while len(lk1) < len(tk):
        lk1.append(1.0 / d1[1][-1])

    lk2: list = []
    j = 0
    for i in range(len(d2[0]) - 1):
        while tk[j] < d2[0][i + 1]:
            lk2.append(1.0 / d2[1][i])
            j += 1
    while len(lk2) < len(tk):
        lk2.append(1.0 / d2[1][-1])

    lambdas = [[u, v] for u, v in zip(lk1, lk2)]
    times = [u - v for u, v in zip(tk[1:], tk[:-1])]
    return times, lambdas, SCALE_TIME


def read_jafs_rows(fn: str) -> list:
    """The chunk rows (8 floats: total, then the 7 categories) of a MiSTI
    JSFS file of format version 1.0."""
    rows = []
    with open(fn) as f:
        first = f.readline()
        if not first.startswith("#MiSTI_JSFS") or float(first.split(" ")[2]) < 1:
            raise ValueError(f"{fn}: not a MiSTI JSFS file of version 1.0 or later")
        for line in f:
            line = line.rstrip("\n")
            if not line or line.startswith("#") or line.startswith("total"):
                continue
            parts = line.split("\t")
            if len(parts) != 8:
                raise ValueError(f"{fn}: expected eight TAB-separated columns")
            rows.append([float(v) for v in parts])
    return rows
