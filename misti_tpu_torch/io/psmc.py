"""PSMC output parsing and two-genome time-grid merging.

Faithful re-implementation of the reference readers:
* ``read_psmc_file``: one psmc text file (RD/TR/RS/PA records) for a chosen
  EM round (migrationIO.py:183-222);
* ``read_psmc``: theta-rescaling of both genomes to a common grid, ancient
  sample-date insertion, and the merged-discretisation construction
  (migrationIO.py:224-295).  The float-equality indexing of the sample date
  (``Tk.index(sdResc)``) is reproduced exactly: split times shift by one
  interval if this drifts (SURVEY.md hard-part 5);
* ``read_psmc1`` (psmcMode=1): alternative reader using the MM pattern lines
  and per-interval rate re-estimation (migrationIO.py:297-340, psmc.py).
"""

from __future__ import annotations

from .data import InputData
from .units import Units
from .psmc_alt import load_psmc_demography


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


def read_psmc(fn1: str, fn2: str, sample_date: float = 0.0, rd: int = -1) -> InputData:
    """Merge two PSMC demographies onto one time grid (reference ReadPSMC)."""
    d1 = read_psmc_file(fn1, rd)
    d2 = read_psmc_file(fn2, rd)

    d1[3] = d1[3] / (1.0 - Units.hetloss1)
    d2[3] = d2[3] / (1.0 - Units.hetloss2)
    theta = Units.theta()
    scale_time = Units.scale_time()
    scale_eps = 1

    d1[0] = [v * d1[3] / theta for v in d1[0]]
    d1[1] = [v * d1[3] / theta for v in d1[1]]
    d2[0] = [v * d2[3] / theta for v in d2[0]]
    d2[1] = [v * d2[3] / theta for v in d2[1]]

    sd_resc = sample_date / 2 / Units.n0 / Units.gen_time
    if sd_resc > 0:
        d2[0] = [v + sd_resc for v in d2[0]]
        d2[0].insert(0, 0.0)
        d2[1].insert(0, 1.0)

    tk = sorted(d1[0] + d2[0][1:])
    try:
        sample_date_discr = tk.index(sd_resc)
    except ValueError as e:
        raise ValueError(
            "sample date not on the merged grid (float-equality indexing, "
            "reference migrationIO.py:255)"
        ) from e

    t_psmc = [[0], [0]]
    lk1: list = []
    j = 0
    for i in range(len(d1[0]) - 1):
        while tk[j] < d1[0][i + 1]:
            lk1.append(1.0 / d1[1][i])
            j += 1
        t_psmc[0].append(j)
    while len(lk1) < len(tk):
        lk1.append(1.0 / d1[1][-1])

    lk2: list = []
    j = 0
    for i in range(len(d2[0]) - 1):
        while tk[j] < d2[0][i + 1]:
            lk2.append(1.0 / d2[1][i])
            j += 1
        t_psmc[1].append(j)
    while len(lk2) < len(tk):
        lk2.append(1.0 / d2[1][-1])

    t_psmc[0].append(len(tk))
    t_psmc[1].append(len(tk))

    lk = [[u, v] for u, v in zip(lk1, lk2)]
    dt = [u - v for u, v in zip(tk[1:], tk[:-1])]
    return InputData(
        times=dt,
        lambdas=lk,
        scale_time=scale_time,
        theta=theta,
        scale_eps=scale_eps,
        rho=d1[4] * theta / d1[3],
        sample_date_discr=sample_date_discr,
        t_psmc=t_psmc,
    )


def read_psmc1(fn1: str, fn2: str, rd: int = -1, divergence_time: float = -1) -> InputData:
    """psmcMode=1 reader (reference ReadPSMC1, migrationIO.py:297-340)."""
    if Units.hetloss1 != 0.0 or Units.hetloss2 != 0.0:
        print("Hetloss is not implemented in this mode.")
    theta = Units.theta()
    scale_time = Units.scale_time()

    demogs = [load_psmc_demography(fn1, rd).with_theta(theta),
              load_psmc_demography(fn2, rd).with_theta(theta)]
    collapsed = [d.group_starts() for d in demogs]
    if len(collapsed[0]) != len(collapsed[1]):
        raise ValueError("PSMC files have different pattern lengths.")

    tk = [] if divergence_time == -1 else [divergence_time / scale_time]
    for t1, t2 in zip(collapsed[0], collapsed[1]):
        tk.append((t1 + t2) / 2.0)
    tk = sorted(set(tk))
    div_id = -1 if divergence_time == -1 else tk.index(divergence_time / scale_time)

    lk = [demogs[0].regrid_rates(tk), demogs[1].regrid_rates(tk)]
    lk_pairs = [[u, v] for u, v in zip(lk[0], lk[1])]
    dt = [u - v for u, v in zip(tk[1:], tk[:-1])]
    return InputData(
        times=dt, lambdas=lk_pairs, scale_time=scale_time, theta=theta,
        divergence_time=div_id,
    )
