""".mi result file writer/reader (reference migrationIO.py:346-504).

The ``#MiSTI2 ver 0.4`` format is byte-compatible with the reference:
LK/ST/SD/TR/SFS/DSF/SCT/SCE records, then one RS record per merged time
point with cumulative time, corrected and uncorrected inverse rates,
per-interval migration rates and (pre-split) the six lineage-location
probabilities per genome.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .data import MigData


def format_migration(
    llh: float,
    split_t: int,
    sample_date: int,
    thrh: Sequence[float],
    jafs: Sequence[float],
    data_jafs: Sequence[float],
    times: Sequence[float],
    lc: np.ndarray,
    lh: np.ndarray,
    mi: np.ndarray,
    pr: np.ndarray,
    scale_time: float = 1,
    scale_eps: float = 1,
) -> str:
    """Render the v0.4 .mi text (reference OutputMigration, migrationIO.py:346-375)."""
    cum = [float(sum(times[0:i])) for i in range(len(times) + 1)]
    data_norm = [v / sum(data_jafs) for v in data_jafs]
    out = "#MiSTI2 ver 0.4\n"
    out += "LK\t" + str(llh) + "\n"
    out += "ST\t" + str(split_t) + "\n"
    out += "SD\t" + str(sample_date) + "\n"
    out += "TR\t" + str(thrh[0]) + "\t" + str(thrh[1]) + "\n"
    out += "SFS\t" + "\t".join(map(str, [float(v) for v in jafs])) + "\n"
    out += "DSF\t" + "\t".join(map(str, [float(v) for v in data_norm])) + "\n"
    out += "SCT\t" + str(scale_time) + "\n"
    out += "SCE\t" + str(scale_eps) + "\n"
    for i in range(len(cum)):
        out += (
            "RS\t" + str(cum[i])
            + "\t" + str(1.0 / float(lc[i][0])) + "\t" + str(1.0 / float(lc[i][1]))
            + "\t" + str(1.0 / float(lh[i][0])) + "\t" + str(1.0 / float(lh[i][1]))
            + "\t" + str(float(mi[i][0])) + "\t" + str(float(mi[i][1]))
        )
        if i < split_t:
            for c in range(3):  # pr[i] is (3, 2): [location][genome]
                out += "\t" + str(float(pr[i][c][0])) + "\t" + str(float(pr[i][c][1]))
        out += "\n"
    return out


def write_migration(fout: str, text: str) -> None:
    if fout == "":
        print(text)
    else:
        with open(fout, "w") as fw:
            fw.write(text)


def read_migration(fmigr: str) -> MigData:
    """Parse a .mi file, v0.4 or v0.3 (reference ReadMigration)."""
    data = MigData()
    times, lc1, lc2, lh1, lh2, mu1, mu2 = [], [], [], [], [], [], []
    pr11: list = [[], []]
    pr22: list = [[], []]
    pr12: list = [[], []]
    scale_time = 1.0
    scale_eps = 1.0
    with open(fmigr) as f:
        header = next(f).rstrip().split(" ")
        version = float(header[2])
        data.version = version
        if version < 0.3:
            raise ValueError("File version is not supported anymore.")
        new_fmt = header[0] == "#MiSTI2"
        for line in f:
            p = line.rstrip("\n").split("\t")
            tag = p[0]
            if tag == "LK":
                data.llh = float(p[1])
            elif tag == "ST":
                data.split_t = int(p[1])
            elif tag == "SD":
                data.sample_date = int(p[1])
            elif tag == "MS":
                data.mig_start = int(p[1])
            elif tag == "ME":
                data.mig_end = int(p[1])
            elif tag == "MU":
                data.mi = [float(p[1]), float(p[2])]
            elif tag == "TR":
                data.thrh = [float(p[1]), float(p[2])]
            elif tag == "SFS":
                data.jafs = [float(v) for v in p[1:]]
            elif tag == "SCT":
                scale_time = float(p[1])
            elif tag == "SCE":
                scale_eps = float(p[1])
            elif tag == "RS":
                times.append(float(p[1]) * scale_time)
                lc1.append(1.0 / float(p[2]) / scale_eps)
                lc2.append(1.0 / float(p[3]) / scale_eps)
                shift = 0
                if new_fmt and version >= 0.4:
                    lh1.append(1.0 / float(p[4]) / scale_eps)
                    lh2.append(1.0 / float(p[5]) / scale_eps)
                    shift = 2
                if new_fmt:
                    mu1.append(float(p[4 + shift]))
                    mu2.append(float(p[5 + shift]))
                    if len(p) > 6 + shift:
                        pr11[0].append(float(p[6 + shift]))
                        pr11[1].append(float(p[7 + shift]))
                        pr22[0].append(float(p[8 + shift]))
                        pr22[1].append(float(p[9 + shift]))
                        pr12[0].append(float(p[10 + shift]))
                        pr12[1].append(float(p[11 + shift]))
                    else:
                        for pr in (pr11, pr22, pr12):
                            pr[0].append(0.0)
                            pr[1].append(0.0)
    data.times = times
    data.lambda1 = lc1
    data.lambda2 = lc2
    data.lambdah1 = lh1
    data.lambdah2 = lh2
    data.mu1 = mu1
    data.mu2 = mu2
    data.pr11 = pr11
    data.pr22 = pr22
    data.pr12 = pr12
    data.scale_time = scale_time
    data.scale_eps = scale_eps
    return data
