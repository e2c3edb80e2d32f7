"""Converter and analysis tools (reference utils/ scripts, re-implemented).

Each ``*_main`` mirrors one reference script's CLI and output format:

* angsdsfs     -- ANGSD realSFS 3x3 output -> MiSTI JSFS rows (ANGSDSFS.py)
* ms2jsfs      -- msHOT-lite `-l` output -> chunked JSFS (MS2JSFS.py)
* scrm2jafs    -- scrm/ms `positions` output -> normalised JSFS (SCRM2JAFS.py)
* merge_jsfs   -- merge many JSFS files/dirs (MergeJSFS.py; the reference
                  prints its loop's last `jaf`, which accumulates ALL files'
                  rows only through the JAFS class's shared mutable default
                  list (migrationIO.py:38-40) -- here the concatenation is
                  explicit and the output bytes are identical)
* generate_jsfs_bs -- true SFS + N bootstrap rows (generateJSFS_bs.py)
* calc_time    -- merged-interval index -> generations table (calc_time.py)
* ttmethod     -- TT-method split-time estimator (ttmethod.py)
* msrates      -- debug-print a parsed ms command (MSrates.py)
* mssplit      -- split a 4-haplotype msHOT-lite stream into two per-genome
                  pseudo-.ms files for per-genome PSMC (MSSPLIT.py)
* misti2ms     -- .mi result -> equivalent ms command (MiSTI2MS.py; the
                  reference calls a nonexistent SetScaling -- here the
                  scaling comes from Units, its evident intent)

Run one as ``python -m misti_tpu_torch.cli.tools <tool> [arguments]``, e.g.
``python -m misti_tpu_torch.cli.tools merge_jsfs a.jsfs b.jsfs``.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
from math import log

from ..io import jsfs as io_jsfs
from ..io import mi_format
from ..io import ms_parse
from ..io import psmc as io_psmc
from ..io.units import Units, print_err


# ---------------------------------------------------------------------- #
def angsdsfs_main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 1:
        print("angsdsfs <INPUT FILE> [pop1 pop2]")
        return 0
    pop1 = pop2 = False
    if len(argv) == 3:
        pop1, pop2 = argv[1], argv[2]
    else:
        print_err(
            "IMPORTANT NOTICE!!! It is strongly recommended to supply "
            "population 1 and population 2 names to ensure that the order of "
            "psmc files is not swapped relatively to the joint allele "
            "frequency spectrum."
        )
    jafs = []
    with open(argv[0]) as f:
        for line in f:
            sfs = [float(v) for v in line.rstrip("\n").split(" ")[0:8]]
            # realSFS 3x3 row-major (d1 fast axis) -> MiSTI category order
            jafs.append([sum(sfs), sfs[3], sfs[6], sfs[1], sfs[4], sfs[7],
                         sfs[2], sfs[5]])
    io_jsfs.print_jafs_file(jafs, pop1, pop2)
    return 0


# ---------------------------------------------------------------------- #
def _classify(s0: int, s1: int, jaf: list) -> None:
    """Derived-count pair -> JSFS category (MS2JSFS.py:148-164)."""
    if s0 == 0:
        if s1 == 1:
            jaf[2] += 1
        elif s1 == 2:
            jaf[5] += 1
    elif s0 == 1:
        if s1 == 0:
            jaf[0] += 1
        elif s1 == 1:
            jaf[3] += 1
        elif s1 == 2:
            jaf[6] += 1
    elif s0 == 2:
        if s1 == 0:
            jaf[1] += 1
        elif s1 == 1:
            jaf[4] += 1


def ms2jsfs_main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Joint SFS from Heng Li's msHOT-lite output (-l option)."
    )
    p.add_argument("inputfile", help="msHOT-lite -l output")
    p.add_argument("-p", nargs=2, type=str, help="population names")
    p.add_argument("-n", type=int, default=200, help="number of chunks for bootstrap")
    clargs = p.parse_args(argv)
    pop1 = pop2 = False
    if clargs.p is not None:
        pop1, pop2 = clargs.p

    jaf = [0] * 7
    jafs: list = []

    def save(ch_len):
        jafs.append([ch_len, *jaf])
        for i in range(7):
            jaf[i] = 0

    def add_position(begin, end, remaining):
        if end - begin < remaining:
            return remaining - (end - begin)
        save(chunk_len)
        return chunk_len - ((end - begin) - remaining)

    with open(clargs.inputfile) as f:
        line = next(f, "EOF")
        if line == "EOF":
            return 0
        pars = line.split(" ")
        num_chrom = int(pars[2])
        chrom_len = 0
        for i, v in enumerate(pars):
            if v == "-r" and i + 2 < len(pars):
                chrom_len = int(pars[i + 2])
                break
        if chrom_len <= 0:
            print_err(
                "Unknown number of chromosomes. The script is designed to "
                "work with ms commands containing -r argument."
            )
            return 1
        chunk_len = math.ceil(num_chrom * chrom_len / clargs.n)
        pr_position = 0
        ch_len = chunk_len
        while line != "EOF":
            while not (line.startswith("@begin") or line == "EOF"):
                line = next(f, "EOF")
                if line.startswith("segsites:"):
                    ch_len = add_position(0, chrom_len, ch_len)
            while not (line.startswith("@end") or line == "EOF"):
                line = next(f, "EOF").rstrip("\n")
                pars = line.split("\t")
                if line.startswith("@end"):
                    ch_len = add_position(pr_position, chrom_len, ch_len)
                    pr_position = 0
                if len(pars) != 2:
                    continue
                position = int(pars[0])
                ch_len = add_position(pr_position, position, ch_len)
                pr_position = position
                fr = pars[1][0:4]
                _classify(int(fr[0]) + int(fr[1]), int(fr[2]) + int(fr[3]), jaf)
    if len(jafs) != clargs.n:
        save(chunk_len - ch_len)
    io_jsfs.print_jafs_file(jafs, pop1, pop2)
    return 0


# ---------------------------------------------------------------------- #
def scrm2jafs_main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 1:
        print("scrm2jafs <INPUT FILE>")
        return 0
    jaf = [0] * 7
    with open(argv[0]) as f:
        for line in f:
            if line[0:9] == "positions":
                chrs = []
                for _ in range(4):
                    line = next(f)
                    chrs.append([int(v) for v in line[0:-1]])
                for i in range(len(chrs[0])):
                    _classify(chrs[0][i] + chrs[1][i], chrs[2][i] + chrs[3][i], jaf)
    total = sum(jaf)
    for v in jaf:
        print(v / total)
    return 0


# ---------------------------------------------------------------------- #
def merge_jsfs_main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 1:
        print("merge_jsfs <ANY NUMBER OF INPUT FILES OR DIRECTORIES>")
        return 0
    pop1, pop2 = [], []
    rows: list = []

    def ingest(path):
        d = io_jsfs.read_jafs(path, silent=True)
        rows.extend(d.jafs)
        if d.pop1 is not None:
            pop1.append(d.pop1)
        if d.pop2 is not None:
            pop2.append(d.pop2)

    for fn in argv:
        if os.path.isdir(fn):
            for fn1 in sorted(os.listdir(fn)):
                if not fn1.startswith("."):
                    ingest(os.path.join(fn, fn1))
        else:
            ingest(fn)
    io_jsfs.print_jafs_file(
        rows, "+".join(sorted(set(pop1))), "+".join(sorted(set(pop2)))
    )
    return 0


# ---------------------------------------------------------------------- #
def generate_jsfs_bs_main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print("generate_jsfs_bs <number of bs samples> <Joint SFS file with chunks>")
        return 0
    bs_size = int(argv[0])
    data = io_jsfs.read_jafs(argv[1], silent=True)
    rows = [list(data.summed())]
    for _ in range(bs_size):
        rows.append(io_jsfs.bootstrap_jafs(data))
    io_jsfs.print_jafs_file(rows, data.pop1, data.pop2)
    return 0


# ---------------------------------------------------------------------- #
def calc_time_main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Merged-interval index -> generations.")
    p.add_argument("fpsmc1")
    p.add_argument("fpsmc2")
    p.add_argument("-wd", default="")
    p.add_argument("--sdate", type=float, default=0)
    p.add_argument("-rd", type=int, default=-1)
    p.add_argument("--funits", type=str, default="setunits.txt")
    p.add_argument("--hetloss", "-hl", nargs=2, type=float, default=None)
    p.add_argument("--psmcMode", "-pm", type=int, default=0)
    p.add_argument("--splitTime", "-st", type=int, default=-1)
    clargs = p.parse_args(argv)
    Units.set_units_from_file(clargs.funits)
    Units.print_units()
    if clargs.hetloss is not None:
        Units.set_het_loss(clargs.hetloss)
    f1 = os.path.join(clargs.wd, clargs.fpsmc1)
    f2 = os.path.join(clargs.wd, clargs.fpsmc2)
    if clargs.psmcMode == 0:
        d = io_psmc.read_psmc(f1, f2, clargs.sdate, clargs.rd)
    else:
        d = io_psmc.read_psmc1(f1, f2, clargs.rd, divergence_time=clargs.splitTime)
    for split_t in range(len(d.times)):
        print(split_t, "\t", int(sum(d.times[0:split_t]) * d.scale_time))
    return 0


# ---------------------------------------------------------------------- #
def ttmethod_main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Implementation of TT-method (Schlebusch et al, Genetics 2017)"
    )
    p.add_argument("jafs", help="joint allele frequency spectrum")
    p.add_argument("haplen", help="haplotype length (total number of sites)")
    p.add_argument("-y", type=float, default=1, help="years per generation")
    p.add_argument("-mu", type=float, default=1.25e-8,
                   help="mutation rate per bp per generation")
    clargs = p.parse_args(argv)
    spectrum = io_jsfs.read_jafs(clargs.jafs).summed()[1:]
    m_len = float(clargs.haplen)
    m1, m3, m2, m5, m6, m4, m7 = spectrum  # paper notation permutation
    t1 = (m1 / 2 + m3 - (2 * m6 + m5) * (6 * m7 + m5) / 8 / m5) / m_len
    t2 = (m2 / 2 + m4 - (2 * m7 + m5) * (6 * m6 + m5) / 8 / m5) / m_len
    a1 = 2 * m5 / (2 * m6 + m5)
    a2 = 2 * m5 / (2 * m7 + m5)
    theta = 3 / m_len * (2 * m6 + m5) * (2 * m7 + m5) / (8 * m5) / 2
    theta1 = -t1 / log(a1) / 2
    theta2 = -t2 / log(a2) / 2
    print("Implementation of tt method (Schlebusch et al, Genetics 2017)")
    print("T1 = ", t1 / clargs.mu * clargs.y)
    print("T2 = ", t2 / clargs.mu * clargs.y)
    print("N_A = ", theta / clargs.mu, "\tN_1 = ", theta1 / clargs.mu,
          "\tN_2 = ", theta2 / clargs.mu)
    return 0


# ---------------------------------------------------------------------- #
def msrates_main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Debug-print a parsed ms command.")
    p.add_argument("ms", help="ms command line")
    clargs = p.parse_args(argv)
    d = ms_parse.read_ms(clargs.ms)
    print("times           ", d.times)
    print("lambdas         ", d.lambdas)
    print("divergenceTime  ", d.divergence_time)
    print("mi              ", d.mi)
    print("pu              ", d.pu)
    return 0


# ---------------------------------------------------------------------- #
def mssplit_main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print("mssplit <INPUT FILE> <DESTINATION FOLDER>")
        return 0
    fn, dest = argv[0], argv[1]
    with open(os.path.join(dest, "ms2g1.ms"), "w") as fw1, open(
        os.path.join(dest, "ms2g2.ms"), "w"
    ) as fw2, open(fn) as f:
        for line in f:
            for _ in range(2):
                fw1.write(line)
                fw2.write(line)
                line = next(f)
            chr_len = int(next(f))
            f1, f2 = [], []
            count = 0
            while True:
                line = next(f)
                count += 1
                if count > chr_len:
                    raise ValueError(
                        f"Too many segsites, expected at most {chr_len}"
                    )
                if line == "@end\n":
                    break
                pos, hap = line.split("\t")[0:2]
                if hap[0] != hap[1]:
                    f1.append(pos)
                if hap[2] != hap[3]:
                    f2.append(pos)
            for fw, sites in ((fw1, f1), (fw2, f2)):
                fw.write(f"@begin {len(sites)}\n")
                fw.write(f"{chr_len}\n")
                for v in sites:
                    fw.write(v + "\t10\n")
                fw.write("@end\n")
    return 0


# ---------------------------------------------------------------------- #
def misti2ms_main(argv=None) -> int:
    p = argparse.ArgumentParser(description=".mi result -> equivalent ms command.")
    p.add_argument("fmigr", help="migr file")
    p.add_argument("--funits", type=str, default="setunits.txt")
    clargs = p.parse_args(argv)
    Units.set_units_from_file(clargs.funits)
    data = mi_format.read_migration(clargs.fmigr)
    num_t = len(data.times)

    chrom_len = 3000000
    chrom_num = 1000
    # scaling from Units (the reference's nonexistent SetScaling intent)
    n0 = data.thrh[0] / (4 * Units.binsize * Units.mut_rate)
    n0_rescale = 10000 / n0
    theta = chrom_len * data.thrh[0] / Units.binsize * n0_rescale
    rho = chrom_len * data.thrh[1] / Units.binsize * n0_rescale

    ms = (f" 4 {chrom_num} -t {theta} -r {rho} {chrom_len} -l -I 2 2 2 ")
    lp = [0.0, 0.0]
    for i in range(data.split_t):
        if lp[0] != data.lambda1[i]:
            ms += f" -en {data.times[i] / 2.0 / n0_rescale} 1 {n0_rescale / data.lambda1[i]}"
            lp[0] = data.lambda1[i]
        if lp[1] != data.lambda2[i]:
            ms += f" -en {data.times[i] / 2.0 / n0_rescale} 2 {n0_rescale / data.lambda2[i]}"
            lp[1] = data.lambda2[i]
    # migration band: from the per-interval mu columns (v0.4 format)
    mu1 = data.mu1 or []
    mu2 = data.mu2 or []
    band = [i for i in range(len(mu1)) if mu1[i] > 0 or mu2[i] > 0]
    if band:
        start, end = band[0], band[-1] + 1
        ms += f" -em {data.times[start] / 2.0 / n0_rescale} 1 2 {2 * mu1[start] * n0_rescale}"
        ms += f" -em {data.times[start] / 2.0 / n0_rescale} 2 1 {2 * mu2[start] * n0_rescale}"
        ms += f" -eM {data.times[min(end, num_t - 1)] / 2.0 / n0_rescale} 0.0 "
    ms += f" -ej {data.times[data.split_t] / 2.0 / n0_rescale} 2 1 "
    ms += f" -eM {data.times[data.split_t] / 2.0 / n0_rescale} 0.0 "
    lp0 = 0.0
    for i in range(data.split_t, num_t):
        if lp0 != data.lambda1[i]:
            ms += f" -eN {data.times[i] / 2.0 / n0_rescale} {n0_rescale / data.lambda1[i]}"
            lp0 = data.lambda1[i]
    print(ms)
    return 0


TOOLS = ("angsdsfs", "ms2jsfs", "scrm2jafs", "merge_jsfs", "generate_jsfs_bs", "calc_time",
         "ttmethod", "msrates", "mssplit", "misti2ms")

if __name__ == "__main__":
    if len(sys.argv) < 2 or sys.argv[1] not in TOOLS:
        print(f"usage: python -m misti_tpu_torch.cli.tools {{{','.join(TOOLS)}}} [arguments]")
        sys.exit(2)
    sys.exit(globals()[f"{sys.argv[1]}_main"](sys.argv[2:]))
