"""JSFS file format: read/write/bootstrap (reference migrationIO.py:506-656).

Canonical MiSTI JSFS text format::

    #MiSTI_JSFS version 1.0
    [#pop1\t<label>]
    [#pop2\t<label>]
    total  0100  1100  0001  0101  1101  0011  0111
    <total> <c1> ... <c7>        (one row per genome chunk, for bootstrap)

Category semantics (derived-allele counts (s0, s1) per diploid):
col1=(1,0) col2=(2,0) col3=(0,1) col4=(1,1) col5=(2,1) col6=(0,2) col7=(1,2).
"""

from __future__ import annotations

import random
import sys
from typing import Optional, TextIO

from .data import Jafs


def read_jafs(fn: str, silent: bool = True) -> Jafs:
    with open(fn) as f:
        first = f.readline().rstrip("\n")
    if not (
        first.startswith("#MiSTI_JSFS")
        or first.startswith("#MiSTI_JAF")
        or first.startswith("#Migration_JAF")
    ):
        raise ValueError("Corrupted JSFS file header.")
    version = float(first.split(" ")[2])
    if version < 1:
        return _read_jafs_old(fn, silent)

    out = Jafs()
    with open(fn) as f:
        line = f.readline().rstrip("\n")
        while line.startswith("#"):
            line = f.readline().rstrip("\n")
            if line[1:5] == "pop1":
                parts = line.split("\t")
                if len(parts) != 2:
                    raise ValueError("Corrupted JSFS file header.")
                out.pop1 = parts[1]
            elif line[1:5] == "pop2":
                parts = line.split("\t")
                if len(parts) != 2:
                    raise ValueError("Corrupted JSFS file header.")
                out.pop2 = parts[1]
        if line.startswith("total"):
            line = f.readline().rstrip("\n")
        while line:
            parts = line.split("\t")
            if len(parts) != 8:
                raise ValueError(
                    "Unexpected line. Expected an entry for JSFS with eight "
                    "TAB-separated columns."
                )
            out.jafs.append([float(v) for v in parts])
            line = f.readline().rstrip("\n")
    return out


def _read_jafs_old(fn: str, silent: bool = True) -> Jafs:
    """Legacy single-column format (8 lines of `label\\tvalue`)."""
    out = Jafs()
    vals = []
    with open(fn) as f:
        line = f.readline().rstrip()
        while line.startswith("#"):
            if line[1:5] == "pop1":
                out.pop1 = line.split(" ")[1]
            elif line[1:5] == "pop2":
                out.pop2 = line.split(" ")[1]
            line = f.readline().rstrip()
        while line:
            parts = line.split("\t")
            if len(parts) != 2:
                raise ValueError(
                    "Unexpected line. Expected an entry for JAFS with two "
                    "TAB-separated columns."
                )
            vals.append(int(parts[1]))
            line = f.readline().rstrip()
    if len(vals) != 8:
        raise ValueError("Unexpected number of lines in the JAFS file.")
    out.jafs.append(vals)
    return out


def bootstrap_jafs(jafs: Jafs, normalize: bool = False, rng: Optional[random.Random] = None) -> list:
    """Resample chunk rows with replacement to one genome length
    (reference BootstrapJAFS, migrationIO.py:506-524)."""
    rng = rng or random
    genome_len = 0.0
    seg_sites = 0.0
    for row in jafs.jafs:
        if len(row) != 8:
            raise ValueError("Cannot use provided SFS for bootstrap.")
        genome_len += row[0]
        seg_sites += sum(row[1:])
    sfs = [0.0] * 8
    while sfs[0] < genome_len:
        row = jafs.jafs[rng.randint(0, len(jafs.jafs) - 1)]
        for i in range(8):
            sfs[i] += row[i]
    if normalize:
        bs_sites = sum(sfs[1:])
        sfs = [v * (seg_sites / bs_sites) for v in sfs]
    return sfs


def print_jafs_file(jaf, pop1=False, pop2=False, file: Optional[TextIO] = None) -> None:
    """Write the canonical JSFS format (reference PrintJAFSFile).

    ``file`` defaults to the CURRENT sys.stdout at call time (a def-time
    default would bypass redirect_stdout and any CLI output capture)."""
    file = file if file is not None else sys.stdout
    print("#MiSTI_JSFS version 1.0", file=file)
    if pop1:
        print("#pop1", str(pop1).strip("\n\r"), sep="\t", file=file)
    if pop2:
        print("#pop2", str(pop2).strip("\n\r"), sep="\t", file=file)
    print("\t".join(["total", "0100", "1100", "0001", "0101", "1101", "0011", "0111"]),
          file=file)
    if not isinstance(jaf, list):
        raise ValueError("Unexpected SFS value: should be a list")
    rows = jaf if isinstance(jaf[0], list) else [jaf]
    for sfs in rows:
        if len(sfs) == 7:
            print(str(sum(sfs)) + "\t" + "\t".join(str(v) for v in sfs), file=file)
        elif len(sfs) == 8:
            print("\t".join(str(v) for v in sfs), file=file)
        else:
            raise ValueError("Unexpected SFS entry.")
