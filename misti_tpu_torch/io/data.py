"""Shared IO data containers (reference migrationIO.py:38-98)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class InputData:
    """Merged demographic-model input (reference InputData, migrationIO.py:46-63)."""

    times: list  # interval lengths (numT-1,)
    lambdas: list  # (numT, 2) coalescence-rate pairs
    scale_time: float
    theta: float
    divergence_time: float = -1
    scale_eps: float = 1.0
    rho: Optional[float] = None
    sample_date_discr: int = 0
    t_psmc: Optional[list] = None  # per-genome merged-interval boundaries
    mi: Optional[list] = None  # migration bands [pop, start, end, rate, opt]
    pu: Optional[list] = None  # pulses [pop, time, rate, opt]


@dataclasses.dataclass
class Jafs:
    """Joint SFS chunks (reference JAFS class, migrationIO.py:38-44)."""

    jafs: list = dataclasses.field(default_factory=list)  # rows of 8 floats
    pop1: Optional[str] = None
    pop2: Optional[str] = None

    def summed(self) -> np.ndarray:
        """Sum chunk rows into a single 8-vector (MiSTI.py:173-176)."""
        total = np.zeros(8)
        for row in self.jafs:
            total += np.asarray(row, dtype=float)
        return total


@dataclasses.dataclass
class MigData:
    """Parsed .mi result file (reference MigData, migrationIO.py:65-98)."""

    llh: Optional[float] = None
    split_t: Optional[int] = None
    sample_date: int = 0
    mig_start: Optional[int] = None
    mig_end: Optional[int] = None
    times: Optional[list] = None
    lambda1: Optional[list] = None
    lambda2: Optional[list] = None
    lambdah1: Optional[list] = None
    lambdah2: Optional[list] = None
    mu1: Optional[list] = None
    mu2: Optional[list] = None
    pr11: Optional[list] = None
    pr22: Optional[list] = None
    pr12: Optional[list] = None
    thrh: Optional[list] = None
    mi: Optional[list] = None
    jafs: Optional[list] = None
    scale_time: float = 1.0
    scale_eps: float = 1.0
    version: float = 0.4
