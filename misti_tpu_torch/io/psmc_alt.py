"""Pattern-aware PSMC demography model for the psmcMode=1 reader.

Covers the same capability as the reference's alternative PSMC reader
(psmc.py:25-163): parse a psmc output including its ``MM pattern:``
discretisation, rescale to a common theta, and re-estimate one constant
coalescence rate per merged-grid interval.  The implementation here is a
functional, vectorised redesign rather than the reference's stateful
index-walking loops:

* the demography is an immutable ``PiecewiseDemography`` record; theta
  rescaling returns a new record (reference mutates in place,
  psmc.py:83-87);
* per-interval overlaps with the PSMC segmentation are computed by numpy
  interval clipping over ALL segments at once instead of a cursor walk
  (reference psmc.py:97-118);
* the open-ended last interval needs no iterative solver: the reference
  fits lambda with scipy least_squares against ``ExpectedCoalTime(l, inf)``
  (psmc.py:120-147), but that expectation is exactly ``l`` when the horizon
  is infinite, so the fit has the closed form
  ``lambda = E[T_coal | T_coal > t0] - t0``.

Host-side pure Python/numpy; runs once per fit on tiny inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PiecewiseDemography:
    """A PSMC demography: piecewise-constant inverse coalescence rate.

    ``knots[k]`` is the start time of segment k (knots[0] == 0); segment k
    spans [knots[k], knots[k+1]) with constant scaled size ``sizes[k]``
    (the psmc RS lambda column; the hazard of pairwise coalescence on the
    segment is 1/sizes[k]).  ``group_len`` is the psmc ``MM pattern``
    expanded to per-group atomic-interval counts.
    """

    knots: np.ndarray
    sizes: np.ndarray
    group_len: np.ndarray
    theta: float
    rho: float
    em_round: int

    def with_theta(self, theta: float) -> "PiecewiseDemography":
        """Rescale times/sizes to a different theta (same diploid data)."""
        f = self.theta / theta
        return dataclasses.replace(
            self,
            knots=self.knots * f,
            sizes=self.sizes * f,
            rho=self.rho / f,
            theta=theta,
        )

    def group_starts(self) -> np.ndarray:
        """Start time of each pattern group (the collapsed discretisation)."""
        first = np.concatenate([[0], np.cumsum(self.group_len)[:-1]])
        return self.knots[first]

    # -- interval statistics -------------------------------------------------

    def _clipped(self, t1: float, t2: float):
        """Per-segment overlap [lo, hi] with the window [t1, t2]."""
        ends = np.append(self.knots[1:], np.inf)
        lo = np.clip(self.knots, t1, t2)
        hi = np.clip(ends, t1, t2)
        return lo, np.maximum(hi, lo)

    def harmonic_size(self, t1: float, t2: float) -> float:
        """Duration-weighted harmonic mean of the size over [t1, t2]."""
        lo, hi = self._clipped(t1, t2)
        dur = hi - lo
        return float(dur.sum() / (dur / self.sizes).sum())

    def tail_mean_coal_time(self, t0: float) -> float:
        """E[T_coal | T_coal > t0] under the piecewise-constant hazard."""
        lo, hi = self._clipped(t0, np.inf)
        r_lo = lo / self.sizes
        with np.errstate(over="ignore"):
            r_hi = hi / self.sizes
        open_end = ~np.isfinite(r_hi)
        # survival to each segment's (clipped) start, conditional on T > t0
        surv = np.exp(np.concatenate([[0.0], (r_lo - r_hi)[:-1]]).cumsum())
        # E[T 1{coal in segment} | survived to segment start], closed form of
        # int_lo^hi t h e^{-h (t-lo)} dt with h = 1/size
        upper = np.where(open_end, 0.0, (np.where(open_end, 0.0, r_hi) + 1.0)
                         * np.exp(r_lo - np.where(open_end, r_lo, r_hi)))
        seg_mean = self.sizes * ((r_lo + 1.0) - upper)
        p_coal = 1.0 - np.exp(-(np.where(open_end, np.inf, r_hi - r_lo)).sum())
        return float((surv * seg_mean).sum() / p_coal)

    def regrid_rates(self, grid) -> list:
        """One constant rate per merged interval (reference
        ReestimateCoalescentRates, psmc.py:156-163): harmonic averaging on
        bounded intervals, tail-expectation matching on the last, open one."""
        grid = np.asarray(grid, dtype=float)
        out = [self.harmonic_size(a, b) for a, b in zip(grid[:-1], grid[1:])]
        out.append(self.tail_mean_coal_time(grid[-1]) - grid[-1])
        return out


def _expand_pattern(spec: str) -> np.ndarray:
    """``"1*4+25*2"`` -> [4, 2, 2, ..., 2] (25 times)."""
    out: list = []
    for part in spec.split("+"):
        nums = [int(v) for v in part.split("*")]
        out.extend([nums[0]] if len(nums) == 1 else [nums[1]] * nums[0])
    return np.asarray(out, dtype=int)


def load_psmc_demography(path: str, em_round: int = -1) -> PiecewiseDemography:
    """Parse one psmc output file into a PiecewiseDemography.

    Single streaming pass: records every round's TR/RS block plus the MM
    pattern line, then keeps the requested round (last if ``em_round`` is -1
    or out of range).  Same record semantics as the reference parser
    (psmc.py:35-81) without the double read / cursor loops.
    """
    pattern = None
    rounds: dict = {}
    current = None
    with open(path) as fh:
        for raw in fh:
            parts = raw.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "MM" and len(parts) > 1 and parts[1].startswith("pattern"):
                pattern = _expand_pattern(parts[1][:-1].split(":")[1])
            elif tag == "RD":
                current = {"knots": [], "sizes": [], "theta": 0.0, "rho": 0.0}
                rounds[int(parts[1])] = current
            elif current is None:
                continue
            elif tag == "TR":
                current["theta"] = float(parts[1])
                current["rho"] = float(parts[2])
            elif tag == "RS":
                current["knots"].append(float(parts[2]))
                current["sizes"].append(float(parts[3]))
    if not rounds:
        raise ValueError(f"Corrupted or empty input file: {path}")
    if em_round == -1 or em_round not in rounds:
        em_round = max(rounds)
    rec = rounds[em_round]
    return PiecewiseDemography(
        knots=np.asarray(rec["knots"], dtype=float),
        sizes=np.asarray(rec["sizes"], dtype=float),
        group_len=pattern if pattern is not None else np.array([], dtype=int),
        theta=rec["theta"],
        rho=rec["rho"],
        em_round=em_round,
    )
