"""Static model specification for a MiSTI likelihood problem.

Host-side preprocessing that mirrors the reference MigrationInference
constructor (MigrationInference.py:41-199), SetModel (:229-289) and SetJAFS
(:202-227): fractional split-time interval splitting, migration-band / pulse
parameter registries with the same validation errors, and the multinomial
log-likelihood constant.  Everything data-dependent that the reference
branches on at runtime (pulse sites, sample date, smoothing segments) is
precomputed here into static arrays so the device code is branch-free.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
from scipy.special import gammaln

from ..spans import spanned


class ModelError(ValueError):
    """Raised for invalid model configuration (reference: PrintError + exit)."""


@dataclasses.dataclass
class ModelSpec:
    # grid
    numT: int
    splitT: int
    sample_date: int
    times: np.ndarray  # (numT-1,) interval lengths; last interval is infinite
    lh: np.ndarray  # (numT, 2) PSMC mixed coalescence rates

    # migration bands / pulses
    mi_base: np.ndarray  # (numT, 2) fixed migration rates
    pu_base: np.ndarray  # (numT, 2) fixed pulse rates
    opt_mi: list  # [(pop, start, end, init)] optimised bands
    opt_pu: list  # [(pop, time, init)] optimised pulses
    mi_masks: np.ndarray  # (n_opt_mi, numT, 2) region indicators
    pu_masks: np.ndarray  # (n_opt_pu, numT, 2)

    # data
    data_jafs: np.ndarray  # (7,)
    snps: float
    llh_const: float

    # flags
    correct: bool = True  # False == trueEPS
    cpfit: bool = False
    smooth: bool = False
    unfolded: bool = False
    mixture_th: float = 0.0
    thrh: tuple = (1.0, 1.0)

    # smoothing weight matrices (identity when smooth is False)
    smooth_w: np.ndarray | None = None  # (2, splitT, splitT)

    @property
    def n_params(self) -> int:
        return len(self.opt_mi) + len(self.opt_pu)

    @property
    def init_params(self) -> np.ndarray:
        return np.array(
            [m[3] for m in self.opt_mi] + [p[2] for p in self.opt_pu], dtype=float
        )


@spanned("spec.build")
def build_spec(
    times: Sequence[float],
    lambdas: Sequence[Sequence[float]],
    data_sfs8: Sequence[float],
    split_t: float,
    mi: Sequence[Sequence] = (),
    pu: Sequence[Sequence] = (),
    *,
    correct: bool = True,
    cpfit: bool = False,
    smooth: bool = False,
    unfolded: bool = False,
    sample_date: int = 0,
    mixture_th: float = 0.0,
    thrh: tuple = (1.0, 1.0),
) -> ModelSpec:
    """Build a static ModelSpec (mirrors MigrationInference.__init__ semantics)."""
    times = [float(v) for v in times]
    lh = [[float(a), float(b)] for a, b in lambdas]

    if split_t < sample_date:
        raise ModelError(
            "cannot initialise class with split time being more recent than sample date."
        )

    # fractional split time: split the containing interval
    # (MigrationInference.py:89-99)
    split_fraction = split_t % 1
    split_t = int(split_t)
    if split_t - 1 > len(times):
        raise ModelError("Invalid value for split time.")
    if split_fraction != 0.0:
        t1 = split_fraction * times[split_t]
        t2 = times[split_t] - t1
        times[split_t] = t1
        times.insert(split_t + 1, t2)
        lh.insert(split_t + 1, list(lh[split_t]))
        split_t += 1

    numT = len(lh)
    if len(times) != numT - 1:
        raise ModelError("Unexpected number of time intervals")
    if split_t > numT - 1:
        raise ModelError("Invalid value for split time (beyond the last interval).")

    # migration bands and pulse registries (SetModel, :229-289)
    mi_base = np.full((numT, 2), np.nan)
    pu_base = np.full((numT, 2), np.nan)
    opt_mi = []
    opt_pu = []
    for el in mi:
        pop = int(el[0]) - 1
        if pop not in (0, 1):
            raise ModelError("Population index should be 1 or 2.")
        start, end = int(el[1]), int(el[2])
        if start < sample_date:
            raise ModelError(
                f"Migration start ({start}) should be larger than or equal to "
                f"sample date ({sample_date})."
            )
        if end <= start:
            raise ModelError(
                f"Migration start ({start}) should be strictly less than "
                f"migration end ({end})."
            )
        val = float(el[3])
        for i in range(start, end):
            if not np.isnan(mi_base[i, pop]):
                raise ModelError("Migration rate intervals should not overlap.")
            mi_base[i, pop] = val
        if int(el[4]) == 1:
            opt_mi.append((pop, start, end, val))
    for el in pu:
        pop = int(el[0]) - 1
        if pop not in (0, 1):
            raise ModelError("Population index should be 1 or 2.")
        t = int(el[1])
        if t < sample_date:
            raise ModelError(
                f"Pulse migration time ({t}) should be larger than or equal to "
                f"sample date ({sample_date})."
            )
        val = float(el[2])
        if val < 0 or val > 1:
            raise ModelError("Pulse migration rate should be between 0 and 1.")
        if not (np.isnan(pu_base[t, 0]) and np.isnan(pu_base[t, 1])):
            raise ModelError(
                "Current version allows only single-direction pulse migration at a time."
            )
        pu_base[t, pop] = val
        if int(el[3]) == 1:
            opt_pu.append((pop, t, val))
    mi_base = np.nan_to_num(mi_base, nan=0.0)
    pu_base = np.nan_to_num(pu_base, nan=0.0)

    mi_masks = np.zeros((len(opt_mi), numT, 2))
    for k, (pop, start, end, _) in enumerate(opt_mi):
        mi_masks[k, start:end, pop] = 1.0
    pu_masks = np.zeros((len(opt_pu), numT, 2))
    for k, (pop, t, _) in enumerate(opt_pu):
        pu_masks[k, t, pop] = 1.0

    # data SFS and log-likelihood constant (SetJAFS, :202-227)
    data_sfs8 = np.asarray(data_sfs8, dtype=float)
    if data_sfs8.shape != (8,):
        raise ModelError("Unexpected data SFS.")
    data = data_sfs8[1:]
    snps = float(data.sum())
    if unfolded:
        llh_const = float(gammaln(snps + 1) - gammaln(data + 1).sum())
    else:
        llh_const = float(
            gammaln(snps + 1)
            - gammaln(data[0] + data[6] + 1)
            - gammaln(data[1] + data[5] + 1)
            - gammaln(data[2] + data[4] + 1)
            - gammaln(data[3] + 1)
        )

    spec = ModelSpec(
        numT=numT,
        splitT=split_t,
        sample_date=int(sample_date),
        times=np.asarray(times),
        lh=np.asarray(lh),
        mi_base=mi_base,
        pu_base=pu_base,
        opt_mi=opt_mi,
        opt_pu=opt_pu,
        mi_masks=mi_masks,
        pu_masks=pu_masks,
        data_jafs=data,
        snps=snps,
        llh_const=llh_const,
        correct=correct,
        cpfit=cpfit,
        smooth=smooth,
        unfolded=unfolded,
        mixture_th=mixture_th,
        thrh=tuple(thrh),
    )
    spec.smooth_w = _smooth_matrices(spec) if smooth else None
    return spec


def saturated_llh(spec: ModelSpec) -> float:
    """Saturated-model log-likelihood upper bound
    (reference MaximumLLHFunction, MigrationInference.py:696-711)."""
    data = spec.data_jafs
    jafs = data / data.sum()
    if spec.unfolded:
        with np.errstate(divide="ignore", invalid="ignore"):
            terms = np.where(data > 0, data * np.log(np.where(jafs > 0, jafs, 1.0)), 0.0)
        return spec.llh_const + float(terms.sum())
    pairs_d = [data[0] + data[6], data[1] + data[5], data[2] + data[4], data[3]]
    pairs_j = [jafs[0] + jafs[6], jafs[1] + jafs[5], jafs[2] + jafs[4], jafs[3]]
    return spec.llh_const + float(
        sum(d * np.log(j) for d, j in zip(pairs_d, pairs_j) if d > 0)
    )


def _smooth_matrices(spec: ModelSpec) -> np.ndarray:
    """Per-genome smoothing weight matrices (SmoothConst, :387-405).

    The reference averages corrected rates over runs of (1e-10-)equal PSMC
    rates, pre-split only.  lh is static, so the runs are static: smoothing
    becomes lc_pre[:, k] <- W[k] @ lc_pre[:, k] with W[k][i, j] =
    times[j] / sum(times[run(i)]) for j in run(i).
    """
    s = spec.splitT
    w = np.zeros((2, s, s))
    for ind in range(2):
        k = 0
        while k < s:
            lam = spec.lh[k, ind]
            j = k
            while j < spec.numT - 1 and abs(spec.lh[j, ind] - lam) < 1e-10:
                j += 1
                if j == s:
                    break
            j = min(j, s)
            if j == k:  # defensive; cannot happen since lh[k] == lam
                j = k + 1
            seg_t = spec.times[k:j].sum()
            for i in range(k, j):
                w[ind, i, k:j] = spec.times[k:j] / seg_t
            k = j
    return w


def params_from_jax(spec_jax) -> ModelSpec:
    """Copy a ``misti_tpu`` ModelSpec into this package's dataclass.

    The model has no weights: its state is the spec's tables.  The fields
    share names, so they are read as attributes and copied (arrays as
    fresh numpy arrays); nothing of the other package is imported.
    """
    out = {}
    for f in dataclasses.fields(ModelSpec):
        v = getattr(spec_jax, f.name)
        if isinstance(v, np.ndarray):
            v = np.array(v, copy=True)
        elif isinstance(v, list):
            v = [tuple(e) if isinstance(e, tuple) else e for e in v]
        out[f.name] = v
    return ModelSpec(**out)
