"""Work meters of the spectrum's per-interval action (E p0, N1 p0).

One interval of the spectrum, for every lane, is kernels/expm.py
`expm_action_pair_plain`; the spectrum kernel (kernels/spectrum.py) runs
the same series for every interval in one launch.  These meters count the
work one interval needs on its inputs (each lane's own sub-step count):

* `expm_action_ops`: arithmetic operations;
* `expm_action_bytes`: bytes each input read once and each output written
  once.
"""

from __future__ import annotations

import torch

from .expm import DEGREE, MAX_SUBSTEPS, THETA, substep_counts


def expm_action_ops(basis, coeffs: torch.Tensor, basis_norms, t, *, theta: float = THETA,
                    degree: int = DEGREE, max_substeps: int = MAX_SUBSTEPS, Q: int = 0) -> float:
    """Arithmetic operations one interval needs on these inputs
    (`expm_action_pair_plain`'s arguments, ``basis`` a `SparseBasis`), from
    each lane's own sub-step count: per lane that runs the series, the
    step's scaled rates (C) and the generator sum_c cs_c B_c from the bases'
    nonzeros (a multiply-add each); per sub-step and term a matvec with that
    generator over its nonzeros, the term's scale, the two sums and the pv
    term's scale (4 n); per sub-step the acc update (2 n).  A lane with
    t == 0 (p0 and 0) or past the cap (NaN) needs no series.  Every lane:
    the projection (2 n Q + Q).  The matvec runs over each state's nonzeros
    padded to the longest column (n L products: 220 against 196 at k2), and
    each generator entry is formed from all C bases (2 C - 1 operations)."""
    m, overflow = substep_counts(coeffs, basis_norms, t, theta, max_substeps)
    tt = torch.as_tensor(t, dtype=coeffs.dtype, device=coeffs.device).reshape(-1)
    series = ~overflow & (tt != 0)
    n, C = basis.n, basis.C
    nnz_bases = int(torch.count_nonzero(basis.vals))
    steps = float(m[series].double().sum())
    per_step = degree * (2 * basis.nnz + 4 * n) + 2 * n
    per_lane = C + 2 * nnz_bases
    return (steps * per_step + int(series.sum()) * per_lane
            + int(m.numel()) * (2 * n * Q + Q))


def expm_action_bytes(B: int, basis, *, itemsize: int, per_lane_t: bool, Q: int = 0,
                      per_lane_catmask: bool = False) -> int:
    """Bytes one interval must move: each input read once, each output
    written once; the basis as its `SparseBasis` tables."""
    n, C = basis.n, basis.C
    tables = 2 * n * basis.L * basis.src.element_size()  # src, slot
    words = (C * basis.nnz + B * C + C + (B if per_lane_t else 1) + B * n  # vals .. p0
             + n * Q + (B * Q if per_lane_catmask else Q if Q else 0)  # jsfs, catmask
             + 2 * B * n + B * Q)  # E p0, N1 p0, projection
    return tables + words * itemsize
