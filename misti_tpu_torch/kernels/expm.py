"""Batched matrix exponentials and their actions for small CTMCs (torch).

Only what the likelihood slice uses.  ``expm_action_pair`` is the spectrum
sweep's hot spot: (E p0, N1 p0) by Taylor sub-stepping against a static
stacked basis.  On the card it is one launch of the expm_action kernel per
call (kernels/expm_action.py); its plain version
``expm_action_pair_plain`` forms each lane's generator once from the
bases' nonzeros (`SparseBasis`) and multiplies each Taylor term by it over
those nonzeros, in the kernel's order.  Both give a lane a value that does
not depend on its batch.  ``expm``
and ``expm_m1`` are fixed-structure scaling-and-squaring Taylor-18
(Paterson-Stockmeyer) references for the tests.  All functions are
batch-first: matrices (..., n, n), vectors (B, n).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .expm_action import expm_action
from .row_matmul import row_matmul

_THETA_TAYLOR = 1.0  # scale so ||A||_1 <= 1: Taylor-18 truncation ~ 2e-16
_MAX_SQUARINGS = 30


def _squarings(a: torch.Tensor, max_squarings: int):
    """Per-matrix squaring count s and the scaled matrix a / 2^s."""
    norm = torch.linalg.matrix_norm(a, ord=1)
    s = torch.clamp(torch.ceil(torch.log2(norm / _THETA_TAYLOR)), min=0)
    s = torch.where(torch.isfinite(norm) & (norm > 0), s, torch.zeros_like(s))
    s = torch.clamp(s, max=max_squarings).to(torch.int64)
    scale = torch.exp2(-s.to(a.dtype))
    return s, a * scale[..., None, None]


def _powers(b: torch.Tensor):
    eye = torch.eye(b.shape[-1], dtype=b.dtype, device=b.device).expand_as(b)
    p = [eye, b]
    for _ in range(5):  # b^2 .. b^6
        p.append(p[-1] @ b)
    return p


def _horner(p, coeffs):
    """sum_k coeffs[k] b^k (k <= 18) in base b^6."""

    def blk(k0):
        out = coeffs[k0] * p[0]
        for j in range(1, 6):
            out = out + coeffs[k0 + j] * p[j]
        return out

    b6 = p[6]
    return blk(0) + b6 @ (blk(6) + b6 @ (blk(12) + coeffs[18] * b6))


def expm(a: torch.Tensor, max_squarings: int = _MAX_SQUARINGS) -> torch.Tensor:
    """Matrix exponential of (batched) square matrices."""
    s, b = _squarings(a, max_squarings)
    e = _horner(_powers(b), [1.0 / math.factorial(k) for k in range(19)])
    for i in range(int(s.max()) if s.numel() else 0):
        e = torch.where((i < s)[..., None, None], e @ e, e)
    return e


def expm_m1(a: torch.Tensor, max_squarings: int = _MAX_SQUARINGS) -> torch.Tensor:
    """Phi = e^A - I without cancellation: the series has no identity term
    and doubling is Phi(2h) = Phi^2 + 2 Phi."""
    s, b = _squarings(a, max_squarings)
    phi = _horner(_powers(b), [0.0] + [1.0 / math.factorial(k) for k in range(1, 19)])
    for i in range(int(s.max()) if s.numel() else 0):
        phi = torch.where((i < s)[..., None, None], phi @ phi + 2.0 * phi, phi)
    return phi


def substep_counts(coeffs: torch.Tensor, basis_norms, t, theta: float = 2.0,
                   max_substeps: int = 1024):
    """(m, overflow) of `expm_action_pair` for coeffs (..., c): the Taylor
    sub-step count per lane and the lanes past the cost cap (NaN too)."""
    t = torch.as_tensor(t, dtype=coeffs.dtype, device=coeffs.device)
    norms = torch.as_tensor(basis_norms, dtype=coeffs.dtype, device=coeffs.device)
    nb = (coeffs.abs() * norms).sum(-1) * t
    overflow = ~(nb <= theta * max_substeps)  # catches NaN coeffs too
    nb = torch.where(overflow, torch.zeros_like(nb), nb)
    m = torch.clamp(torch.ceil(nb / theta), min=1, max=max_substeps)
    return m, overflow


@dataclasses.dataclass(frozen=True)
class SparseBasis:
    """The nonzeros of a stacked basis kmat = [B_0^T | ... | B_{C-1}^T]
    (n, C*n), as the spectrum's kernel and its plain version read it.

    A lane's generator G = sum_c cs_c B_c has the union of the bases'
    nonzero patterns: ``nnz`` slots.  Output state j of a matvec
    ``term @ G^T`` sums ``term[src[j, l]] * G[slot[j, l]]`` over l = 0..L-1,
    its sources in increasing order, padded to L with ``src`` n (a zero
    entry of the term) and ``slot`` nnz (a zero slot of G), never with a
    live entry times weight 0: 0 * NaN would spread a NaN.  ``vals`` (C,
    nnz) holds each basis's value at each slot (kmat[i, c*n + j])."""

    src: torch.Tensor  # (n, L) int32
    slot: torch.Tensor  # (n, L) int32
    vals: torch.Tensor  # (C, nnz)

    @property
    def n(self) -> int:
        return self.src.shape[0]

    @property
    def L(self) -> int:
        return self.src.shape[1]

    @property
    def C(self) -> int:
        return self.vals.shape[0]

    @property
    def nnz(self) -> int:
        return self.vals.shape[1]

    def dense(self) -> torch.Tensor:
        """The stacked basis kmat (n, C*n) these nonzeros come from."""
        n, C = self.n, self.C
        live = self.slot.long() < self.nnz
        j = torch.arange(n, device=self.src.device)[:, None].expand(n, self.L)[live]
        i, sl = self.src.long()[live], self.slot.long()[live]
        k = torch.zeros((n, C, n), dtype=self.vals.dtype, device=self.vals.device)
        for c in range(C):
            k[i, c, j] = self.vals[c, sl]
        return k.reshape(n, C * n)


def sparse_basis(kmat: torch.Tensor, C: int) -> SparseBasis:
    """`SparseBasis` of the stacked basis ``kmat`` (n, C*n), on its device
    and in its dtype (built on the host: a constant of the basis)."""
    k = kmat.detach().cpu().numpy().reshape(kmat.shape[0], C, -1)  # (i, c, j)
    n = k.shape[0]
    cols = [np.flatnonzero((k[:, :, j] != 0).any(1)) for j in range(n)]
    L = max(len(c) for c in cols)
    nnz = sum(len(c) for c in cols)
    src = np.full((n, L), n, dtype=np.int32)
    slot = np.full((n, L), nnz, dtype=np.int32)
    vals = np.zeros((C, nnz))
    e = 0
    for j, col in enumerate(cols):
        src[j, :len(col)] = col
        slot[j, :len(col)] = np.arange(e, e + len(col))
        vals[:, e:e + len(col)] = k[col, :, j].T
        e += len(col)
    dev = kmat.device
    return SparseBasis(src=torch.as_tensor(src, device=dev), slot=torch.as_tensor(slot, device=dev),
                       vals=torch.as_tensor(vals, dtype=kmat.dtype, device=dev))


def lane_generator(basis: SparseBasis, cs: torch.Tensor) -> torch.Tensor:
    """Each lane's generator at its nonzeros, (B, n, L): G[slot[j, l]] with
    G = cs[:, 0] vals[0] + cs[:, 1] vals[1] + ..., one rounded product and
    one rounded add per term (the kernel's order), 0 at a pad."""
    vals = basis.vals.to(cs.dtype)
    g = cs[:, :1] * vals[0]
    for c in range(1, basis.C):
        g = g + cs[:, c:c + 1] * vals[c]
    g = torch.cat([g, g.new_zeros(g.shape[0], 1)], dim=-1)  # the pads' zero slot
    return g.index_select(-1, basis.slot.flatten()).view(-1, basis.n, basis.L)


def sparse_matvec(basis: SparseBasis, g: torch.Tensor, term: torch.Tensor) -> torch.Tensor:
    """out[:, j] = sum_l term[:, src[j, l]] * g[:, j, l], the products and the
    adds each rounded, l in order (no reduction whose order torch picks)."""
    ext = torch.cat([term, term.new_zeros(term.shape[0], 1)], dim=-1)  # the pads' zero entry
    prod = ext.index_select(-1, basis.src.flatten()).view_as(g) * g
    out = prod[..., 0]
    for l in range(1, basis.L):
        out = out + prod[..., l]
    return out


def expm_action_pair_plain(basis: SparseBasis, coeffs: torch.Tensor, basis_norms,
                           t, p0: torch.Tensor, theta: float = 2.0,
                           degree: int = 20, max_substeps: int = 1024,
                           jsfs: torch.Tensor | None = None,
                           catmask: torch.Tensor | None = None):
    """(E p0, N1 p0) for M = sum_c coeffs[:, c] * B_c without forming E or N1.

    ``basis`` is the `SparseBasis` of the stacked basis
    [B_0^T | ... | B_{c-1}^T] (n, c*n), ``coeffs`` (B, c), ``p0`` (B, n),
    ``t`` the interval length: a scalar or one per lane, (B,) (the grid
    sweep's per-lane tables).  A lane with t == 0 takes one sub-step of zero length and
    returns p0 and 0 (NaN where p0 is not finite).  Each lane covers the
    interval in m = ceil(||M t||_1 / theta) sub-steps of the
    degree-``degree`` series for (e^b, phi1(b)), b = M t / m.  The JAX
    version's per-lane while loop is a loop to max(m) here, each lane
    masked by j < m.  Past ``theta * max_substeps`` the lane is poisoned
    with NaN (the likelihood's positivity mask turns it into llh = -inf).

    Per lane the generator's nonzeros are formed once (`lane_generator`)
    and every Taylor term is a `sparse_matvec` with them.  With ``jsfs``
    (n, Q) it also returns N1 p0's projection ``row_matmul(N1 p0, jsfs)``,
    times ``catmask`` when given: (E p0, N1 p0, projection).
    """
    m, overflow = substep_counts(coeffs, basis_norms, t, theta, max_substeps)
    n_loop = int(m.max()) if m.numel() else 0
    h = torch.as_tensor(t, dtype=p0.dtype, device=p0.device) / m  # (B,)
    cs = coeffs * h[..., None]  # scaled rates: ||b||_1 <= theta
    g = lane_generator(basis, cs)

    p = p0
    acc = torch.zeros_like(p0)
    for j in range(n_loop):
        term, ev, pv = p, p, p
        for k in range(1, degree + 1):
            term = sparse_matvec(basis, g, term) / k
            ev = ev + term
            pv = pv + term / (k + 1)
        live = (j < m)[..., None]
        p = torch.where(live, ev, p)
        acc = torch.where(live, acc + h[..., None] * pv, acc)
    bad = torch.full((), float("nan"), dtype=p0.dtype, device=p0.device)
    ov = overflow[..., None]
    p, acc = torch.where(ov, bad, p), torch.where(ov, bad, acc)
    if jsfs is None:
        return p, acc
    proj = row_matmul(acc, jsfs)
    return p, acc, proj if catmask is None else proj * catmask


def expm_action_pair(basis: SparseBasis, coeffs: torch.Tensor, basis_norms,
                     t, p0: torch.Tensor, theta: float = 2.0,
                     degree: int = 20, max_substeps: int = 1024,
                     jsfs: torch.Tensor | None = None,
                     catmask: torch.Tensor | None = None):
    """`expm_action_pair_plain` on the CPU; on a CUDA tensor one launch of
    the expm_action kernel (kernels/expm_action.py), which computes each
    lane's sub-step count on the card, or raises.  ``basis`` is a
    `SparseBasis` (its tables on p0's device).  Returns (E p0, N1 p0), and
    with ``jsfs`` also the projection."""
    if p0.device.type == "cpu":
        return expm_action_pair_plain(basis, coeffs, basis_norms, t, p0, theta, degree,
                                      max_substeps, jsfs=jsfs, catmask=catmask)
    out = expm_action(basis, coeffs, basis_norms, t, p0, theta=theta, degree=degree,
                      max_substeps=max_substeps, jsfs=jsfs, catmask=catmask)
    return out if jsfs is not None else out[:2]
