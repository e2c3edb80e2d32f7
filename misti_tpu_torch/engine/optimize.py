"""Lockstep Nelder-Mead with scipy's update rules, batch-first in torch.

The reference fits 1-4 migration/pulse parameters with
``scipy.optimize.minimize(method='Nelder-Mead', xatol=fatol=tol,
maxiter=1000)`` (MigrationInference.py:718-731).  Here B fits run in
lockstep: every lane keeps its own (n+1, n) simplex, and each iteration
evaluates all lanes' n+5 trial points (reflection, expansion, the two
contractions and the n+1 shrink candidates) in ONE objective call, so a
simplex step of the whole batch is one batched likelihood evaluation.  The
iteration loop runs on the host and reads one flag per iteration: whether any
lane is still live.  Lanes that have converged or reached ``maxiter`` are
frozen bitwise and their counters stand still, so a lockstep fit equals B
standalone fits.

Infinite objectives (llh = -inf failures) are ordinary large values, as in
scipy; convergence also needs a finite best vertex.

``solve`` (single fit, scipy-style summary, basin-hopping) is not here yet:
it belongs with the single-fit CLI.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

_RHO = 1.0  # reflection
_CHI = 2.0  # expansion
_PSI = 0.5  # contraction
_SIGMA = 0.5  # shrink
_NONZDELT = 0.05
_ZDELT = 0.00025


class NMResult(NamedTuple):
    x: torch.Tensor  # (B, n) best vertex
    fun: torch.Tensor  # (B,) best objective
    nit: torch.Tensor  # (B,) iterations used, scipy's count (1 + simplex updates)
    converged: torch.Tensor  # (B,) bool
    nfev: torch.Tensor  # (B,) objective evaluations
    aux_sum: torch.Tensor  # (B, naux) per-evaluation aux counters, summed


class NMState(NamedTuple):
    """Resumable state: Nelder-Mead is Markov in (simplex, values, iteration
    count), so a fit paused at ``maxiter`` and resumed from this state follows
    the trajectory of an uninterrupted run (the sweep's straggler
    compaction relies on it)."""

    sim: torch.Tensor  # (B, n+1, n)
    fsim: torch.Tensor  # (B, n+1)
    it: torch.Tensor  # (B,) int64
    nfev: torch.Tensor  # (B,) int64
    aux_sum: torch.Tensor  # (B, naux)


def _initial_simplex(x0: torch.Tensor) -> torch.Tensor:
    """scipy's start: x0 and n vertices with coordinate i scaled by 1.05
    (or set to 0.00025 where it is 0).  (B, n) -> (B, n+1, n)."""
    n = x0.shape[-1]
    pert = torch.where(x0 != 0.0, x0 * (1.0 + _NONZDELT), torch.full_like(x0, _ZDELT))
    eye = torch.eye(n, dtype=torch.bool, device=x0.device)
    rows = torch.where(eye, pert[:, None, :], x0[:, None, :])
    return torch.cat([x0[:, None, :], rows], dim=1)


def _order(sim, fsim):
    """Sort each lane's vertices by value.  Stable, as jnp.argsort is: ties
    (+inf at every failed evaluation) keep their order."""
    idx = torch.argsort(fsim, dim=-1, stable=True)
    return torch.take_along_dim(sim, idx[..., None], dim=1), torch.take_along_dim(fsim, idx, dim=1)


def _converged(sim, fsim, xatol, fatol):
    xconv = (sim[:, 1:] - sim[:, :1]).abs().amax(dim=(1, 2)) <= xatol
    # inf - inf = nan compares False: not converged, like scipy
    fconv = (fsim[:, :1] - fsim[:, 1:]).abs().amax(dim=1) <= fatol
    return xconv & fconv & torch.isfinite(fsim[:, 0])


def _sel(mask, a, b):
    """where over the lane axis for (B,) masks and (B, ...) values."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def nelder_mead(
    fun: Callable,
    x0: torch.Tensor,
    xatol: float = 1e-4,
    fatol: float = 1e-4,
    maxiter: int = 1000,
    naux: int = 0,
    state0: NMState | None = None,
    with_state: bool = False,
):
    """Minimise B problems in lockstep with scipy-compatible Nelder-Mead.

    ``fun`` maps trial points (B, P, n) to values (B, P): lane b's points
    belong to problem b.  With ``naux > 0`` it returns (values (B, P), aux
    (B, P, naux)), and the aux vectors of every evaluated point are summed
    into ``aux_sum`` (the reference's per-evaluation correction counters).

    ``x0`` (B, n) sets the starting simplexes and the dtype and device of the
    state; ``state0`` resumes an earlier run instead (``x0`` is then unused).
    ``with_state=True`` returns (NMResult, NMState).
    """
    x0 = torch.as_tensor(x0)
    if x0.dim() == 1:
        x0 = x0[None]
    B, n = x0.shape

    def call(points):
        out = fun(points)
        if naux:
            return out
        return out, torch.zeros(points.shape[:2] + (0,), dtype=points.dtype,
                                device=points.device)

    if n == 0 and state0 is None:
        f, aux = call(x0[:, None, :])
        one = torch.ones(B, dtype=torch.int64, device=x0.device)
        res = NMResult(x=x0, fun=f[:, 0], nit=one - 1, converged=torch.ones_like(one, dtype=torch.bool),
                       nfev=one, aux_sum=aux[:, 0])
        if with_state:
            return res, NMState(sim=x0[:, None, :], fsim=f, it=one - 1, nfev=one,
                                aux_sum=aux[:, 0])
        return res

    if state0 is None:
        sim = _initial_simplex(x0)
        fsim, aux0 = call(sim)
        aux_sum = aux0.sum(dim=1)
        it = torch.zeros(B, dtype=torch.int64, device=x0.device)
        nfev = torch.full((B,), n + 1, dtype=torch.int64, device=x0.device)
    else:
        sim, fsim = state0.sim, state0.fsim
        aux_sum, it, nfev = state0.aux_sum, state0.it, state0.nfev
        n = sim.shape[-1]
    sim, fsim = _order(sim, fsim)

    while True:
        live = ~_converged(sim, fsim, xatol, fatol) & (it < maxiter)
        if not bool(live.any()):  # the one host read of an iteration
            break
        best, worst = sim[:, 0], sim[:, -1]
        xbar = sim[:, :-1].sum(dim=1) / n
        xr = (1 + _RHO) * xbar - _RHO * worst
        xe = (1 + _RHO * _CHI) * xbar - _RHO * _CHI * worst
        xc = (1 + _PSI * _RHO) * xbar - _PSI * _RHO * worst
        xcc = (1 - _PSI) * xbar + _PSI * worst
        shrunk = best[:, None] + _SIGMA * (sim - best[:, None])
        points = torch.cat([torch.stack([xr, xe, xc, xcc], dim=1), shrunk], dim=1)
        fall, auxall = call(points)  # one objective call for all n+5 points
        nfev = nfev + torch.where(live, points.shape[1], 0)
        aux_sum = aux_sum + _sel(live, auxall.sum(dim=1), torch.zeros_like(aux_sum))
        fxr, fxe, fxc, fxcc = fall[:, 0], fall[:, 1], fall[:, 2], fall[:, 3]
        f0, f_2, f_1 = fsim[:, 0], fsim[:, -2], fsim[:, -1]

        # scipy's _minimize_neldermead decision tree, as selections
        take_xe = (fxr < f0) & (fxe < fxr)
        take_xr = ((fxr < f0) & ~(fxe < fxr)) | ((fxr >= f0) & (fxr < f_2))
        inside = (fxr >= f0) & (fxr >= f_2)
        take_xc = inside & (fxr < f_1) & (fxc <= fxr)
        take_xcc = inside & (fxr >= f_1) & (fxcc < f_1)
        doshrink = inside & (((fxr < f_1) & ~(fxc <= fxr))
                             | ((fxr >= f_1) & ~(fxcc < f_1)))

        new_last = _sel(take_xe, xe, _sel(take_xr, xr, _sel(take_xc, xc,
                                                             _sel(take_xcc, xcc, worst))))
        new_flast = torch.where(take_xe, fxe, torch.where(take_xr, fxr, torch.where(
            take_xc, fxc, torch.where(take_xcc, fxcc, f_1))))
        sim1 = torch.cat([sim[:, :-1], new_last[:, None]], dim=1)
        fsim1 = torch.cat([fsim[:, :-1], new_flast[:, None]], dim=1)
        # shrink step, selected where needed
        shrunk_sim = torch.cat([best[:, None], shrunk[:, 1:]], dim=1)
        shrunk_f = torch.cat([f0[:, None], fall[:, 5:]], dim=1)
        sim1 = _sel(doshrink, shrunk_sim, sim1)
        fsim1 = _sel(doshrink, shrunk_f, fsim1)

        sim1, fsim1 = _order(sim1, fsim1)
        sim = _sel(live, sim1, sim)
        fsim = _sel(live, fsim1, fsim)
        it = it + live.to(it.dtype)

    res = NMResult(x=sim[:, 0], fun=fsim[:, 0], nit=it + 1,
                   converged=_converged(sim, fsim, xatol, fatol), nfev=nfev,
                   aux_sum=aux_sum)
    if with_state:
        return res, NMState(sim=sim, fsim=fsim, it=it, nfev=nfev, aux_sum=aux_sum)
    return res


def solve_batch(lik, x0_batch, tol: float = 1e-4) -> NMResult:
    """Fits of one likelihood from B starting points in lockstep.

    ``lik`` is an engine.likelihood.Likelihood; ``x0_batch`` (B, n)."""
    x0 = torch.as_tensor(x0_batch).to(device=lik.device, dtype=lik.dtype)

    def obj(points):
        B, P, n = points.shape
        return -lik.llh_batch(points.reshape(B * P, n)).reshape(B, P)

    return nelder_mead(obj, x0, xatol=tol, fatol=tol)
