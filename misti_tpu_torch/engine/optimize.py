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

``solve`` is the single fit on top of it (B = 1): the scipy disp-style
summary, the Report() counters and the host basin-hopping loop.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
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


def _fused_mul_add(c: float, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """c * x + t rounded once, as a fused multiply-add rounds it, for a
    constant ``c`` of at most a few significant bits.

    XLA:CPU contracts the JAX package's expansion and outer-contraction
    vertices (3 xbar - 2 x_n, 1.5 xbar - 0.5 x_n) into fused multiply-adds;
    two roundings put those points an ulp away, which flips the trial
    value between finite and +inf where the simplex meets the x >= 0
    boundary, and the two fits then part.  Here the product is split exactly
    (Dekker: c * x = p + e) and the sums are compensated (Knuth's TwoSum:
    p + t = s + r), so s + (r + e) is the once-rounded value unless
    r + e itself rounds at a tie of s's last place."""
    p = c * x
    big = 134217729.0 if x.dtype == torch.float64 else 4097.0  # 2^ceil(m/2) + 1
    g = big * x
    xh = g - (g - x)
    e = (xh * c - p) + (x - xh) * c
    s = p + t
    tv = s - p
    r = (p - (s - tv)) + (t - tv)
    return s + (r + e)


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
        xe = _fused_mul_add(1 + _RHO * _CHI, xbar, -_RHO * _CHI * worst)
        xc = _fused_mul_add(1 + _PSI * _RHO, xbar, -_PSI * _RHO * worst)
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


class SolveResult:
    """Fit result that unpacks like the reference's ``[params, llh]`` pair
    and carries the run's Report() counters (MigrationInference.py:36-38,
    735-739)."""

    def __init__(self, x, llh, nit=0, nfev=0, corr_called=0, corr_failed=0):
        self.x = np.asarray(x)
        self.llh = float(llh)
        self.nit = int(nit)
        self.nfev = int(nfev)
        self.corr_called = int(corr_called)
        self.corr_failed = int(corr_failed)

    def __iter__(self):
        return iter((self.x, self.llh))

    def __getitem__(self, i):
        return (self.x, self.llh)[i]

    def __len__(self):
        return 2

    def __repr__(self):
        # print(sol) renders as the reference's [params, llh] list (MiSTI.py:215)
        return repr([self.x, self.llh])


def solve(lik, tol: float = 1e-4, global_opt: bool = False, seed: int = 0,
          trace: bool = False, n_hops: int = 100) -> SolveResult:
    """Reference ``Solve`` (MigrationInference.py:718-733): maximise the llh.

    One lockstep `nelder_mead` lane over ``lik.llh_flags_batch``: each
    iteration's n+5 trial points are one objective call, and the Report()
    counters (``nfev``, ``corr_called``, ``corr_failed``) are summed over
    every evaluated point.  With no optimised parameters it evaluates once.
    ``global_opt`` runs basin-hopping on the host around the fit (T = 0.5,
    scipy's AdaptiveStepsize schedule, ``np.random.default_rng(seed)``), like
    the reference's scipy.optimize.basinhopping call.  ``trace`` prints every
    evaluated point as ``<p> <-llh>`` (MigrationInference.py:713-716), on the
    CPU only: a per-point host print would serialize a fit on the card.
    """
    spec = lik.spec
    trace = trace and lik.device.type == "cpu"
    if spec.n_params == 0:
        llh, flags = lik.llh_flags(np.zeros(0))
        return SolveResult(np.zeros(0), float(llh), nfev=1,
                           corr_called=int(flags[0]), corr_failed=int(flags[1]))

    def obj(points):
        B, P, n = points.shape
        flat = points.reshape(B * P, n)
        llh, flags = lik.llh_flags_batch(flat)
        if trace:
            for p, f in zip(flat.cpu().numpy(), (-llh).cpu().numpy()):
                print(p, f)
        return -llh.reshape(B, P), flags.reshape(B, P, 2)

    def nm(x0):
        x0 = torch.as_tensor(np.asarray(x0, float), dtype=lik.dtype, device=lik.device)
        return nelder_mead(obj, x0[None], xatol=tol, fatol=tol, naux=2)

    def record(x, f, res_list):
        return SolveResult(
            x, -f,
            nit=sum(int(r.nit[0]) for r in res_list),
            nfev=sum(int(r.nfev[0]) for r in res_list),
            corr_called=sum(int(r.aux_sum[0, 0]) for r in res_list),
            corr_failed=sum(int(r.aux_sum[0, 1]) for r in res_list),
        )

    if not global_opt:
        res = nm(spec.init_params)
        # scipy disp-style summary (the reference passes disp=True)
        if bool(res.converged[0]):
            print("Optimization terminated successfully.")
        else:
            print("Maximum number of iterations has been exceeded.")
        print(f"         Current function value: {float(res.fun[0]):f}")
        print(f"         Iterations: {int(res.nit[0])}")
        print(f"         Function evaluations: {int(res.nfev[0])}")
        return record(res.x[0].cpu().numpy(), float(res.fun[0]), [res])

    # basin-hopping: random displacement + Metropolis accept at T=0.5, with
    # scipy's AdaptiveStepsize schedule (interval=50, factor=0.9, target
    # accept rate 0.5)
    rng = np.random.default_rng(seed)
    temp = 0.5
    stepsize = 0.5
    interval, factor, target_accept = 50, 0.9, 0.5
    naccept = 0
    res = nm(spec.init_params)
    all_res = [res]
    best_x, best_f = res.x[0].cpu().numpy(), float(res.fun[0])
    cur_x, cur_f = best_x, best_f
    for step in range(1, n_hops + 1):
        if step % interval == 0:
            stepsize = (stepsize / factor if naccept / step > target_accept
                        else stepsize * factor)
        trial = cur_x + rng.uniform(-stepsize, stepsize, size=cur_x.shape)
        r = nm(trial)
        all_res.append(r)
        fx = float(r.fun[0])
        if fx < best_f:
            best_x, best_f = r.x[0].cpu().numpy(), fx
        if fx <= cur_f or rng.random() < np.exp(-(fx - cur_f) / temp):
            cur_x, cur_f = r.x[0].cpu().numpy(), fx
            naccept += 1
    return record(best_x, best_f, all_res)


def solve_batch(lik, x0_batch, tol: float = 1e-4) -> NMResult:
    """Fits of one likelihood from B starting points in lockstep.

    ``lik`` is an engine.likelihood.Likelihood; ``x0_batch`` (B, n)."""
    x0 = torch.as_tensor(x0_batch).to(device=lik.device, dtype=lik.dtype)

    def obj(points):
        B, P, n = points.shape
        return -lik.llh_batch(points.reshape(B * P, n)).reshape(B, P)

    return nelder_mead(obj, x0, xatol=tol, fatol=tol)
