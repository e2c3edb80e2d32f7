"""Bootstrap x split-time sweep: upstream's test.bs workflow on one device.

The reference's benchmark suite (test.bs/*.sh) runs 101 bootstrap
replicates x 8-10 split times x one Nelder-Mead fit each as independent
processes.  Here one `sweep()` call fits the whole (split x replicate) grid
as one lockstep Nelder-Mead (engine/optimize.py) over the fused sweep's
batched likelihood (engine/sweep_fused.py), whose pre-split correction is the
hand-written CUDA kernel on the card.  The confidence interval
(bs_conf_int.ipynb cells 2-3) is a few lines of numpy.

The sweep runs on one device per process (``device``/``dtype``; default
CUDA, raising without a card).  Given a ``torch.distributed`` group, each
stage's cells are split by rows over its ranks and the result tables are
all-gathered (dist/mesh.py), so every rank holds the whole table and takes
the same compaction decisions.
"""

from __future__ import annotations

import dataclasses
import random
import sys
import time
import zlib
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import resolve_device, resolve_dtype
from ..dist.mesh import all_gather_rows, pad_to_multiple, rank, row_block, world_size
from ..io.data import Jafs
from ..io.jsfs import bootstrap_jafs
from .likelihood import build_likelihood
from .optimize import NMState, nelder_mead
from .spec import build_spec
from .sweep_fused import build_fused_sweep


@dataclasses.dataclass
class SweepResult:
    split_times: np.ndarray  # (S,)
    params: np.ndarray  # (S, B, n) fitted parameters
    llh: np.ndarray  # (S, B) fitted log-likelihoods
    data: np.ndarray  # (B, 7) per-replicate spectra (row 0 = full data)
    nfev: np.ndarray = None  # (S, B) likelihood evaluations per cell
    converged: np.ndarray = None  # (S, B) Nelder-Mead convergence flags
    calls: int = 0  # batched objective calls (one per Nelder-Mead step) of the busiest rank
    calls_sum: int = 0  # batched objective calls of all ranks together
    shape_key: str = ""  # the fused sweep's `FusedSweep.shape_key` ("" per split)


def make_bootstrap_data(jafs: Jafs, n_replicates: int, seed: int = 0) -> np.ndarray:
    """(B+1, 7): row 0 is the summed spectrum, rows 1..B are resamples
    (the utils/generateJSFS_bs.py convention)."""
    rows = [jafs.summed()[1:]]
    rng = random.Random(seed)
    for _ in range(n_replicates):
        rows.append(np.asarray(bootstrap_jafs(jafs, rng=rng)[1:], float))
    return np.stack(rows)


def _lane_objective(llh, st_idx, data, calls):
    """Nelder-Mead objective over trial points (W, P, n) of W cells: -llh of
    every point in one batched call, each point with its cell's split index
    and data row."""

    def f(points):
        W, P, n = points.shape
        calls[0] += 1
        out = llh(st_idx.repeat_interleave(P), points.reshape(W * P, n),
                  data.repeat_interleave(P, dim=0))
        return -out.reshape(W, P)

    return f


def _rank_calls(calls: int, group) -> tuple:
    """(max, sum) over the ranks of each rank's objective calls."""
    per = all_gather_rows(torch.tensor([calls]), group, world_size(group))
    return int(per.max()), int(per.sum())


def _check_same_data(data: np.ndarray, group) -> None:
    """Every rank must fit the same replicate spectra (each draws them from
    the same seed): raise on every rank if a checksum differs."""
    crc = zlib.crc32(np.ascontiguousarray(data, dtype=np.float64).tobytes())
    got = all_gather_rows(torch.tensor([crc], dtype=torch.int64), group, world_size(group))
    if (got != got[0]).any():
        raise RuntimeError(f"ranks hold different replicate spectra (crc32 {got.tolist()})")


def sweep(
    times: Sequence[float],
    lambdas,
    data: np.ndarray,  # (B, 7) replicate spectra
    split_times: Sequence[float],
    mi_template,  # e.g. [[1, 4, "ST", 0.3, 1]] -- "ST" replaced by split index
    pu_template=(),
    *,
    tol: float = 1e-4,
    device=None,
    dtype=None,
    sample_date: int = 0,
    fused: bool = True,
    stage_caps: Sequence[int] = (16, 32, 64, 128, 256),
    maxiter: int = 1000,
    phase1_maxiter: Optional[int] = None,
    group=None,
    **spec_flags,
) -> SweepResult:
    """Fit every (replicate, split time) cell.

    ``mi_template``/``pu_template`` rows may use the string "ST" to mean the
    split index, as the test.bs scripts do with their shell variable.

    ``fused=True`` (default) evaluates the whole (split x replicate) grid as
    one lockstep Nelder-Mead, with the split time a per-lane index;
    fractional split times are supported.  ``fused=False`` fits each split
    time through its own `build_likelihood` (the validation path).

    ``stage_caps``/``maxiter`` tune the fused path's straggler
    compaction (see `_sweep_fused`); ``phase1_maxiter`` is the single-stage
    schedule ``(phase1_maxiter,)``.  ``device`` defaults to CUDA and raises
    without a card; ``dtype`` (the parameters' and the simplex's) to float64.

    ``group`` (a ``torch.distributed`` process group, dist/mesh.py) splits the
    cells over its ranks; every rank must call with the same arguments and
    gets the same result.  None fits every cell in this process.
    """
    dev = resolve_device(device)
    dt = resolve_dtype(dev, dtype)
    data = np.asarray(data, float)
    b = data.shape[0]
    if group is not None:
        _check_same_data(data, group)

    if fused:
        return _sweep_fused(times, lambdas, data, [float(v) for v in split_times],
                            mi_template, pu_template, tol=tol, device=dev, dtype=dt,
                            sample_date=sample_date, stage_caps=stage_caps,
                            maxiter=maxiter, phase1_maxiter=phase1_maxiter,
                            group=group, **spec_flags)

    world, me = world_size(group), rank(group)
    all_params, all_llh, all_nfev, all_conv = [], [], [], []
    calls = [0]
    for st in split_times:
        mi = [[int(r[0]), int(r[1]), int(st) if r[2] == "ST" else int(r[2]),
               float(r[3]), int(r[4])] for r in mi_template]
        pu = [[int(r[0]), int(r[1]), float(r[2]), int(r[3])] for r in pu_template]
        spec = build_spec(
            list(times), lambdas, [0.0, *data[0]], st, mi, pu,
            sample_date=sample_date, **spec_flags,
        )
        lik = build_likelihood(spec, device=dev, dtype=dt)
        d, _ = pad_to_multiple(torch.as_tensor(data, dtype=dt, device=dev), world, fill=1.0)
        x0, _ = pad_to_multiple(
            torch.as_tensor(np.tile(spec.init_params, (b, 1)), dtype=dt, device=dev), world)
        mine = row_block(d.shape[0], world, me)
        st_idx = torch.zeros(d[mine].shape[0], dtype=torch.int64, device=dev)
        obj = _lane_objective(lambda _, p, dd: lik.llh_data(p, dd), st_idx, d[mine], calls)
        res = nelder_mead(obj, x0[mine], xatol=tol, fatol=tol, maxiter=maxiter)
        gather = lambda t: all_gather_rows(t, group, b).cpu().numpy()
        all_params.append(gather(res.x))
        all_llh.append(-gather(res.fun))
        all_nfev.append(gather(res.nfev))
        all_conv.append(gather(res.converged))

    calls_max, calls_sum = _rank_calls(calls[0], group)
    return SweepResult(
        split_times=np.asarray(list(split_times), float),
        params=np.stack(all_params), llh=np.stack(all_llh), data=data,
        nfev=np.stack(all_nfev), converged=np.stack(all_conv), calls=calls_max,
        calls_sum=calls_sum,
    )


def _sweep_fused(times, lambdas, data, splits, mi_template, pu_template, *,
                 tol, device, dtype, sample_date, stage_caps=(16, 32, 64, 128, 256),
                 maxiter=1000, phase1_maxiter=None, group=None, **spec_flags):
    """The fused grid sweep with multi-stage straggler compaction.

    Lockstep fits pay for the slowest lane every iteration: a few
    non-convergent cells (a rate running to the boundary at a wrong split
    time) reach maxiter while the median cell converges in ~21 iterations.
    So every cell first gets ``stage_caps[0]`` iterations at full width;
    after each stage the unconverged cells are compacted into one batch of
    exactly their lanes and resumed from their exact NMState to the next
    cap, until the last stage runs the stragglers to ``maxiter``.  Nelder-Mead
    is Markov in (simplex, fsim, it), so the staged trajectory is the
    uninterrupted run's, as long as a lane's objective value does not depend
    on the batch it is evaluated in.

    With a ``group``, each stage's cells are padded to a multiple of the
    world size (the first stage as the JAX package pads: data rows of 1.0,
    zero starts and split index 0; later stages with copies of their first
    cell), every rank fits its row block, and the results and NMState are
    all-gathered in the run's dtype, so every rank computes the same next
    stage.  Stage lines go to stderr from rank 0 only.
    """
    fs = build_fused_sweep(times, lambdas, splits, mi_template, pu_template,
                           sample_date=sample_date, device=device, dtype=dtype,
                           **spec_flags)
    dev, dt = fs.device, fs.dtype
    b = data.shape[0]
    n_cells = len(splits) * b
    world, me = world_size(group), rank(group)

    if phase1_maxiter is not None:
        stage_caps = (int(phase1_maxiter),)
    caps = sorted({int(c) for c in stage_caps if 0 < int(c) < maxiter})
    caps.append(int(maxiter))

    st_idx = torch.arange(len(splits), device=dev).repeat_interleave(b)
    cell_data = torch.as_tensor(np.tile(data, (len(splits), 1)), dtype=dt, device=dev)
    x0 = torch.as_tensor(np.tile(fs.init_params, (n_cells, 1)), dtype=dt, device=dev)
    calls = [0]

    t0 = time.perf_counter()
    sp, _ = pad_to_multiple(st_idx, world)
    dp, _ = pad_to_multiple(cell_data, world, fill=1.0)
    xp, _ = pad_to_multiple(x0, world)
    mine = row_block(sp.shape[0], world, me)
    res, state = nelder_mead(_lane_objective(fs.llh, sp[mine], dp[mine], calls), xp[mine],
                             xatol=tol, fatol=tol, maxiter=caps[0], with_state=True)
    gather = lambda t: all_gather_rows(t, group, n_cells).clone()
    x, fun, nfev, conv = (gather(t) for t in (res.x, res.fun, res.nfev, res.converged))
    sim, fsim, it, nfev_s = (gather(t) for t in state[:4])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if me == 0:
        print(f"# sweep stage 1/{len(caps)}: {n_cells} cells to cap {caps[0]}, "
              f"{time.perf_counter() - t0:.1f} s, unconverged {int((~conv).sum())}",
              file=sys.stderr)

    if fs.n_params and len(caps) > 1:
        for si, cap in enumerate(caps[1:], start=2):
            todo = torch.nonzero(~conv).flatten()
            if todo.numel() == 0:
                break
            t0 = time.perf_counter()
            idx, m = pad_to_multiple(todo, world, fill=int(todo[0]))
            sel = idx[row_block(idx.numel(), world, me)]
            st0 = NMState(sim=sim[sel], fsim=fsim[sel], it=it[sel], nfev=nfev_s[sel],
                          aux_sum=torch.zeros((sel.numel(), 0), dtype=dt, device=dev))
            r2, s2 = nelder_mead(
                _lane_objective(fs.llh, st_idx[sel], cell_data[sel], calls), x0[sel],
                xatol=tol, fatol=tol, maxiter=cap, state0=st0, with_state=True)
            gather = lambda t: all_gather_rows(t, group, m)
            x[todo], fun[todo], nfev[todo] = gather(r2.x), gather(r2.fun), gather(r2.nfev)
            conv[todo] = gather(r2.converged)
            sim[todo], fsim[todo] = gather(s2.sim), gather(s2.fsim)
            it[todo], nfev_s[todo] = gather(s2.it), gather(s2.nfev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            if me == 0:
                print(f"# sweep stage {si}/{len(caps)}: {todo.numel()} cells "
                      f"resumed to cap {cap}, "
                      f"{time.perf_counter() - t0:.1f} s, "
                      f"unconverged {int((~conv).sum())}", file=sys.stderr)

    calls_max, calls_sum = _rank_calls(calls[0], group)
    S = len(splits)
    return SweepResult(
        split_times=np.asarray(splits, float),
        params=x.cpu().numpy().reshape(S, b, -1),
        llh=-fun.cpu().numpy().reshape(S, b),
        data=data,
        nfev=nfev.cpu().numpy().reshape(S, b),
        converged=conv.cpu().numpy().reshape(S, b),
        calls=calls_max,
        calls_sum=calls_sum,
        shape_key=fs.shape_key,
    )


def sweep_many(
    scenarios: Sequence[dict],
    *,
    tol: float = 1e-4,
    device=None,
    dtype=None,
    stage_caps: Sequence[int] = (16, 32, 64, 128, 256),
    maxiter: int = 1000,
    group=None,
) -> dict:
    """Run a matrix of sweep scenarios in one process (or one process group).

    The reference's benchmark suite is 16 shell scripts (4 genome pairs x 4
    migration scenarios, test.bs/), each paying its own process start.  Here
    scenarios run one after another.  Scenarios whose grid shapes and static
    flags match share a `SweepResult.shape_key` (the JAX package compiles
    one program for each key; the port runs eagerly and has none to share).

    Each ``scenarios`` entry is a dict:
      name: str
      times, lambdas: the merged PSMC grid (io/psmc.py read_psmc output)
      data: (B, 7) replicate spectra (make_bootstrap_data)
      splits: sequence of split times
      mi_template / pu_template: as in `sweep` ("ST" placeholders allowed)
      sample_date: int (default 0)
      any further keys are spec flags (cpfit, smooth, unfolded, correct...)

    ``group`` shards each scenario's cells over its ranks, as in `sweep`.
    Returns {name: SweepResult}.
    """
    results = {}
    for sc in scenarios:
        sc = dict(sc)
        name = sc.pop("name")
        results[name] = sweep(
            sc.pop("times"), sc.pop("lambdas"), np.asarray(sc.pop("data"), float),
            sc.pop("splits"), sc.pop("mi_template", ()), sc.pop("pu_template", ()),
            tol=tol, device=device, dtype=dtype, sample_date=int(sc.pop("sample_date", 0)),
            stage_caps=stage_caps, maxiter=maxiter, group=group, **sc,
        )
    return results


def split_time_confidence_interval(
    result: SweepResult, times: Sequence[float], scale_time: float = 1.0,
    level: float = 0.975,
):
    """Argmax-llh split time per replicate -> Student-t CI in generations
    (the bs_conf_int.ipynb computation)."""
    from scipy import stats

    best = result.llh.argmax(axis=0)  # (B,) index into split_times
    st_idx = result.split_times[best]
    cum = np.concatenate([[0.0], np.cumsum(np.asarray(times, float))])
    gens = np.array([cum[int(np.ceil(s))] for s in st_idx]) * scale_time
    mean = gens.mean()
    se = gens.std(ddof=1) / np.sqrt(len(gens)) if len(gens) > 1 else 0.0
    tcrit = stats.t.ppf(level, df=max(len(gens) - 1, 1))
    return {
        "best_split_idx": st_idx,
        "split_gens": gens,
        "mean": mean,
        "ci": (mean - tcrit * se, mean + tcrit * se),
        "level": level,
    }
