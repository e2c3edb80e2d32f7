"""Whether what the timed path produced is correct: a sample of its answers
against the reference's own fits of the same cells.

The sample is drawn from the seed among the answers the window finished
(``judge_rows`` bootstrap rows of the sweeps, or ``judge_fits`` fits), and
also holds the ``judge_longest`` answers that took the most likelihood
evaluations: a sweep's stragglers, which the narrow compaction stages
served.  A sweep's sample is whole replicates (every split time of a
bootstrap row), so that each one's argmax split time can be read too.  The reference
(`benchmark.reference.fit.run_job`) fits every sampled cell from the
configuration's start with the frozen Nelder-Mead over the frozen plain
likelihood, on the CPU in float64, one split time per process, and also
evaluates its likelihood at the parameters the program returned.

Numbers compared, each against its limit in ``limits/<cell>.json``:

* ``llh_gap``: the widest gap between a cell's llh and the reference fit's;
* ``x_llh_gap``: the widest gap between the reference's likelihood at a
  cell's parameters and the reference fit's llh (the parameters, judged by
  what they are worth).

Read beside them and not compared (PERF.md says why): ``x_gap``, the widest
gap between a parameter and the reference's, which sound fits read up to
the optimiser's own tolerance; ``llh_at_x_gap``, the widest gap between a
cell's llh and the reference's likelihood at its parameters; and, in a
sweep, ``argmax_diff``, the sampled replicates whose argmax split time
differs from the reference's.
"""

from __future__ import annotations

import multiprocessing
import os

import numpy as np

from benchmark.harness.traffic import rng_of
from benchmark.reference.fit import run_job


def _gap(a, b) -> float:
    """The widest |a - b|, with equal infinities 0 and a NaN infinite."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    d = np.where(a == b, 0.0, np.abs(a - b))
    return float(np.max(np.where(np.isnan(d), np.inf, d))) if d.size else 0.0


def _job(config, mix, split, data, x_at, const):
    return dict(config=config, psmc=(config["paths"]["psmc1"], config["paths"]["psmc2"]),
                split=split, data=np.asarray(data, float), x_at=np.asarray(x_at, float),
                const=const, tol=mix["tol"], maxiter=mix["maxiter"])


def sample(n_done: int, per: int, nfev_of, k: int, longest: int, rng) -> list:
    """``k`` of ``n_done * per`` answers drawn without replacement, and the
    ``longest`` with the most evaluations (``nfev_of(i)``, i in
    range(n_done * per)), the first of equals first."""
    total = n_done * per
    picks = [int(i) for i in rng.choice(total, size=min(k, total), replace=False)]
    most = sorted(range(total), key=lambda i: -nfev_of(i))[:longest]
    return sorted(set(picks) | set(most))


def sweep_jobs(config, mix, done, seed):
    """(jobs, sampled (sweep, row) pairs) for the sweeps in ``done``."""
    R = done[0]["llh"].shape[1]
    pairs = [divmod(i, R) for i in sample(
        len(done), R, lambda i: int(done[i // R]["nfev"][:, i % R].max()),
        mix["judge_rows"], mix["judge_longest"], rng_of(seed, "judge"))]
    jobs = []
    for si, split in enumerate(np.arange(config["splits"][0], config["splits"][1] + 1)):
        data = [done[k]["spectra"][r] for k, r in pairs]
        x_at = [done[k]["params"][si, r] for k, r in pairs]
        jobs.append(_job(config, mix, float(split), data, x_at, "multinomial"))
    return jobs, pairs


def fit_jobs(config, mix, done, spectra, seed):
    """(jobs, sampled fit indices grouped as the jobs are)."""
    picks = sample(len(done), 1, lambda i: done[i]["nfev"], mix["judge_fits"],
                   mix["judge_longest"], rng_of(seed, "judge"))
    by_split = {}
    for i in picks:
        by_split.setdefault(done[i]["split"], []).append(i)
    jobs, groups = [], []
    for split, idx in sorted(by_split.items()):
        jobs.append(_job(config, mix, split, [spectra[done[i]["row"]] for i in idx],
                         [done[i]["x"] for i in idx], "spec"))
        groups.append(idx)
    return jobs, groups


def run_jobs(jobs: list, workers: int | None = None) -> list:
    """The reference's results, one process per job (``workers`` 0: in this
    process); every process is joined before this returns."""
    if workers is None:
        workers = min(len(jobs), len(os.sched_getaffinity(0)))
    if workers == 0:
        return [run_job(j) for j in jobs]
    pool = multiprocessing.get_context("spawn").Pool(workers)
    try:
        return pool.map(run_job, jobs)
    finally:
        pool.close()
        pool.join()


def sweep_numbers(done, pairs, results) -> dict:
    port_llh = np.array([[done[k]["llh"][si, r] for k, r in pairs]
                         for si in range(len(results))])  # (S, P)
    port_x = np.array([[done[k]["params"][si, r] for k, r in pairs]
                       for si in range(len(results))])  # (S, P, n)
    ref_llh = np.stack([res["llh"] for res in results])
    ref_x = np.stack([res["x"] for res in results])
    ref_at = np.stack([res["llh_at"] for res in results])
    return dict(llh_gap=_gap(port_llh, ref_llh), x_llh_gap=_gap(ref_at, ref_llh),
                x_gap=_gap(port_x, ref_x), llh_at_x_gap=_gap(port_llh, ref_at),
                argmax_diff=int((port_llh.argmax(0) != ref_llh.argmax(0)).sum()))


def fit_numbers(done, groups, results) -> dict:
    port_llh = np.concatenate([[done[i]["llh"] for i in idx] for idx in groups])
    port_x = np.concatenate([[done[i]["x"] for i in idx] for idx in groups])
    ref_llh = np.concatenate([res["llh"] for res in results])
    ref_x = np.concatenate([res["x"] for res in results])
    ref_at = np.concatenate([res["llh_at"] for res in results])
    return dict(llh_gap=_gap(port_llh, ref_llh), x_llh_gap=_gap(ref_at, ref_llh),
                x_gap=_gap(port_x, ref_x), llh_at_x_gap=_gap(port_llh, ref_at))


def verdict(numbers: dict, limits: dict) -> tuple:
    """(every number that has a limit within it, {name: {"value", "limit"}}
    of those, {name: value} of the others)."""
    compared = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items() if k in limits}
    read = {k: v for k, v in numbers.items() if k not in limits}
    return all(c["value"] <= c["limit"] for c in compared.values()), compared, read
