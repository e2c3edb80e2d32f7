"""One rank of the port's sharded-sweep test (tests/test_torch_dist.py).

Joins a gloo process group through misti_tpu_torch.dist.mesh.init_distributed,
then, on the CPU in float64:
  1. a sweep whose ranks were given different spectra (rank 1's shifted),
     which must raise on every rank;
  2. the fused sweep of `run_fused` with staged compaction;
  3. the per-split sweep (``fused=False``) of `run_per_split`;
and writes each result table and the stage lines it printed to ``out``.

Usage: python _torch_dist_worker.py <host:port> <world size> <rank> <out.npz>

Imports torch, numpy and the port only: `toy` is the 12-interval grid of
tests/test_sweep_fused.py ``_toy`` (the test checks that they agree).
"""

import contextlib
import io
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the model's own spectrum (split 5, one band at 0.4, x 12000), as in
# tests/test_torch_sweep.py: replicates near it converge at different steps
MODEL = np.array([3317.9, 571.4, 3298.2, 2083.7, 1071.3, 576.4, 1081.1])
SPLITS = [4, 7]
# stage 3 resumes 5 of the 10 cells, stage 4 one: fewer than the ranks, so
# all but rank 0 fit only padding there
STAGE_CAPS = (18, 22, 28)


def toy(numT=12):
    grid = 0.015 * (1.14 ** np.arange(numT)) - 0.015
    times = list(np.diff(grid))
    tt = np.cumsum([0.0] + times)
    lams = np.stack([1.0 + 0.3 * np.sin(tt * 11.0), 1.1 + 0.25 * np.cos(tt * 7.0)], axis=1)
    return times, [list(v) for v in lams]


def data(rows=5):
    """``rows`` spectra: 2 splits x 5 rows = 10 cells, no multiple of 3."""
    rng = np.random.default_rng(3)
    return np.stack([MODEL * rng.uniform(0.99, 1.01, size=7) for _ in range(rows)])


def _sweep(d, group, **kw):
    from misti_tpu_torch.engine import bootstrap

    times, lams = toy()
    return bootstrap.sweep(times, lams, d, SPLITS, [[1, 0, "ST", 0.25, 1]], (), tol=1e-4,
                           device="cpu", cpfit=True, smooth=False, unfolded=True, group=group,
                           **kw)


def run_fused(group=None):
    return _sweep(data(), group, stage_caps=STAGE_CAPS)


def run_per_split(group=None):
    return _sweep(data(), group, fused=False, maxiter=6)


def _table(res, prefix):
    return {f"{prefix}_{k}": np.asarray(getattr(res, k))
            for k in ("llh", "params", "nfev", "converged", "calls", "calls_sum")}


def main() -> int:
    coordinator, world, rank, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    from misti_tpu_torch.dist.mesh import init_distributed

    group = init_distributed(coordinator, world, rank)
    try:
        _sweep(data() + rank, group, maxiter=1)
        mismatch = "no error"
    except RuntimeError as e:
        mismatch = str(e)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        fused = run_fused(group)
    per_split = run_per_split(group)
    np.savez(out, mismatch=mismatch, stage_lines=err.getvalue(),
             **_table(fused, "fused"), **_table(per_split, "per_split"))
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
