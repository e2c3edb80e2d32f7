"""The reference's fits: the frozen Nelder-Mead over the frozen plain
per-split likelihood, on the CPU in float64.

`run_job` fits the rows of one split time from the configuration's start,
as upstream's MiSTI.py does one cell (``-bs row``, split ``st``), in
lockstep, and evaluates the likelihood once more at the parameters the
program returned for the same rows.  It reads the configuration's raw input
files itself and takes nothing that the program made; the spectra are the
benchmark's inputs, handed to both sides.  A job is a plain dict, so that a
process pool can run one job per split time.
"""

from __future__ import annotations

import numpy as np
import torch

from .likelihood import build_llh, multinomial_const
from .optimize import nelder_mead
from .readers import read_psmc
from .spec import build_spec


def templates(config: dict, split: float):
    """The configuration's migration bands and pulses at ``split``, with
    "ST" replaced by the split index, as upstream's test.bs scripts do."""
    st = int(split)
    mi = [[int(r[0]), st if r[1] == "ST" else int(r[1]), st if r[2] == "ST" else int(r[2]),
           float(r[3]), int(r[4])] for r in config["mi"]]
    pu = [[int(r[0]), st if r[1] == "ST" else int(r[1]), float(r[2]), int(r[3])]
          for r in config.get("pu", [])]
    return mi, pu


def flags(config: dict) -> dict:
    """The spec flags a configuration's command-line flags stand for."""
    return dict(correct=not config.get("trueEPS", False), cpfit=config["cpfit"],
                smooth=not config["nosmooth"], unfolded=config["unfolded"])


def run_job(job: dict) -> dict:
    """Fit ``job["data"]`` (R, 7) at ``job["split"]``; return the fits
    (``x`` (R, n), ``llh``, ``nfev``, ``converged``) and ``llh_at``, the
    llh at ``job["x_at"]`` (R, n).  ``job["const"]`` is "multinomial" (each
    lane's constant from its own spectrum, as a sweep takes it) or "spec"
    (the spec's, as a single fit takes it)."""
    torch.set_num_threads(job.get("threads", 1))
    config = job["config"]
    times, lambdas, _ = read_psmc(*job["psmc"])
    mi, pu = templates(config, job["split"])
    data = np.asarray(job["data"], float)
    specs = [build_spec(times, lambdas, [0.0, *row], job["split"], mi, pu, **flags(config))
             for row in (data if job["const"] == "spec" else data[:1])]
    llh = build_llh(specs[0])
    d = torch.as_tensor(data, dtype=torch.float64)
    if job["const"] == "spec":
        const = torch.tensor([sp.llh_const for sp in specs], dtype=torch.float64)
    else:
        const = multinomial_const(d, specs[0].unfolded)
    R, n = d.shape[0], specs[0].n_params

    def objective(points):
        W, P, _ = points.shape
        out = llh(points.reshape(W * P, n), d.repeat_interleave(P, 0),
                  const.repeat_interleave(P))
        return -out.reshape(W, P)

    x0 = torch.as_tensor(np.tile(specs[0].init_params, (R, 1)), dtype=torch.float64)
    res = nelder_mead(objective, x0, xatol=job["tol"], fatol=job["tol"],
                      maxiter=job["maxiter"])
    at = llh(torch.as_tensor(np.asarray(job["x_at"], float).reshape(R, n)), d, const)
    return dict(x=res.x.numpy(), llh=-res.fun.numpy(), nfev=res.nfev.numpy(),
                converged=res.converged.numpy(), llh_at=at.numpy())
