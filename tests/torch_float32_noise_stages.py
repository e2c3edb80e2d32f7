"""Which stage carries the port's float32 llh noise: one stage at a time in float64.

    python tests/torch_float32_noise_stages.py [SPLIT:ROW ...] [--points N] [--half W]

For each (split time, bootstrap row) cell of the north-star ECT command
(tests/fixtures/sweep*.psmc + sweep.jsfs, ``-mi 1 4 ST 3 1 -uf``, bootstrap
seed 0, smoothing on; default: the two cells that never converged in
float32 on the card, 27:13 and 26:27), on the CPU, port only:

* the float64 optimum x* of the cell (a float64 Nelder-Mead to 1e-9);
* a scan of N rates (default 401) over x* +- W (default 0.02: rates 1e-4
  apart), evaluated as one batch in float64 and, per configuration, in
  float32 with one stage promoted to float64 (its inputs cast up, its
  outputs cast back down):
  ``correct`` (the plain correction sweep), ``post_split_fit``,
  ``smooth_rates``, ``last_rate``, ``series`` (the spectrum's per-interval
  series, `expm_action_pair`), ``interval_sum`` (the spectrum's sum over
  intervals, cast down once at its end), ``llh_dtype`` (the llh returned
  in float64 instead of cast to float32), and ``all`` of them;
* per configuration, the noise of d = llh32 - llh64 over the scan: its
  spread (max - min) and its largest step between neighbouring rates, and
  the largest neighbouring step of llh32 itself.

The float32 sweep of these configurations computes in float32 throughout
(config.LLH_DTYPE set to float32 while it is built), as the likelihood did
before it computed in float64; configuration ``LLH_DTYPE`` is the float32
run as it is now (float32 parameters, a float64 likelihood).

Prints one JSON object per cell.  ~1-3 minutes per cell.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from misti_tpu_torch.engine import bootstrap, likelihood, sweep_fused  # noqa: E402
from misti_tpu_torch.engine.optimize import nelder_mead  # noqa: E402
from misti_tpu_torch.engine.sweep_fused import build_fused_sweep  # noqa: E402
from misti_tpu_torch.io import jsfs as io_jsfs  # noqa: E402
from misti_tpu_torch.io import psmc as io_psmc  # noqa: E402

SPLITS = [float(v) for v in range(20, 28)]
MI = [["1", "4", "ST", "3", "1"]]
FLAGS = dict(cpfit=False, smooth=True, unfolded=True)
CELLS = ("27:13", "26:27")


_BASES = {}


def _cast(x, dt):
    if torch.is_tensor(x) and x.is_floating_point():
        return x.to(dt)
    if isinstance(x, likelihood.SpectrumBasis):
        dev = x.k2.device
        if (dev, dt) not in _BASES:
            _BASES[dev, dt] = likelihood.SpectrumBasis(dev, dt)
        return _BASES[dev, dt]
    if isinstance(x, (list, tuple)):
        return type(x)(_cast(v, dt) for v in x)
    return x


def promoted(fn, down=True):
    """``fn`` run in float64: float tensor arguments cast up; with ``down``
    its float outputs cast back to float32."""

    def run(*args, **kw):
        out = fn(*_cast(args, torch.float64), **{k: _cast(v, torch.float64)
                                                   for k, v in kw.items()})
        return _cast(out, torch.float32) if down else out

    return run


def llh_in_float64(jafs_raw, data, llh_const, unfolded):
    """`multinomial_llh` of the float32 spectrum with its llh left in float64."""
    llh, jafs, pos = likelihood.multinomial_llh(jafs_raw.double(), data, llh_const, unfolded)
    return llh, jafs.to(jafs_raw.dtype), pos


# stage -> [(module, attribute, replacement factory)], in pipeline order
STAGES = {
    "correct": [(sweep_fused, "fused_correction", promoted)],
    "post_split_fit": [(sweep_fused, "post_split_fit", promoted)],
    "smooth_rates": [(sweep_fused, "smooth_rates", promoted)],
    "last_rate": [(sweep_fused, "last_rate", promoted)],
    "series": [(likelihood, "expm_action_pair", promoted)],
    # the interval terms summed in float64, the spectrum cast down once
    "interval_sum": [(likelihood, "_sum_in_order", lambda f: promoted(f, down=False)),
                     (sweep_fused, "jafs_spectrum", lambda f: lambda *a, **k: f(*a, **k).float())],
    "spectrum": [(sweep_fused, "jafs_spectrum", promoted)],
    "llh_dtype": [(sweep_fused, "multinomial_llh", lambda f: llh_in_float64)],
}
# the stages of the pipeline in order, each a promoted sweep_fused function
PIPELINE = ("correct", "post_split_fit", "last_rate", "smooth_rates", "spectrum", "llh_dtype")


def tail_from(stage):
    """Patches that run ``stage`` and every later stage of PIPELINE in
    float64 with nothing cast back down: float32 up to ``stage``'s input."""
    out = []
    for name in PIPELINE[PIPELINE.index(stage):]:
        for mod, attr, make in STAGES[name]:
            out.append((mod, attr, make if name == "llh_dtype"
                        else lambda f: promoted(f, down=False)))
    return out


class Promote:
    """Context: the named stages (of STAGES) patched to run in float64."""

    def __init__(self, names):
        self.patches = [p for n in names for p in
                        (tail_from(n[5:]) if n.startswith("from:") else STAGES[n])]

    def __enter__(self):
        self.saved = []
        for mod, attr, make in self.patches:
            orig = getattr(mod, attr)
            self.saved.append((mod, attr, orig))
            setattr(mod, attr, make(orig))

    def __exit__(self, *exc):
        for mod, attr, orig in reversed(self.saved):
            setattr(mod, attr, orig)


def _build(inp, dt, llh_dtype, **kw):
    saved = likelihood.LLH_DTYPE, sweep_fused.LLH_DTYPE
    likelihood.LLH_DTYPE = sweep_fused.LLH_DTYPE = llh_dtype
    try:
        return build_fused_sweep(inp.times, inp.lambdas, SPLITS, MI, device="cpu", dtype=dt, **kw)
    finally:
        likelihood.LLH_DTYPE, sweep_fused.LLH_DTYPE = saved


def load():
    fix = os.path.join(REPO, "tests", "fixtures")
    inp = io_psmc.read_psmc(os.path.join(fix, "sweep1.psmc"), os.path.join(fix, "sweep2.psmc"),
                            0, -1)
    data = bootstrap.make_bootstrap_data(io_jsfs.read_jafs(os.path.join(fix, "sweep.jsfs")),
                                         100, seed=0)
    kw = dict(sample_date=inp.sample_date_discr, **FLAGS)
    fs = {dt: _build(inp, dt, dt, **kw) for dt in (torch.float32, torch.float64)}
    fs["LLH_DTYPE"] = _build(inp, torch.float32, likelihood.LLH_DTYPE, **kw)
    return fs, data


def cell_llh(fs, si, d):
    """xs (N,) -> llh (N,) of one cell as one batch, in float64 numpy."""

    def f(xs):
        xs = np.asarray(xs, float).reshape(-1, 1)
        n = len(xs)
        return fs.llh(np.full(n, si), xs, np.tile(d, (n, 1))).double().numpy()

    return f


def optimum64(fs64, si, d, x0):
    """The cell's float64 optimum by a float64 Nelder-Mead to 1e-9."""
    f = cell_llh(fs64, si, d)

    def obj(points):
        return -torch.as_tensor(f(points.reshape(-1, 1).numpy())).reshape(points.shape[:2])

    res = nelder_mead(obj, torch.tensor([x0], dtype=torch.float64), xatol=1e-9, fatol=1e-9)
    return float(res.x[0, 0]), float(-res.fun[0])


def noise(l32, l64):
    d = l32 - l64
    return {"spread": float(d.max() - d.min()), "max_step_d": float(np.abs(np.diff(d)).max()),
            "max_step_llh32": float(np.abs(np.diff(l32)).max()),
            "mean_d": float(d.mean())}


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("cells", nargs="*", default=list(CELLS))
    ap.add_argument("--points", type=int, default=401)
    ap.add_argument("--half", type=float, default=0.02)
    ap.add_argument("--configs", default=",".join(
        ["none", *STAGES, "all", *(f"from:{n}" for n in PIPELINE),
         "correct+from:post_split_fit", "LLH_DTYPE"]))
    a = ap.parse_args(argv)
    fs, data = load()
    x0 = float(fs[torch.float64].init_params[0])
    for c in a.cells:
        split, row = c.split(":")
        si, d = SPLITS.index(float(split)), data[int(row)]
        xopt, lopt = optimum64(fs[torch.float64], si, d, x0)
        xs = np.linspace(xopt - a.half, xopt + a.half, a.points)
        l64 = cell_llh(fs[torch.float64], si, d)(xs)
        out = {"split": float(split), "row": int(row), "x_opt64": xopt, "llh_opt64": lopt,
               "scan": [float(xs[0]), float(xs[-1]), a.points], "stages": {}}
        for name in a.configs.split(","):
            if name == "LLH_DTYPE":
                l32 = cell_llh(fs[name], si, d)(xs)
                out["stages"][name] = noise(l32, l64)
                continue
            names = ([] if name == "none" else [n for n in STAGES if n != "spectrum"]
                     if name == "all" else name.split("+"))
            with Promote(names):
                l32 = cell_llh(fs[torch.float32], si, d)(xs)
            out["stages"][name] = noise(l32, l64)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
