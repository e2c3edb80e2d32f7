"""Float32 ECT fits of the north-star sweep: the JAX package against the port.

    python tests/torch_sweep_float32_witness.py SPLIT:ROW[:X] ...

For each (split time, bootstrap row) cell of the north-star command
(tests/fixtures/sweep*.psmc + sweep.jsfs, ``-mi 1 4 ST 3 1 -uf``, bootstrap
seed 0, ECT, smoothing on), on the CPU:

* the JAX package's fused sweep in float32 (x64 off, the fused-xla
  correction: the CPU form of the TPU kernel) and the port's sweep in
  float32, both from the spec's start, over the grid of the cells' splits
  and rows;
* the float64 llh, through the port (equal to the JAX package's float64
  llh: tests/test_torch_sweep.py), of each fit, of the JAX table's fit
  (scripts/sweep_ect_r05.npz, TPU float32) and of ``X`` (a fit from
  elsewhere, e.g. a card's run: chip_smoke.py prints its worst cells);
* a scan of 401 rates between the smallest and the largest of those fits
  (5% beyond each, not below 0):
  the float32 llh of both packages and the float64 llh, with the largest
  step between neighbouring rates of each;
* on both sides of the port's largest float32 step, the post-split
  interval whose fitted rate differs most between float32 and float64.

The port's float32 run has computed its likelihood in float64 since the
float32 llh's noise was found above the optimiser's fatol
(tests/torch_float32_noise_stages.py rebuilds the all-float32 pipeline).

Prints one JSON object per cell.  Runs in ~2-4 minutes on a few CPU cores.
"""

from __future__ import annotations

import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["MISTI_CORRECTION"] = "fused-xla"
os.environ.pop("JAX_ENABLE_X64", None)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

import numpy as np  # noqa: E402
import torch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from misti_tpu.engine import bootstrap as jax_bootstrap  # noqa: E402
from misti_tpu.engine.sweep_fused import build_fused_sweep as jax_build_fused_sweep  # noqa: E402
from misti_tpu_torch.engine import bootstrap  # noqa: E402
from misti_tpu_torch.engine import sweep_fused  # noqa: E402
from misti_tpu_torch.engine.sweep_fused import build_fused_sweep  # noqa: E402
from misti_tpu_torch.io import jsfs as io_jsfs  # noqa: E402
from misti_tpu_torch.io import psmc as io_psmc  # noqa: E402

SPLITS = [float(v) for v in range(20, 28)]
MI = [["1", "4", "ST", "3", "1"]]
TABLE = os.path.join(REPO, "scripts", "sweep_ect_r05.npz")
FLAGS = dict(cpfit=False, smooth=True, unfolded=True)


def main(argv) -> int:
    cells = [a.split(":") for a in argv]
    if not cells:
        print(__doc__, file=sys.stderr)
        return 2
    fix = os.path.join(REPO, "tests", "fixtures")
    inp = io_psmc.read_psmc(os.path.join(fix, "sweep1.psmc"), os.path.join(fix, "sweep2.psmc"),
                            0, -1)
    data = bootstrap.make_bootstrap_data(io_jsfs.read_jafs(os.path.join(fix, "sweep.jsfs")),
                                         100, seed=0)
    ref = np.load(TABLE)
    assert np.array_equal(data, ref["data"])
    kw = dict(sample_date=inp.sample_date_discr, **FLAGS)

    splits = sorted({float(c[0]) for c in cells})
    rows = sorted({int(c[1]) for c in cells})
    grid = dict(times=inp.times, lambdas=inp.lambdas, data=data[rows], split_times=splits,
                mi_template=MI)
    rj = jax_bootstrap.sweep(*grid.values(), tol=1e-4, stage_caps=(5000,), **kw)
    rt = bootstrap.sweep(*grid.values(), tol=1e-4, device="cpu", dtype=torch.float32,
                         stage_caps=(5000,), **kw)

    fs64 = build_fused_sweep(inp.times, inp.lambdas, SPLITS, MI, device="cpu",
                             dtype=torch.float64, **kw)
    fs32 = build_fused_sweep(inp.times, inp.lambdas, SPLITS, MI, device="cpu",
                             dtype=torch.float32, **kw)
    fj = jax_build_fused_sweep(inp.times, inp.lambdas, SPLITS, MI, **kw)
    jax_llh = jax.jit(jax.vmap(fj.llh))

    def evaluate(si, row, xs):
        """(float64, port float32, JAX float32) llh of rates ``xs`` at a cell
        (padded to 512 points: one JAX compile)."""
        n = len(xs)
        xs = np.concatenate([xs, np.full(512 - n, xs[-1])]).reshape(-1, 1)
        st = np.full(len(xs), si)
        d = np.tile(data[row], (len(xs), 1))
        out = (fs64.llh(st, xs, d).numpy(), fs32.llh(st, xs, d).numpy().astype(float),
               np.asarray(jax_llh(st.astype(np.int32), xs.astype(np.float32),
                                  d.astype(np.float32)), float))
        return tuple(v[:n] for v in out)

    post = {}
    post_split_fit = sweep_fused.post_split_fit

    def recording(*a, **k):
        out = post_split_fit(*a, **k)
        post["lc"] = out[0]
        return out

    def post_split_rates(si, row, xs):
        """Each package dtype's post-split rates (len(xs), n_post, 2) at ``xs``."""
        sweep_fused.post_split_fit = recording
        try:
            out = []
            for fs in (fs32, fs64):
                fs.llh(np.full(len(xs), si), np.reshape(xs, (-1, 1)),
                       np.tile(data[row], (len(xs), 1)))
                out.append(post["lc"].double().numpy())
            return out
        finally:
            sweep_fused.post_split_fit = post_split_fit

    for c in cells:
        split, row = float(c[0]), int(c[1])
        si, gi, ri = SPLITS.index(split), splits.index(split), rows.index(row)
        fits = {"table": float(ref["params"][si, row, 0]),
                "jax_f32": float(rj.params[gi, ri, 0]),
                "port_f32_cpu": float(rt.params[gi, ri, 0])}
        if len(c) > 2:
            fits["given"] = float(c[2])
        f64, p32, j32 = evaluate(si, row, np.array(list(fits.values())))
        out = {"split": split, "row": row, "start": float(fs64.init_params[0]),
               "table_llh_f32": float(ref["llh"][si, row]),
               "jax_f32_llh": float(rj.llh[gi, ri]), "port_f32_llh": float(rt.llh[gi, ri]),
               "fits": {k: {"x": x, "llh_f64": float(a), "llh_port_f32": float(b),
                            "llh_jax_f32": float(g)}
                        for (k, x), a, b, g in zip(fits.items(), f64, p32, j32)}}
        lo, hi = min(fits.values()), max(fits.values())
        xs = np.linspace(max(lo - 0.05 * (hi - lo), 0.0), hi + 0.05 * (hi - lo), 401)
        scan = dict(zip(("f64", "port_f32", "jax_f32"), evaluate(si, row, xs)))
        out["scan"] = {"from": float(xs[0]), "to": float(xs[-1]), "points": len(xs)}
        for k, v in scan.items():
            step = np.abs(np.diff(v))
            i = int(np.nanargmax(step))
            out["scan"][k] = {"max_step": float(step[i]), "at_x": float(xs[i]),
                              "argmax_x": float(xs[int(np.nanargmax(v))]),
                              "max_llh": float(np.nanmax(v))}
        i = int(np.argmin(np.abs(xs - out["scan"]["port_f32"]["at_x"])))
        r32, r64 = post_split_rates(si, row, xs[i:i + 2])
        rel = np.abs(r32 - r64) / np.abs(r64)
        out["post_split_at_the_step"] = [
            {"x": float(xs[i + k]), "interval": int(j), "rate_f32": float(r32[k, j, 0]),
             "rate_f64": float(r64[k, j, 0]), "rel": float(rel[k, j].max())}
            for k in range(2) for j in [int(rel[k].max(-1).argmax())]]
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
