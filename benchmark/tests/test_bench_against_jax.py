"""The frozen reference against the JAX package (``misti_tpu``) itself.

The JAX package fitted both configurations' sweeps on the CPU in float64
(scripts/jax_f64_reference.py): `hanfre_ect`'s inputs and flags are its
north-star ECT sweep (scripts/sweep_ect_f64_cpu.npz), and
`pair3_2band_cpfit`'s are the 16-scenario matrix's ``pair3.mi2`` in cpfit
(scripts/matrix_f64_cpu.out), each 101 spectra x 8 split times.  The
reference's likelihood at the JAX package's parameters gives its llh, and
the reference's own fits from the configuration's start reach it.  The JAX
package's corrected likelihood takes 50-130 s to compile on XLA:CPU, so
those results are read from the committed files; its uncorrected
likelihood is called live, in a process of its own, so that JAX never
enters this one."""

import json
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.harness import layout
from benchmark.reference.fit import flags, run_job, templates
from benchmark.reference.likelihood import build_llh, multinomial_const
from benchmark.reference.readers import read_psmc
from benchmark.reference.spec import build_spec

ROOT = layout.ROOT
SPLITS = list(range(20, 28))
CELL = re.compile(r"scenario = (\S+) \tbs_id = (\d+) \tsplitT = (\S+) .*"
                  r"optim = \[(.*)\] \tllh = (\S+)")


def _matrix(name: str, n: int):
    """(params (8, 101, n), llh (8, 101)) of a matrix scenario's cells."""
    params, llh = np.full((8, 101, n), np.nan), np.full((8, 101), np.nan)
    with open(ROOT / "scripts" / "matrix_f64_cpu.out") as f:
        for line in f:
            m = CELL.match(line)
            if m and m.group(1) == name:
                si, row = int(float(m.group(3))) - SPLITS[0], int(m.group(2))
                params[si, row] = [float(v) for v in m.group(4).split(",")]
                llh[si, row] = float(m.group(5))
    assert not np.isnan(llh).any()
    return params, llh


@pytest.fixture(scope="module", params=["hanfre_ect", "pair3_2band_cpfit"])
def table(request):
    """(configuration, spectra (101, 7), params (8, 101, n), llh (8, 101)):
    the JAX package's float64 fits of the configuration's sweep."""
    config = layout.config(layout.benchmark(), request.param)
    if request.param == "hanfre_ect":
        z = np.load(ROOT / "scripts" / "sweep_ect_f64_cpu.npz")
        meta = json.loads(str(z["meta"]))
        assert "-mi 1 4 ST 3 1 -uf --maxiter 1000" in meta["command"]
        assert "--cpfit" not in meta["command"] and "--nosmooth" not in meta["command"]
        return config, z["data"], z["params"], z["llh"]
    from misti_tpu_torch.engine.bootstrap import make_bootstrap_data
    from misti_tpu_torch.io import jsfs

    # the matrix's spectra, as its sweep CLI draws them (seed 0)
    data = make_bootstrap_data(jsfs.read_jafs(config["paths"]["jsfs"]), 100, seed=0)
    return (config, data, *_matrix("pair3.mi2", 2))


def _reference_llh(config, split, data, params):
    times, lambdas, _ = read_psmc(config["paths"]["psmc1"], config["paths"]["psmc2"])
    mi, pu = templates(config, float(split))
    spec = build_spec(times, lambdas, [0.0, *data[0]], float(split), mi, pu, **flags(config))
    d = torch.as_tensor(np.asarray(data, float))
    return build_llh(spec)(torch.as_tensor(np.asarray(params, float)), d,
                           multinomial_const(d, spec.unfolded)).numpy()


@pytest.mark.parametrize("split", [20, 24, 27])
def test_the_llh_at_the_jax_packages_parameters_is_its_llh(table, split):
    config, data, params, llh = table
    rows = [0, 1, 50, 100]
    si = SPLITS.index(split)
    got = _reference_llh(config, split, data[rows], params[si, rows])
    np.testing.assert_allclose(got, llh[si, rows], rtol=0, atol=1e-8)


def test_the_fit_reaches_the_jax_packages(table):
    """Two cells at split 24 fitted from the configuration's start, as the
    judge fits them: the same llh as the JAX package's to within the
    judge's limit, 1e-6."""
    config, data, params, llh = table
    mix = layout.traffic("sweep")
    rows, si = [0, 1], SPLITS.index(24)
    job = dict(config=config, psmc=(config["paths"]["psmc1"], config["paths"]["psmc2"]),
               split=24.0, data=data[rows], x_at=params[si, rows], const="multinomial",
               tol=mix["tol"], maxiter=mix["maxiter"])
    res = run_job(job)
    assert res["converged"].all()
    np.testing.assert_allclose(res["llh"], llh[si, rows], rtol=0, atol=1e-6)
    np.testing.assert_allclose(res["llh_at"], llh[si, rows], rtol=0, atol=1e-8)


LIVE = """
import json, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
from misti_tpu.engine.likelihood import build_likelihood
from misti_tpu.engine.spec import build_spec
from misti_tpu.io import psmc
a = json.loads(sys.argv[2])
d = psmc.read_psmc(a["psmc1"], a["psmc2"])
spec = build_spec(d.times, d.lambdas, [0.0, *a["sfs"]], a["split"], a["mi"], [],
                  correct=False, cpfit=a["cpfit"], smooth=a["smooth"], unfolded=True)
llh = build_likelihood(spec).llh_batch(np.asarray(a["params"], float))
print(json.dumps([float(v) for v in np.asarray(llh)]))
"""


@pytest.mark.parametrize("name", ["hanfre_ect", "pair3_2band_cpfit"])
def test_the_uncorrected_llh_is_the_jax_packages_live(name):
    """The uncorrected likelihood (upstream's --trueEPS: every stage but the
    correction), the JAX package's called in a process of its own."""
    config = dict(layout.config(layout.benchmark(), name), trueEPS=True)
    from benchmark.harness.traffic import bootstrap_set, rng_of
    from benchmark.reference.readers import read_jafs_rows

    sfs = bootstrap_set(np.asarray(read_jafs_rows(config["paths"]["jsfs"]), float), 1,
                        rng_of(3, "live"))[1]
    mi, _ = templates(config, 23.0)
    n = len(mi)
    params = [[0.7] * n, [2.5] * n, [1e-4] * n, [0.05 * (k + 1) for k in range(n)]]
    args = dict(psmc1=config["paths"]["psmc1"], psmc2=config["paths"]["psmc2"],
                sfs=sfs.tolist(), split=23.0, mi=mi, cpfit=config["cpfit"],
                smooth=not config["nosmooth"], params=params)
    out = subprocess.run([sys.executable, "-c", LIVE, str(ROOT), json.dumps(args)],
                         capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-4000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])
    times, lambdas, _ = read_psmc(config["paths"]["psmc1"], config["paths"]["psmc2"])
    spec = build_spec(times, lambdas, [0.0, *sfs], 23.0, mi, [], **flags(config))
    got = build_llh(spec)(torch.tensor(params, dtype=torch.float64),
                          torch.as_tensor(np.tile(sfs, (len(params), 1))),
                          torch.full((len(params),), spec.llh_const, dtype=torch.float64))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-9)
