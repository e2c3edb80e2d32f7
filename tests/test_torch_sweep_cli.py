"""The port's bootstrap sweep and its CLI (misti_tpu_torch.engine.bootstrap,
misti_tpu_torch.cli.sweep) against the JAX package's, float64 on the CPU, on
the synth fixtures: 2 splits x 4 replicates (-bs 3).

The JAX CLI runs once, in --scenarios mode, with the fused-xla correction
(the CPU form of the TPU kernel, the algorithm the port runs) and one stage,
on two scenarios of one optimised band each: the JAX side traces and
compiles one sweep program (~50 s on XLA:CPU).  Its .npz tables are the JAX
sweep's results.  A two-band sweep would cost a second program; the port's
two-band fits are held against the JAX likelihood at and around them
instead (its grid likelihood is compared on a grid in test_torch_sweep.py).
"""

import contextlib
import io
import json
import os

import jax
import numpy as np
import pytest
import torch

from conftest import FIXDIR
from misti_tpu.cli import sweep as jax_cli
from misti_tpu.engine.sweep_fused import build_fused_sweep as jax_build_fused_sweep
from misti_tpu.io import psmc as jax_psmc
from misti_tpu_torch.cli import sweep as cli
from _torch_sweep_cases import one_torch_thread  # noqa: F401 (autouse fixture)

SYNTH = [os.path.join(FIXDIR, n) for n in ("synth1.psmc", "synth2.psmc", "synth.jsfs")]
BANDS = {"one_band": [["1", "2", "ST", "0.3", "1"]],
         "two_bands": [["1", "2", "ST", "0.3", "1"], ["2", "2", "ST", "0.2", "1"]]}
# the manifest: two scenarios of the same shape (one JAX sweep program)
MANIFEST = {"one_band": BANDS["one_band"], "one_band_start05": [["1", "2", "ST", "0.5", "1"]]}
# one stage (no resume program on the JAX side); staging is tested in
# test_torch_sweep.py
FLAGS = ["-bs", "3", "-uf", "--cpfit", "--nosmooth", "--funits", "/nonexistent",
         "--platform", "cpu", "--stages", "5000"]


class _Capture:
    """Standard output of a block (capsys is function-scoped; the runs are
    module-scoped fixtures)."""

    def __enter__(self):
        self._buf = io.StringIO()
        self._cm = contextlib.redirect_stdout(self._buf)
        self._cm.__enter__()
        return self

    def __exit__(self, *exc):
        self._cm.__exit__(*exc)
        self.text = self._buf.getvalue()


def _run(main, argv, out_dir):
    """(stdout, out_dir) of one CLI run writing its tables into ``out_dir``."""
    os.makedirs(out_dir)
    with _Capture() as cap:
        rc = main([*argv, "-o", os.path.join(out_dir, "r.npz")])
    assert rc == 0
    return cap.text, out_dir


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    d = tmp_path_factory.mktemp("manifest")
    ents = [{"name": name, "fpsmc1": SYNTH[0], "fpsmc2": SYNTH[1], "fjafs": SYNTH[2],
             "splits": [7, 8], "mi": mi} for name, mi in MANIFEST.items()]
    path = d / "m.json"
    path.write_text(json.dumps(ents))
    return d, ["--scenarios", str(path), *FLAGS]


@pytest.fixture(scope="module")
def jax_run(manifest):
    d, argv = manifest
    mp = pytest.MonkeyPatch()
    mp.setenv("MISTI_CORRECTION", "fused-xla")
    try:
        return _run(jax_cli.main, argv, d / "jax")
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def torch_run(manifest):
    d, argv = manifest
    return _run(cli.main, argv, d / "torch")


@pytest.fixture(scope="module")
def two_band_run(tmp_path_factory):
    argv = [*SYNTH, "--splits", "7", "8"]
    for band in BANDS["two_bands"]:
        argv += ["-mi", *band]
    return _run(cli.main, [*argv, *FLAGS], tmp_path_factory.mktemp("two") / "torch")


def _two_bands_on_the_jax_surface(z):
    """The port's two-band fits (2 splits x 4 rows) on the JAX package's
    fused-xla grid likelihood: the fitted llh equal to it within rtol 1e-6,
    and no fit beaten by more than 1e-6 at a step of 5% (+ 1e-3) up or down
    in any one rate: they are the JAX likelihood's local optima."""
    inp = jax_psmc.read_psmc(SYNTH[0], SYNTH[1], 0, -1)
    fj = jax_build_fused_sweep(inp.times, inp.lambdas, [7.0, 8.0], BANDS["two_bands"],
                               cpfit=True, smooth=False, unfolded=True,
                               correction_mode="fused-xla")
    x = z["params"].reshape(8, 2)
    steps = [np.zeros(2)] + [s * np.eye(2)[k] for k in range(2) for s in (-1, 1)]
    pts = np.stack([x + d * (0.05 * np.abs(x) + 1e-3) for d in steps])  # (5, 8, 2)
    st = np.tile(np.repeat([0, 1], 4), 5)
    data = np.tile(z["data"], (10, 1))
    llh = np.asarray(jax.jit(jax.vmap(fj.llh))(st, pts.reshape(-1, 2), data)).reshape(5, 8)
    np.testing.assert_allclose(z["llh"].ravel(), llh[0], rtol=1e-6)
    assert np.isfinite(llh[0]).all()
    assert (llh[1:] <= llh[0] + 1e-6).all(), llh[1:] - llh[0]


@pytest.mark.parametrize("name", sorted(BANDS))
def test_sweep_matches_jax(jax_run, torch_run, two_band_run, name):
    """One band: fitted llh within 1e-6, parameters within 1e-4, the same
    evaluation counts (so the same convergence) and the same per-replicate
    argmax as the JAX sweep.  Two bands: converged fits at the optima of
    the JAX likelihood."""
    n = len(BANDS[name])
    if n == 2:
        zt = np.load(two_band_run[1] / "r.npz")
        assert zt["params"].shape == (2, 4, n)
        assert int(zt["nfev"].max()) < (n + 1) + (n + 5) * 1000
        _two_bands_on_the_jax_surface(zt)
        return
    zj = np.load(jax_run[1] / f"r.{name}.npz")
    zt = np.load(torch_run[1] / f"r.{name}.npz")
    assert zt["params"].shape == zj["params"].shape == (2, 4, n)
    np.testing.assert_array_equal(zt["data"], zj["data"])
    np.testing.assert_allclose(zt["llh"], zj["llh"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(zt["params"], zj["params"], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(zt["nfev"], zj["nfev"])
    assert int(zj["nfev"].max()) < (n + 1) + (n + 5) * 1000  # every JAX fit converged
    np.testing.assert_array_equal(zt["llh"].argmax(0), zj["llh"].argmax(0))


def _cells(text):
    """{(scenario, bs_id, splitT): (time, params, llh)} of the cell lines."""
    out = {}
    for line in text.splitlines():
        if "bs_id = " not in line:
            continue
        f = dict(part.split(" = ", 1) for part in line.split(" \t"))
        key = (f.get("scenario", ""), int(f["bs_id"]), float(f["splitT"]))
        params = [float(v) for v in f["migration rates optim"].strip("[]").split(",")]
        out[key] = (float(f["time"]), params, float(f["llh"]))
    return out


def _summaries(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def _assert_same_output(jax_out, torch_out, npz_names):
    (text_j, dir_j), (text_t, dir_t) = jax_out, torch_out
    cells_j, cells_t = _cells(text_j), _cells(text_t)
    assert sorted(cells_t) == sorted(cells_j) and cells_j
    for key, (tg, params, llh) in cells_t.items():
        tg_j, params_j, llh_j = cells_j[key]
        assert tg == tg_j, key
        np.testing.assert_allclose(params, params_j, rtol=0, atol=1e-6, err_msg=str(key))
        np.testing.assert_allclose(llh, llh_j, rtol=0, atol=1e-6, err_msg=str(key))
    summ_j, summ_t = _summaries(text_j), _summaries(text_t)
    assert [sorted(s) for s in summ_t] == [sorted(s) for s in summ_j]
    for s_t, s_j in zip(summ_t, summ_j):
        for k in ("cells", "argmax_hist", "ci_level", "scenario", "matrix_scenarios",
                  "matrix_cells", "shared_programs"):
            assert s_t.get(k) == s_j.get(k), k
        for k in ("split_mean_gens", "split_ci_gens"):
            if k in s_j:
                np.testing.assert_allclose(s_t[k], s_j[k], rtol=1e-12)
    for name in npz_names:
        zj, zt = np.load(dir_j / name), np.load(dir_t / name)
        assert sorted(zt.files) == sorted(zj.files)
        for k in ("split_times", "data", "times", "scale_time"):
            np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
        np.testing.assert_allclose(zt["llh"], zj["llh"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(zt["params"], zj["params"], rtol=0, atol=1e-6)


def test_cli_manifest_matches_jax_cli(jax_run, torch_run):
    (text_j, dir_j), (text_t, dir_t) = jax_run, torch_run
    _assert_same_output((text_j, dir_j), (text_t, dir_t), [f"r.{n}.npz" for n in MANIFEST])
    assert len(_cells(text_t)) == 2 * 2 * 4  # 2 scenarios x 2 splits x 4 rows
    matrix = _summaries(text_t)[-1]
    assert matrix["matrix_scenarios"] == 2 and matrix["matrix_cells"] == 16
    assert matrix["shared_programs"] == 1  # the two scenarios have one shape


def test_cli_single_scenario(jax_run, torch_run, tmp_path):
    """Positional mode prints the manifest's one-band cells without the
    scenario tag, bitwise, and writes the same table."""
    argv = [*SYNTH, "--splits", "7", "8", "-mi", *BANDS["one_band"][0], *FLAGS]
    text, _ = _run(cli.main, argv, tmp_path / "single")
    one = {k[1:]: v for k, v in _cells(torch_run[0]).items() if k[0] == "one_band"}
    assert {k[1:]: v for k, v in _cells(text).items()} == one
    zs = np.load(tmp_path / "single" / "r.npz")
    zm = np.load(torch_run[1] / "r.one_band.npz")
    for k in zm.files:
        np.testing.assert_array_equal(zs[k], zm[k], err_msg=k)
    summ = _summaries(text)
    assert len(summ) == 1 and "scenario" not in summ[0]
    assert sorted(summ[0]) == sorted(k for k in _summaries(jax_run[0])[0] if k != "scenario")


def test_cli_refuses_duplicate_scenario_names(tmp_path, capsys):
    ent = {"name": "dup", "fpsmc1": SYNTH[0], "fpsmc2": SYNTH[1], "fjafs": SYNTH[2],
           "splits": [7, 8], "mi": [["1", "2", "ST", "0.3", "1"]]}
    mpath = tmp_path / "m.json"
    mpath.write_text(json.dumps([ent, dict(ent)]))
    rc = cli.main(["--scenarios", str(mpath), *FLAGS])
    assert rc == 2
    assert "duplicate scenario names" in capsys.readouterr().err


def test_cli_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default platform resolves")
    argv = [*SYNTH, "--splits", "7", "8", "-bs", "1", "-mi", "1", "2", "ST", "0.3", "1",
            "-uf", "--cpfit", "--funits", "/nonexistent"]
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(argv)
