"""The port's single-fit and forward-model CLIs (misti_tpu_torch.cli.misti,
misti_tpu_torch.cli.testmodel) with ``--platform cpu``: test_cli.py's four
cases against upstream's outputs with its tolerances, and one fit and one
testmodel run against the JAX CLIs' own output.

The JAX fit runs with the fused-xla correction, the CPU form of the
algorithm the port runs (its CPU default, scan-seq, is another algorithm
with llh ~1e-6 apart), on the pulse case: cpfit with no migration band,
whose program XLA:CPU compiles in seconds (a band's takes 50-130 s).
"""

import contextlib
import io
import os
import re

import numpy as np
import pytest

from conftest import FIXDIR
from misti_tpu.cli import misti as jax_cli
from misti_tpu.cli import testmodel as jax_testmodel
from misti_tpu.io.units import Units as JaxUnits
from misti_tpu_torch.cli import misti as cli
from misti_tpu_torch.cli import testmodel
from misti_tpu_torch.io import mi_format
from misti_tpu_torch.io.units import Units
from _torch_sweep_cases import one_torch_thread  # noqa: F401 (autouse fixture)

FILES = [os.path.join(FIXDIR, f) for f in ("synth1.psmc", "synth2.psmc", "synth.jsfs")]
PULSE_ARGS = ["8", "-uf", "-pu", "2", "4", "0.2", "1", "-pu", "1", "6", "0.1", "0", "--cpfit",
              "-bs", "0", "--funits", "/nonexistent"]
README_MS = ("-n 1 10 -n 2 4.5 -eN 0.025 0.2 -ej 0.045 2 1 -eN 0.175 3 "
             "-eN 0.625 1.8 -eN 3 3.2 -eN 8 5.5")
README_JSFS = [0.229988, 0.082942, 0.228294, 0.131016, 0.121698, 0.083215, 0.122846]


@pytest.fixture(autouse=True)
def default_units():
    """Units is class-level state that --funits / --hetloss set."""
    Units.reset()
    JaxUnits.reset()
    yield


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue().splitlines(), err.getvalue()


def _grab(lines, prefix):
    hits = [ln for ln in lines if ln.startswith(prefix)]
    assert hits, f"missing line {prefix!r}"
    return hits[0]


def _assert_fit_close(ours, ref, pr_rtol=1e-3, pr_atol=1e-6):
    """test_cli.py's tolerances against upstream's .mi."""
    np.testing.assert_allclose(ours.llh, ref.llh, rtol=2e-6)
    assert ours.split_t == ref.split_t
    np.testing.assert_allclose(ours.jafs, ref.jafs, rtol=5e-5, atol=1e-7)
    np.testing.assert_allclose(ours.lambda1, ref.lambda1, rtol=5e-4)
    np.testing.assert_allclose(ours.lambda2, ref.lambda2, rtol=5e-4)
    np.testing.assert_allclose(np.asarray(ours.pr11), np.asarray(ref.pr11),
                               rtol=pr_rtol, atol=pr_atol)


def test_misti_cli_end_to_end(tmp_path):
    out_mi = tmp_path / "fit.mi"
    rc, lines, _ = _run(cli.main, FILES + [
        "8", "-uf", "-mi", "1", "2", "8", "0.3", "1", "-o", str(out_mi), "-bs", "0",
        "--funits", "/nonexistent", "--platform", "cpu"])
    assert rc == 0
    est = [ln for ln in lines if ln.startswith("bs_id =")]
    assert len(est) == 1
    assert "splitT = 8.0" in est[0] and "time = 402.69376" in est[0]
    ours = mi_format.read_migration(str(out_mi))
    ref = mi_format.read_migration(os.path.join(FIXDIR, "ref_fit.mi"))
    _assert_fit_close(ours, ref)
    np.testing.assert_allclose(ours.lambdah1, ref.lambdah1, rtol=1e-12)
    np.testing.assert_allclose(ours.times, ref.times, rtol=1e-12)


@pytest.fixture(scope="module")
def pulse_fit(tmp_path_factory):
    """The port's pulse fit (one optimised pulse, one fixed), with --aot."""
    Units.reset()
    out_mi = tmp_path_factory.mktemp("pulse") / "fit_pu.mi"
    rc, lines, err = _run(cli.main, FILES + PULSE_ARGS + [
        "-o", str(out_mi), "--platform", "cpu", "--aot"])
    return rc, lines, err, out_mi


def test_misti_cli_pulse_fit(pulse_fit):
    rc, _, _, out_mi = pulse_fit
    assert rc == 0
    _assert_fit_close(mi_format.read_migration(str(out_mi)),
                      mi_format.read_migration(os.path.join(FIXDIR, "ref_fit_pu.mi")))


def test_misti_cli_sdate_fit(tmp_path):
    out_mi = tmp_path / "fit_sdate.mi"
    rc, _, _ = _run(cli.main, FILES + [
        "8", "-uf", "--sdate", "80", "-mi", "1", "4", "8", "0.3", "1", "-o", str(out_mi),
        "-bs", "0", "--funits", "/nonexistent", "--platform", "cpu"])
    assert rc == 0
    ours = mi_format.read_migration(str(out_mi))
    ref = mi_format.read_migration(os.path.join(FIXDIR, "ref_fit_sdate.mi"))
    np.testing.assert_allclose(ours.llh, ref.llh, rtol=2e-6)
    assert ours.split_t == ref.split_t and ours.sample_date == ref.sample_date
    np.testing.assert_allclose(ours.jafs, ref.jafs, rtol=5e-5, atol=1e-7)
    np.testing.assert_allclose(ours.lambda1, ref.lambda1, rtol=5e-4)
    np.testing.assert_allclose(ours.lambda2, ref.lambda2, rtol=5e-4)


def test_misti_cli_debug_golden(tmp_path):
    """--debug stdout against the captured upstream run (ECT, one fixed band,
    no optimised parameter): the estimate line's text before the llh
    byte-identical, the llh to 2e-6, the Report() lines identical, and the
    stdout .mi table to test_cli.py's tolerances."""
    ref_lines = open(os.path.join(FIXDIR, "ref_debug_stdout.txt")).read().splitlines()
    rc, lines, _ = _run(cli.main, FILES + [
        "8", "-uf", "-mi", "1", "2", "8", "0.3", "0", "-bs", "0", "--funits", "/nonexistent",
        "--debug", "--platform", "cpu"])
    assert rc == 0
    ref_est, our_est = _grab(ref_lines, "bs_id ="), _grab(lines, "bs_id =")
    assert our_est.rsplit("llh =", 1)[0] == ref_est.rsplit("llh =", 1)[0]
    np.testing.assert_allclose(float(our_est.rsplit("llh =", 1)[1]),
                               float(ref_est.rsplit("llh =", 1)[1]), rtol=2e-6)
    for prefix in ("Total number of likelihood function calls is",
                   "Lambda correction called", "Lambda correction failed"):
        assert _grab(lines, prefix) == _grab(ref_lines, prefix)

    def mi_block(ls, name):
        i = ls.index("#MiSTI2 ver 0.4")
        j = [k for k, ln in enumerate(ls) if ln.startswith("RS\t")][-1]
        path = tmp_path / name
        path.write_text("\n".join(ls[i:j + 1]) + "\n")
        return mi_format.read_migration(str(path))

    ours, ref = mi_block(lines, "ours.mi"), mi_block(ref_lines, "ref.mi")
    _assert_fit_close(ours, ref, pr_rtol=1e-4, pr_atol=1e-8)
    np.testing.assert_allclose(ours.times, ref.times, rtol=1e-12)
    np.testing.assert_allclose(ours.lambdah1, ref.lambdah1, rtol=1e-12)
    np.testing.assert_allclose(ours.lambdah2, ref.lambdah2, rtol=1e-12)


_EST = re.compile(r"bs_id = (\S+) \tsplitT = (\S+) \ttime = (\S+) \tmigration rates "
                  r"(?:optim = \[(.*)\]) \tllh = (\S+)")


def test_misti_cli_matches_jax_cli(pulse_fit, tmp_path, monkeypatch):
    """The pulse fit against the JAX CLI's run of the same command: the
    solver summary and Report() lines to the character, the estimate line
    and the .mi file to 1e-9; --aot only notes on stderr that it does
    nothing."""
    rc, lines, err, out_mi = pulse_fit
    monkeypatch.setenv("MISTI_CORRECTION", "fused-xla")
    ref_mi = tmp_path / "jax.mi"
    rc_j, ref_lines, _ = _run(jax_cli.main, FILES + PULSE_ARGS + ["-o", str(ref_mi)])
    assert rc == rc_j == 0
    assert "--aot has no effect" in err
    for prefix in ("Optimization terminated", "         Current function value",
                   "         Iterations", "         Function evaluations",
                   "Total number of likelihood function calls is",
                   "Lambda correction called", "Lambda correction failed"):
        assert _grab(lines, prefix) == _grab(ref_lines, prefix)
    ours, ref = (_EST.fullmatch(_grab(ls, "bs_id =")).groups() for ls in (lines, ref_lines))
    assert ours[:3] == ref[:3]
    np.testing.assert_allclose([float(v) for v in ours[3].split(", ") + [ours[4]]],
                               [float(v) for v in ref[3].split(", ") + [ref[4]]],
                               rtol=1e-9, atol=0)
    a, b = mi_format.read_migration(str(out_mi)), mi_format.read_migration(str(ref_mi))
    assert (a.split_t, a.sample_date, a.thrh) == (b.split_t, b.sample_date, b.thrh)
    for field in ("llh", "jafs", "times", "lambda1", "lambda2", "lambdah1", "lambdah2",
                  "mu1", "mu2", "pr11", "pr22", "pr12"):
        np.testing.assert_allclose(np.asarray(getattr(a, field)),
                                   np.asarray(getattr(b, field)), rtol=1e-9, atol=1e-15,
                                   err_msg=field)


def test_testmodel_readme_oracle(tmp_path):
    out_mi = tmp_path / "tm.mi"
    rc, lines, _ = _run(testmodel.main, [README_MS, "-uf", "-o", str(out_mi),
                                         "--funits", "/nonexistent", "--platform", "cpu"])
    assert rc == 1  # the reference exits 1 (TestModel.py:127)
    assert len([ln for ln in lines if ln.startswith("Expected SFS")]) == 1
    d = mi_format.read_migration(str(out_mi))
    np.testing.assert_allclose(d.llh, -5.6330938966336905, rtol=1e-12)
    np.testing.assert_allclose(d.jafs, README_JSFS, atol=1e-6)


def test_testmodel_matches_jax(tmp_path):
    """The README scenario against a data spectrum, through both CLIs: the
    printed spectra and llh lines, and the .mi files (the forward model's
    mixed rates and location probabilities) to 1e-12."""
    argv = [README_MS, FILES[2], "-uf", "--funits", "/nonexistent"]
    rc, lines, _ = _run(testmodel.main, argv + ["-o", str(tmp_path / "a.mi"),
                                                "--platform", "cpu"])
    rc_j, ref_lines, _ = _run(jax_testmodel.main, argv + ["-o", str(tmp_path / "b.mi")])
    assert rc == rc_j == 1
    for prefix in ("Expected SFS", "Data     SFS", "data llh under the model is",
                   "maximum of the llh function is"):
        ours, ref = _grab(lines, prefix), _grab(ref_lines, prefix)
        nums = [re.findall(r"-?\d[\d.e+-]*", s) for s in (ours, ref)]
        np.testing.assert_allclose(np.asarray(nums[0], float), np.asarray(nums[1], float),
                                   rtol=1e-12, atol=0, err_msg=prefix)
    a = mi_format.read_migration(str(tmp_path / "a.mi"))
    b = mi_format.read_migration(str(tmp_path / "b.mi"))
    for field in ("llh", "jafs", "times", "lambda1", "lambdah1", "lambdah2", "pr11",
                  "pr22", "pr12"):
        np.testing.assert_allclose(np.asarray(getattr(a, field)),
                                   np.asarray(getattr(b, field)), rtol=1e-12, atol=1e-15,
                                   err_msg=field)


def test_testmodel_bootstrap_intervals():
    """-bs 4: the two llh intervals, each inside the bootstrap's own range."""
    rc, lines, _ = _run(testmodel.main, [README_MS, FILES[2], "-uf", "-bs", "4",
                                         "--funits", "/nonexistent", "--platform", "cpu"])
    assert rc == 1
    for prefix in ("10% confidence interval", "5% confidence interval"):
        lo, hi = (float(v) for v in _grab(lines, prefix).split()[-2:])
        assert np.isfinite(lo) and lo <= hi
