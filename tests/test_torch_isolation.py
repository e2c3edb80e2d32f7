"""The port stands alone: importing misti_tpu_torch and running a likelihood,
a bootstrap sweep, the sweep CLI, the single-fit CLI, testmodel, the process
group set-up of dist/mesh.py, a converter of cli/tools.py, the plot CLI and
scripts/torch_matrix_card.py (a dry run on the CPU) loads neither jax nor any
module of misti_tpu, and its entry points default to the GPU (raising without
one) instead of quietly picking the CPU.

The import check runs in a subprocess: this test process has jax loaded
already (tests/conftest.py).
"""

import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import sys
import numpy as np
from misti_tpu_torch import build_likelihood, build_spec

spec = build_spec([0.1, 0.2, 0.3, 0.4], [[1.0, 1.5], [0.8, 1.2], [1.1, 0.9],
                  [1.0, 1.0], [1.2, 1.2]], [0, 50, 20, 40, 10, 8, 5, 3], 2,
                  [[1, 0, 2, 0.2, 1]], [], cpfit=True, unfolded=True)
llh = float(build_likelihood(spec, device="cpu").llh(np.array([0.2])))
assert np.isfinite(llh), llh

from misti_tpu_torch.engine import bootstrap
from misti_tpu_torch.cli import sweep as cli

res = bootstrap.sweep([0.1, 0.2, 0.3, 0.4], [[1.0, 1.5], [0.8, 1.2], [1.1, 0.9],
                      [1.0, 1.0], [1.2, 1.2]], [[50, 20, 40, 10, 8, 5, 3]], [2, 3],
                      [[1, 0, "ST", 0.2, 1]], device="cpu", maxiter=3, cpfit=True,
                      unfolded=True)
assert np.isfinite(res.llh).all(), res.llh
fix = "tests/fixtures/"
rc = cli.main([fix + "synth1.psmc", fix + "synth2.psmc", fix + "synth.jsfs", "--splits",
               "7", "7", "-bs", "0", "-mi", "1", "2", "ST", "0.3", "1", "-uf", "--cpfit",
               "--funits", "/nonexistent", "--platform", "cpu", "--maxiter", "2"])
assert rc == 0, rc

from misti_tpu_torch.cli import misti, testmodel

rc = misti.main([fix + "synth1.psmc", fix + "synth2.psmc", fix + "synth.jsfs", "8", "-uf",
                 "-mi", "1", "2", "8", "0.3", "0", "-bs", "0", "--funits", "/nonexistent",
                 "--platform", "cpu"])
assert rc == 0, rc
rc = testmodel.main(["-n 1 10 -n 2 4.5 -eN 0.025 0.2 -ej 0.045 2 1 -eN 0.175 3", "-uf",
                     "--funits", "/nonexistent", "--platform", "cpu"])
assert rc == 1, rc
import contextlib
import importlib.util
import io
import os
import tempfile

from misti_tpu_torch.dist import mesh
from misti_tpu_torch.cli import mistiplot, tools

assert mesh.init_distributed() is None  # one process: no group
with contextlib.redirect_stdout(io.StringIO()):
    assert tools.merge_jsfs_main([fix + "tools/chunks_a.jsfs", fix + "tools/chunks_b.jsfs"]) == 0
    if importlib.util.find_spec("matplotlib") is not None:
        with tempfile.TemporaryDirectory() as d:
            assert mistiplot.main([fix + "ref_fit.mi", "--funits", "/nonexistent",
                                   "-o", os.path.join(d, "f.pdf")]) == 0
spec_m = importlib.util.spec_from_file_location("torch_matrix_card",
                                                "scripts/torch_matrix_card.py")
mc = importlib.util.module_from_spec(spec_m)
spec_m.loader.exec_module(mc)
with tempfile.TemporaryDirectory() as d, contextlib.redirect_stdout(io.StringIO()):
    # one no-migration scenario at 2 rows: its gates fail against the table (rc 1)
    assert mc.main(["--platform", "cpu", "--bs", "1", "--maxiter", "1", "--only",
                    "pair2.no.mig", "--out", os.path.join(d, "m.json")]) == 1
    assert os.path.exists(os.path.join(d, "m.json"))
import misti_tpu_torch.probe  # noqa: F401
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "misti_tpu"
             or m.startswith("misti_tpu."))
print("LOADED", bad)
"""


def test_port_imports_no_jax_and_no_misti_tpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_sources_name_no_jax_and_no_misti_tpu():
    pattern = re.compile(
        r"^\s*(import jax|from jax|import misti_tpu(\.|\s|,|$)|from misti_tpu(\.| import))",
        re.MULTILINE)
    files = [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "scripts",
                                                              "torch_matrix_card.py")]
    for root, _, names in os.walk(os.path.join(REPO, "misti_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith((".py", ".cu"))]
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            hit = pattern.search(f.read())
        assert hit is None, f"{path}: {hit.group(0) if hit else ''}"


def test_default_device_is_the_gpu():
    from misti_tpu_torch import build_likelihood, build_spec

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    spec = build_spec([0.1, 0.2], [[1.0, 1.5], [0.8, 1.2], [1.0, 1.0]],
                      [0, 50, 20, 40, 10, 8, 5, 3], 1, correct=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_likelihood(spec)
    lik = build_likelihood(spec, device="cpu")
    assert lik.dtype == torch.float64


def test_single_fit_cli_defaults_to_the_gpu():
    from misti_tpu_torch.cli import misti

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    fix = os.path.join(REPO, "tests", "fixtures")
    with pytest.raises(RuntimeError, match="CUDA"):
        misti.main([os.path.join(fix, f) for f in ("synth1.psmc", "synth2.psmc", "synth.jsfs")]
                   + ["8", "-uf", "-mi", "1", "2", "8", "0.3", "1", "--funits", "/nonexistent"])
