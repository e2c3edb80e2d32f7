"""The port's converter CLIs (misti_tpu_torch.cli.tools) against the goldens
of tests/fixtures/tools/ (stdout and output-file bytes of upstream's utils/
scripts, tests/fixtures/generate_tool_fixtures.py), case for case as
tests/test_tools.py holds the JAX package's, and byte for byte against the
JAX package's tools on the same argv (they run no JAX program).

msrates and misti2ms have no golden (upstream's scripts print an object's
repr and cannot run, respectively): they are held to the JAX package's bytes
and to test_tools.py's structural checks.
"""

import contextlib
import io
import os
import random
import subprocess
import sys

import pytest

from misti_tpu.cli import tools as jax_tools
from misti_tpu_torch.cli import tools

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(REPO, "tests", "fixtures")
FIX = os.path.join(FIXDIR, "tools")
BOOTSTRAP_SEED = 20260821  # must match generate_tool_fixtures.py

# (tool, argv run from tests/fixtures/tools/, golden of its stdout)
GOLDEN_CASES = {
    "angsdsfs": ("angsdsfs", ["angsd.sfs", "HAN", "FRE"], "angsdsfs.golden"),
    "angsdsfs_nopop": ("angsdsfs", ["angsd.sfs"], "angsdsfs_nopop.golden"),
    "ms2jsfs": ("ms2jsfs", ["mshot.ms", "-p", "HAN", "FRE", "-n", "5"], "ms2jsfs.golden"),
    "scrm2jafs": ("scrm2jafs", ["scrm.out"], "scrm2jafs.golden"),
    "ttmethod": ("ttmethod", ["chunks_plain.jsfs", "250000000"], "ttmethod.golden"),
    "generate_jsfs_bs": ("generate_jsfs_bs", ["5", "chunks_a.jsfs"], "generate_jsfs_bs.golden"),
    "calc_time": ("calc_time", ["../synth1.psmc", "../synth2.psmc", "--funits", "/nonexistent"],
                  "calc_time.golden"),
    "merge_jsfs": ("merge_jsfs", ["chunks_a.jsfs", "chunks_b.jsfs"],
                   "merge_jsfs_reference.golden"),
}


def golden(name: str) -> str:
    with open(os.path.join(FIX, name), "rb") as f:
        return f.read().decode()


def run_main(module, tool, argv, cwd=FIX):
    """stdout of ``module.<tool>_main(argv)`` run from ``cwd`` (the goldens
    were captured with relative paths), with the global RNG seeded as the
    goldens' generator seeds it."""
    out = io.StringIO()
    old = os.getcwd()
    os.chdir(cwd)
    random.seed(BOOTSTRAP_SEED)
    try:
        with contextlib.redirect_stdout(out):
            rc = getattr(module, f"{tool}_main")(argv)
    finally:
        os.chdir(old)
    assert rc == 0
    return out.getvalue()


@pytest.mark.parametrize("case", sorted(GOLDEN_CASES))
def test_tool_matches_golden_and_jax(case):
    tool, argv, gold = GOLDEN_CASES[case]
    got = run_main(tools, tool, argv)
    assert got == golden(gold)
    assert got == run_main(jax_tools, tool, argv)


def test_msrates_matches_jax():
    from misti_tpu_torch.io import ms_parse

    cmd = "-n 1 10 -n 2 4.5 -eN 0.025 0.2 -ej 0.045 2 1 -eN 0.175 3"
    out = run_main(tools, "msrates", [cmd])
    assert out == run_main(jax_tools, "msrates", [cmd])
    d = ms_parse.read_ms(cmd)
    assert f"divergenceTime   {d.divergence_time}" in out
    assert str(d.times) in out and str(d.lambdas) in out


def test_misti2ms_matches_jax():
    argv = [os.path.join(FIXDIR, "ref_fit.mi"), "--funits", "/nonexistent"]
    out = run_main(tools, "misti2ms", argv, cwd=FIXDIR)
    assert out == run_main(jax_tools, "misti2ms", argv, cwd=FIXDIR)
    ms = out.splitlines()[-1]
    assert ms.startswith(" 4 1000 -t ")
    for flag in (" -r ", " -l ", " -I 2 2 2 ", " -ej ", " -eM "):
        assert flag in ms
    assert ms.index(" -ej ") > ms.rindex(" -en ")


def test_mssplit_matches_golden_and_jax(tmp_path):
    for module, dest in ((tools, tmp_path / "torch"), (jax_tools, tmp_path / "jax")):
        dest.mkdir()
        run_main(module, "mssplit", ["mssplit_in.ms", str(dest)])
    for g in ("ms2g1.ms", "ms2g2.ms"):
        got = (tmp_path / "torch" / g).read_bytes()
        assert got.decode() == golden(f"mssplit_{g}.golden")
        assert got == (tmp_path / "jax" / g).read_bytes()


def test_tools_entry_point():
    """``python -m misti_tpu_torch.cli.tools <tool> ...`` runs the tool."""
    out = subprocess.run([sys.executable, "-m", "misti_tpu_torch.cli.tools", "merge_jsfs",
                          "chunks_a.jsfs", "chunks_b.jsfs"], cwd=FIX, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout == golden("merge_jsfs_reference.golden")
