"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level name, and the reference imports nothing of the port."""

import ast
import json
import subprocess
import sys
import types
from pathlib import Path

import pytest

from benchmark.harness import cell
from benchmark.harness.layout import BENCH_DIR, ROOT

JAX_SIDE = {"jax", "jaxlib", "flax", "misti_tpu"}


def _top_imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _sources(*parts):
    return [p for p in sorted(BENCH_DIR.joinpath(*parts).rglob("*.py")) if "tests" not in p.parts]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_source_imports_the_jax_side(path):
    assert not _top_imports(path) & JAX_SIDE


@pytest.mark.parametrize("path", _sources("reference"), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    assert not _top_imports(path) & (JAX_SIDE | {"misti_tpu_torch", "benchmark"})


def test_the_check_compares_whole_top_level_names(monkeypatch):
    for name in ("misti_tpu_torch", "misti_tpu_torch.engine", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert not set(cell.forbidden_modules()) & {"misti_tpu_torch", "jaxtyping", "flaxen"}
    monkeypatch.setitem(sys.modules, "misti_tpu.engine", types.ModuleType("misti_tpu.engine"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert {"misti_tpu", "jax"} <= set(cell.forbidden_modules())


def test_loading_the_harness_and_the_reference_loads_no_jax():
    code = ("import sys, json; sys.path.insert(0, %r)\n"
            "import benchmark.reference.fit, benchmark.roofline.first_call\n"
            "ref = {m.split('.')[0] for m in sys.modules}\n"
            "import benchmark.harness.cell, benchmark.harness.drivers\n"
            "import misti_tpu_torch.engine.bootstrap, misti_tpu_torch.engine.optimize\n"
            "print(json.dumps([sorted(ref), sorted({m.split('.')[0] for m in sys.modules})]))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env={"PATH": "/usr/bin:/bin"})
    ref, everything = json.loads(out.stdout.strip().splitlines()[-1])
    assert not set(ref) & (JAX_SIDE | {"misti_tpu_torch"})
    assert not set(everything) & JAX_SIDE
