"""Where the benchmark's pieces live, found by the names in BENCHMARK.json.

A cell ``<config>.<traffic>`` runs the configuration
``configs/<config>.json`` (its input files under ``data/<config>/``) under
the traffic mix ``traffic/<traffic>.json``, holds its outputs to
``limits/<cell>.json``, and in a traced run reads each of its per-layer
metrics with ``metrics/<metric>.py``.  A piece that is named and missing is
an error: nothing falls back to another piece or to the CPU.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class LayoutError(RuntimeError):
    """A cell, or a file that a cell names, does not exist."""


def _load_json(path: Path) -> dict:
    if not path.is_file():
        raise LayoutError(f"missing {path.relative_to(ROOT)}")
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _load_json(ROOT / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise LayoutError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    """A configuration's file, with ``inputs`` resolved to absolute paths."""
    for c in bench["configs"]:
        if c["name"] == name:
            out = _load_json(ROOT / c["file"])
            data = BENCH_DIR / "data" / name
            out["paths"] = {k: str(data / v) for k, v in out["inputs"].items()}
            for p in out["paths"].values():
                if not Path(p).is_file():
                    raise LayoutError(f"missing input {Path(p).relative_to(ROOT)}")
            return out
    raise LayoutError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return _load_json(BENCH_DIR / "traffic" / f"{name}.json")


def limits(cell_name: str) -> dict:
    return _load_json(BENCH_DIR / "limits" / f"{cell_name}.json")


def end_to_end(bench: dict, cell_name: str) -> list:
    """The end-to-end metrics this cell reports."""
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell_name in m["workloads"]]


def per_layer(bench: dict, cell_name: str) -> list:
    """The per-layer metrics this cell reports: those that list it, and
    those with no list whose end-to-end metric the cell reports."""
    reported = {m["name"] for m in end_to_end(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def reader(metric_name: str):
    """The ``read(ctx)`` function of ``metrics/<metric_name>.py``."""
    path = BENCH_DIR / "metrics" / f"{metric_name}.py"
    if not path.is_file():
        raise LayoutError(f"missing {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric_name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
