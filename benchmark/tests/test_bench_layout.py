"""BENCHMARK.json and the files its names resolve to."""

import json
import re
import shutil

import pytest

from benchmark.harness import layout

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture
def bench():
    return layout.benchmark()


def test_every_named_piece_resolves(bench):
    for c in bench["configs"]:
        cfg = layout.config(bench, c["name"])
        assert set(cfg["paths"]) == {"psmc1", "psmc2", "jsfs"}
    for w in bench["workloads"]:
        assert layout.cell(bench, w["name"]) is w
        mix = layout.traffic(w["traffic"])
        assert mix["kind"] in ("sweep", "fit")
        lim = layout.limits(w["name"])
        assert set(lim) == {"llh_gap", "x_llh_gap"}
        assert layout.end_to_end(bench, w["name"])
        for m in layout.per_layer(bench, w["name"]):
            assert callable(layout.reader(m["name"]))


@pytest.mark.parametrize("what", ["config", "traffic", "limits", "metric", "cell", "input"])
def test_a_missing_piece_fails(bench, tmp_path, monkeypatch, what):
    copy = tmp_path / "benchmark"
    shutil.copytree(layout.BENCH_DIR, copy, ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(layout.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    monkeypatch.setattr(layout, "BENCH_DIR", copy)
    monkeypatch.setattr(layout, "ROOT", tmp_path)
    w = bench["workloads"][0]
    gone = {"config": copy / "configs" / f"{w['config']}.json",
            "traffic": copy / "traffic" / f"{w['traffic']}.json",
            "limits": copy / "limits" / f"{w['name']}.json",
            "metric": copy / "metrics" / "calls_per_sweep.py",
            "input": copy / "data" / w["config"] / "sweep.jsfs"}
    if what == "cell":
        with pytest.raises(layout.LayoutError):
            layout.cell(bench, "no_such.cell")
        return
    gone[what].unlink()
    call = {"config": lambda: layout.config(bench, w["config"]),
            "traffic": lambda: layout.traffic(w["traffic"]),
            "limits": lambda: layout.limits(w["name"]),
            "metric": lambda: layout.reader("calls_per_sweep"),
            "input": lambda: layout.config(bench, w["config"])}[what]
    with pytest.raises(layout.LayoutError):
        call()


def test_benchmark_json_keeps_the_contracts_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(bench)) < 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["source"].startswith("https://") and len(c["source"]) <= 200
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            moved = layout.end_to_end(bench, cell)
            assert m["moves"] in {x["name"] for x in moved}
    for x in bench["configs"] + bench["workloads"] + bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(x["name"]) and x["name"] not in names
        names.add(x["name"])
        if "unit" in x:
            assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        reported = layout.end_to_end(bench, w["name"])
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert layout.per_layer(bench, w["name"])
