"""The JAX package's float64 CPU reference (scripts/jax_f64_reference.py) that
the port's matrix and north-star gates hold to: the committed tables hold
every cell and record how they were made, and the script's merge keeps one
entry per scenario and mode.  Nothing here runs the JAX sweep."""

import importlib.util
import json
import os

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load("jax_f64_reference", "scripts/jax_f64_reference.py")
mc = _load("torch_matrix_card", "scripts/torch_matrix_card.py")
SPLITS = [float(s) for s in range(20, 28)]


def _recorded(meta):
    """A run's record: its command, fused-xla on the CPU, float64, jax's
    version, the CPU and the wall."""
    assert "--platform cpu" in meta["command"]
    assert meta["env"]["MISTI_CORRECTION"] == "fused-xla" and meta["env"]["JAX_PLATFORMS"] == "cpu"
    assert meta["dtype"] == "float64" and meta["jax"] and meta["host"]["cpu"]
    assert meta["wall_s"] > 0


def test_matrix_reference_holds_every_cell_and_its_run():
    """The 16 scenarios in both residual modes x 808 cells; each entry's
    histogram is its parsed cells' and its unconverged cells are listed."""
    with open(mc.TABLE_JSON) as f:
        entries = json.load(f)["entries"]
    with open(mc.TABLE_OUT) as f:
        cells = mc.parse_cells(f)
    with open(ref.MANIFEST) as f:
        names = [e["name"] for e in json.load(f)]
    assert sorted(entries) == sorted(f"{m}:{n}" for m in ("cpfit", "ect") for n in names)
    for key, e in entries.items():
        _recorded(e)
        c = cells[e["scenario"] if e["mode"] == "cpfit" else key]
        assert len(c) == 808, key
        llh = mc.table_llh(c, SPLITS, 101)
        assert np.isfinite(llh).all(), key
        assert mc.argmax_hist(llh, SPLITS) == e["argmax_hist"], key
        assert e["unconverged"] == len(e["unconverged_cells"])
        assert int((~mc.table_converged(e, SPLITS, 101)).sum()) == e["unconverged"]
        assert e["degenerate"] == (e["split_ci_gens"][0] == e["split_ci_gens"][1])


@pytest.mark.parametrize("mode", ["cpfit", "ect"])
def test_north_star_reference_holds_every_cell_and_its_run(mode):
    """The north-star sweep's tables: 8 splits x 101 replicates in float64,
    the port's replicate spectra, convergence flags, and a record whose
    histogram is the table's."""
    from misti_tpu_torch.engine import bootstrap
    from misti_tpu_torch.io import jsfs as io_jsfs

    z = np.load(ref.SWEEP_NPZ[mode])
    meta = json.loads(str(z["meta"]))
    _recorded(meta)
    assert f"--maxiter {ref.SWEEP_MAXITER[mode]}" in meta["command"]
    assert ("--cpfit" in meta["command"]) == (mode == "cpfit")
    assert z["params"].shape == (8, 101, 1) and z["params"].dtype == np.float64
    assert z["llh"].dtype == np.float64 and z["converged"].shape == (8, 101)
    data = bootstrap.make_bootstrap_data(
        io_jsfs.read_jafs(os.path.join(REPO, "tests", "fixtures", "sweep.jsfs")), 100, seed=0)
    np.testing.assert_array_equal(z["data"], data)
    assert mc.argmax_hist(z["llh"], SPLITS) == meta["summary"]["argmax_hist"]
    assert int((~z["converged"]).sum()) == len(meta["unconverged_cells"])


def test_merge_keeps_one_entry_per_scenario_and_mode(tmp_path, monkeypatch):
    """Parts merge into the JSON and the .out in the manifest's order, cpfit
    first; a later part replaces an entry and its lines; ECT lines keep
    their ``ect:`` names."""
    monkeypatch.setattr(ref, "MATRIX_JSON", str(tmp_path / "m.json"))
    monkeypatch.setattr(ref, "MATRIX_OUT", str(tmp_path / "m.out"))

    def line(key, llh):
        return f"scenario = {key} \tbs_id = 0 \tsplitT = 20.0 \ttime = 1.0 \tmigration " \
               f"rates optim = [] \tllh = {llh}"

    parts = []
    for i, (entries, lines) in enumerate([
            ({"cpfit:pair2.no.mig": {"n": 1}, "ect:pair1.mi2": {"n": 1}},
             {"cpfit:pair2.no.mig": [line("pair2.no.mig", -1.0)],
              "ect:pair1.mi2": [line("ect:pair1.mi2", -2.0)]}),
            ({"cpfit:pair1.mi12": {"n": 2}, "cpfit:pair2.no.mig": {"n": 2}},
             {"cpfit:pair1.mi12": [line("pair1.mi12", -3.0)],
              "cpfit:pair2.no.mig": [line("pair2.no.mig", -4.0)]})]):
        path = tmp_path / f"p{i}.json"
        path.write_text(json.dumps({"entries": entries, "cell_lines": lines}))
        parts.append(str(path))
    ref.merge(parts[:1])
    ref.merge(parts[1:])  # onto the files the first merge wrote
    got = json.loads((tmp_path / "m.json").read_text())["entries"]
    assert list(got) == ["cpfit:pair1.mi12", "cpfit:pair2.no.mig", "ect:pair1.mi2"]
    assert got["cpfit:pair2.no.mig"]["n"] == 2
    cells = mc.parse_cells((tmp_path / "m.out").read_text().splitlines())
    assert cells == {"pair1.mi12": {(20.0, 0): ((), -3.0)},
                     "pair2.no.mig": {(20.0, 0): ((), -4.0)},
                     "ect:pair1.mi2": {(20.0, 0): ((), -2.0)}}
