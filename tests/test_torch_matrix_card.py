"""scripts/torch_matrix_card.py on the CPU: its reader of the JAX package's
matrix cell lines (the float32 TPU table scripts/matrix_r05.out and the
float64 CPU reference scripts/matrix_f64_cpu.out) and its judges, on toy
tables; and the one cpfit cell where the TPU table is not the float64
optimum.  The script itself runs on a card; so does the one test here that
needs one (it skips without a card).
"""

import importlib.util
import json
import os

import numpy as np
import pytest

from misti_tpu_torch.engine.bootstrap import SweepResult, split_time_confidence_interval

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "torch_matrix_card", os.path.join(REPO, "scripts", "torch_matrix_card.py"))
mc = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mc)

SPLITS = [20.0, 21.0, 22.0]
TIMES = np.full(30, 0.25)


@pytest.fixture(scope="module")
def table_cells():
    """The JAX package's float32 TPU table's cells."""
    with open(mc.OLD_TABLE_OUT) as f:
        return mc.parse_cells(f)


@pytest.fixture(scope="module")
def reference_cells():
    """The float64 CPU reference's cells (cpfit by name, ECT as ``ect:NAME``)."""
    with open(mc.TABLE_OUT) as f:
        return mc.parse_cells(f)


def test_parser_reads_every_cell_of_the_table(table_cells):
    """16 scenarios x 808 cells; known lines' parameters and llh; each
    scenario's argmax histogram from the parsed llh equals the one the JAX
    run printed (MATRIXBENCH_r05.json)."""
    assert len(table_cells) == 16
    assert sum(len(c) for c in table_cells.values()) == 12928
    assert table_cells["pair1.no.mig"][(20.0, 0)] == ((), -995.9375)
    assert table_cells["pair1.mi21"][(20.0, 2)] == ((0.0003915783,), -986.8125)
    assert table_cells["pair3.mi2"][(20.0, 1)] == ((0.00037074997, 0.0005073919), -552.0)
    with open(mc.OLD_TABLE_JSON) as f:
        per = {e["scenario"]: e for e in json.load(f)["per_scenario"] if "scenario" in e}
    splits = [float(s) for s in range(20, 28)]
    for name, cells in table_cells.items():
        llh = np.array([[cells[(s, b)][1] for b in range(101)] for s in splits])
        assert mc.argmax_hist(llh, splits) == per[name]["argmax_hist"], name
        par = mc.table_params(cells, splits, 101, len(cells[(20.0, 0)][0]))
        assert par.shape == (8, 101, len(cells[(20.0, 0)][0]))


def test_parser_skips_other_lines():
    lines = ["Units: mutation rate = 1.25e-08", '{"scenario": "x"}',
             "scenario = a.b \tbs_id = 3 \tsplitT = 24.0 \ttime = 1.5 \t"
             "migration rates optim = [1e-05, 2.5] \tllh = -12.25"]
    assert mc.parse_cells(lines) == {"a.b": {(24.0, 3): ((1e-05, 2.5), -12.25)}}


def _toy(seed):
    """One toy scenario: llh (3 splits, 5 rows), params (3, 5, 1), its table
    entry as the JAX run would print it, and a float64 llh that peaks at
    params 0.3 (so the table's fits sit at the optimum)."""
    rng = np.random.default_rng(seed)
    llh = rng.normal(-500.0, 3.0, (len(SPLITS), 5))
    params = np.full((len(SPLITS), 5, 1), 0.3)
    res = SweepResult(split_times=np.asarray(SPLITS), params=params, llh=llh, data=None)
    ci = split_time_confidence_interval(res, TIMES)
    table = {"argmax_hist": mc.argmax_hist(llh, SPLITS),
             "split_ci_gens": [float(ci["ci"][0]), float(ci["ci"][1])]}
    return llh, params, ci, table


def _llh64(params, cells):
    return -((np.asarray(params).reshape(-1, 1)[cells, 0] - 0.3) ** 2) * 100.0


@pytest.mark.parametrize("fault", ["none", "argmax_hist", "ci", "float64_llh", "finite"])
def test_judge_cpfit_on_a_toy_two_scenario_table(fault):
    """Both scenarios pass as they are; each fault fails its gate, and only
    that one, in the scenario it was put in."""
    verdicts = []
    for seed in (1, 2):
        llh, params, ci, table = _toy(seed)
        conv = np.ones(llh.shape, bool)
        if seed == 2 and fault == "argmax_hist":
            table = dict(table, argmax_hist={"20.0": 5})
        if seed == 2 and fault == "ci":
            table = dict(table, split_ci_gens=[table["split_ci_gens"][0] + 0.02,
                                               table["split_ci_gens"][1]])
        if seed == 2 and fault == "float64_llh":
            params = params.copy()
            params[1, 3, 0] = 0.3 + 0.03  # 0.09 nats below the table's fit
        if seed == 2 and fault == "finite":
            llh = llh.copy()
            llh[0, 0] = -np.inf
        table_par = np.full_like(params, 0.3)
        verdicts.append(mc.judge_table(llh, params, conv, SPLITS, ci, table, table_par, llh,
                                       conv, _llh64))
    assert verdicts[0]["ok"]
    bad = verdicts[1]
    if fault == "none":
        assert bad["ok"]
    else:
        assert not bad["ok"]
        assert [g for g, ok in bad["gates"].items() if not ok] == [fault]


def test_judge_cpfit_skips_unconverged_cells_and_marks_degenerate_cis():
    """A cell left unconverged by this run or by the reference is not
    judged; a zero-width reference CI is marked."""
    llh, params, ci, table = _toy(3)
    params = params.copy()
    params[2, 1, 0] = 5.0  # far off, but the cell did not converge
    params[0, 4, 0] = 4.0  # far off, but the reference's cell did not converge
    conv, ref_conv = np.ones(llh.shape, bool), np.ones(llh.shape, bool)
    conv[2, 1] = ref_conv[0, 4] = False
    tp = np.full_like(params, 0.3)
    v = mc.judge_table(llh, params, conv, SPLITS, ci, table, tp, llh, ref_conv, _llh64)
    assert v["ok"] and v["float64_judged_cells"] == llh.size - 2
    assert not v["degenerate"] and v["share_llh_within_1e-6"] == 1.0
    v = mc.judge_table(llh, params, conv, SPLITS, ci, dict(table, split_ci_gens=[7.0, 7.0]),
                       tp, llh + np.where(np.arange(llh.size).reshape(llh.shape) < 3, 1e-3, 0.0),
                       ref_conv, _llh64)
    assert v["degenerate"] and not v["gates"]["ci"]
    assert v["share_llh_within_1e-6"] == 1 - 3 / llh.size


@pytest.mark.parametrize("gap, ok", [(-0.049, True), (-0.051, False)], ids=["within", "below"])
def test_judge_refit(gap, ok):
    """ECT: the float32 fit's float64 llh against the float64 re-fit's on the
    cells converged in both; a cell not converged in both is not judged."""
    refit = np.array([-10.0, -20.0, -30.0, -40.0])
    f32 = refit + np.array([0.0, gap, 0.01, -9.0])
    both = np.array([True, True, True, False])
    v = mc.judge_refit(f32, refit, both)
    assert v["ok"] is ok and v["float64_judged_cells"] == 3


def test_merge_keeps_one_entry_per_scenario_and_mode(tmp_path):
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    mc.write({"cpfit:x": {"ok": True, "n": 1}, "ect:x": {"ok": True}}, str(a))
    mc.write({"cpfit:x": {"ok": False, "n": 2}}, str(b))
    out = tmp_path / "m.json"
    assert mc.main(["--merge", str(a), str(b), "--out", str(out)]) == 0
    got = json.loads(out.read_text())["entries"]
    assert sorted(got) == ["cpfit:x", "ect:x"] and got["cpfit:x"]["n"] == 2


PAIR2_MI = [["1", "4", "ST", "1", "1"], ["2", "4", "ST", "1", "1"]]
PAIR2_FLAGS = dict(unfolded=True, smooth=False, cpfit=True, tol=1e-4, maxiter=1000)


def _pair2_cell(row=81):
    """pair2's merged grid and bootstrap row ``row`` (seed 0), as the matrix
    fits them."""
    from misti_tpu_torch.engine import bootstrap as tb
    from misti_tpu_torch.io import jsfs as tio_jsfs
    from misti_tpu_torch.io import psmc as tio_psmc

    fix = os.path.join(REPO, "tests", "fixtures", "matrix") + os.sep
    inp = tio_psmc.read_psmc(fix + "pair2_1.psmc", fix + "pair2_2.psmc", 0, -1)
    data = tb.make_bootstrap_data(tio_jsfs.read_jafs(fix + "pair2.jsfs"), 100, seed=0)
    return inp, data[row:row + 1]


def test_pair2_mi2_cell_float64_fit_matches_jax_and_beats_the_table(table_cells,
                                                                    reference_cells,
                                                                    monkeypatch):
    """The one cpfit matrix cell where the card's converged float32 fit sat
    below the JAX TPU table's (pair2.mi2, split 24, bootstrap row 81): fitted
    in float64 on the CPU, the port and the JAX package reach the same
    optimum, the float64 reference (scripts/matrix_f64_cpu.out) holds it, and
    it lies above the TPU table's fit, whose float64 llh is lower by more
    than the gate's 5e-2 -- so the TPU table is not the float64 optimum
    there."""
    import torch

    from misti_tpu.engine import bootstrap as jb
    from misti_tpu.io import jsfs as jio_jsfs
    from misti_tpu.io import psmc as jio_psmc
    from misti_tpu_torch.engine import bootstrap as tb
    from misti_tpu_torch.engine.sweep_fused import build_fused_sweep

    monkeypatch.setenv("MISTI_CORRECTION", "fused-xla")  # the port's correction algorithm
    fix = os.path.join(REPO, "tests", "fixtures", "matrix") + os.sep
    inp, data = _pair2_cell()
    port = tb.sweep(inp.times, inp.lambdas, data, [24.0], PAIR2_MI, (), device="cpu",
                    dtype=torch.float64, sample_date=inp.sample_date_discr, **PAIR2_FLAGS)
    jinp = jio_psmc.read_psmc(fix + "pair2_1.psmc", fix + "pair2_2.psmc", 0, -1)
    jdata = jb.make_bootstrap_data(jio_jsfs.read_jafs(fix + "pair2.jsfs"), 100, seed=0)[81:82]
    np.testing.assert_array_equal(jdata, data)
    ref = jb.sweep(jinp.times, jinp.lambdas, jdata, [24.0], PAIR2_MI, (),
                   sample_date=jinp.sample_date_discr, stage_caps=(1000,), **PAIR2_FLAGS)
    assert bool(port.converged.all()) and int(port.nfev[0, 0]) == int(np.asarray(ref.nfev)[0, 0])
    np.testing.assert_allclose(port.params[0, 0], np.asarray(ref.params)[0, 0], rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(port.llh[0, 0], np.asarray(ref.llh)[0, 0], rtol=1e-10)
    ref_x, ref_llh = reference_cells["pair2.mi2"][(24.0, 81)]
    np.testing.assert_allclose(ref_x, np.asarray(ref.params)[0, 0], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(ref_llh, np.asarray(ref.llh)[0, 0], rtol=1e-10)

    fs = build_fused_sweep(inp.times, inp.lambdas, [24.0], PAIR2_MI, (),
                           sample_date=inp.sample_date_discr, unfolded=True, smooth=False,
                           cpfit=True, device="cpu", dtype=torch.float64)
    table_x = table_cells["pair2.mi2"][(24.0, 81)][0]
    llh_table = float(fs.llh(torch.zeros(1, dtype=torch.int64), np.array([table_x]), data)[0])
    assert port.llh[0, 0] - llh_table > mc.LLH_LIMIT


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sweep's kernels have no CPU form")
    return torch.device("cuda")


def test_card_pair2_mi2_cell_default_dtype_reaches_the_float64_fit(cuda):
    """C5's cell on the card: the port's sweep in its default dtype fits
    pair2.mi2, split 24, bootstrap row 81 no lower than its float64 fit on
    the CPU, by at most 1e-6 nats (float32 parameters stopped 0.191 nats
    short there)."""
    import torch

    from misti_tpu_torch.engine import bootstrap as tb

    inp, data = _pair2_cell()
    kw = dict(sample_date=inp.sample_date_discr, **PAIR2_FLAGS)
    card = tb.sweep(inp.times, inp.lambdas, data, [24.0], PAIR2_MI, (), device=cuda, **kw)
    cpu = tb.sweep(inp.times, inp.lambdas, data, [24.0], PAIR2_MI, (), device="cpu",
                   dtype=torch.float64, **kw)
    assert card.params.dtype == np.float64
    assert bool(card.converged.all()) and bool(cpu.converged.all())
    assert card.llh[0, 0] >= cpu.llh[0, 0] - 1e-6
