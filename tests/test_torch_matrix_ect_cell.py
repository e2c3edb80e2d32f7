"""The ECT matrix cell that float32 parameters left unconverged on the card
(pair1.mi2, split 23, bootstrap row 10: 7003 evaluations at ``--maxiter
1000``, MATRIX_torch_h100_float32.json).  Fitted in float64 on the
CPU, the port and the JAX package both converge there, in the same number
of evaluations, to the same optimum, and the JAX package's float64
reference (scripts/matrix_f64_cpu.out) holds that optimum.  So the cell was
the float32 simplex's, as the card's float64 run of the scenario (no cell
unconverged) shows."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures", "matrix") + os.sep
MI = [["1", "4", "ST", "1", "1"], ["2", "4", "ST", "1", "1"]]
FLAGS = dict(unfolded=True, smooth=False, cpfit=False, tol=1e-4, maxiter=1000)
SPLIT, ROW = 23.0, 10


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the lanes are few, more threads crowd the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_pair1_mi2_ect_cell_float64_fit_matches_jax_and_converges(monkeypatch):
    from misti_tpu.engine import bootstrap as jb
    from misti_tpu.io import jsfs as jio_jsfs
    from misti_tpu.io import psmc as jio_psmc
    from misti_tpu_torch.engine import bootstrap as tb
    from misti_tpu_torch.io import jsfs as tio_jsfs
    from misti_tpu_torch.io import psmc as tio_psmc

    monkeypatch.setenv("MISTI_CORRECTION", "fused-xla")  # the port's correction algorithm
    inp = tio_psmc.read_psmc(FIX + "pair1_1.psmc", FIX + "pair1_2.psmc", 0, -1)
    data = tb.make_bootstrap_data(tio_jsfs.read_jafs(FIX + "pair1.jsfs"), 100,
                                  seed=0)[ROW:ROW + 1]
    port = tb.sweep(inp.times, inp.lambdas, data, [SPLIT], MI, (), device="cpu",
                    dtype=torch.float64, sample_date=inp.sample_date_discr, **FLAGS)
    jinp = jio_psmc.read_psmc(FIX + "pair1_1.psmc", FIX + "pair1_2.psmc", 0, -1)
    jdata = jb.make_bootstrap_data(jio_jsfs.read_jafs(FIX + "pair1.jsfs"), 100,
                                   seed=0)[ROW:ROW + 1]
    np.testing.assert_array_equal(jdata, data)
    ref = jb.sweep(jinp.times, jinp.lambdas, jdata, [SPLIT], MI, (),
                   sample_date=jinp.sample_date_discr, stage_caps=(1000,), **FLAGS)
    assert bool(port.converged.all())
    assert int(port.nfev[0, 0]) == int(np.asarray(ref.nfev)[0, 0])
    np.testing.assert_allclose(port.params[0, 0], np.asarray(ref.params)[0, 0], rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(port.llh[0, 0], np.asarray(ref.llh)[0, 0], rtol=1e-10)

    spec = importlib.util.spec_from_file_location(
        "torch_matrix_card", os.path.join(REPO, "scripts", "torch_matrix_card.py"))
    mc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mc)
    with open(mc.TABLE_OUT) as f:
        ref_x, ref_llh = mc.parse_cells(f)["ect:pair1.mi2"][(SPLIT, ROW)]
    with open(mc.TABLE_JSON) as f:
        entry = json.load(f)["entries"]["ect:pair1.mi2"]
    assert entry["unconverged"] == 0  # the JAX package's whole scenario converged
    np.testing.assert_allclose(ref_x, np.asarray(ref.params)[0, 0], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(ref_llh, np.asarray(ref.llh)[0, 0], rtol=1e-10)
