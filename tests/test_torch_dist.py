"""Replicate sharding in the port (misti_tpu_torch.dist.mesh, the sharded
stages of misti_tpu_torch.engine.bootstrap): gloo process groups of 2 and 3
CPU processes, float64, as tests/test_distributed.py and
tests/test_bootstrap_dist.py exercise the JAX package's mesh.

A sharded sweep must give every rank the same table, bitwise equal to the
one-process sweep: on the CPU a lane's value does not depend on its batch
(tests/test_torch_sweep.py), so splitting the cells over ranks, padding
them and all-gathering the results changes no bit.  The sweep is the toy
grid's (12 intervals, splits 4 and 7, 5 rows: 10 cells, no multiple of 3)
with stage caps 18 22 28, so stage 3 resumes 5 of the 10 cells and stage 4
one: a stage where ranks hold only padding still enters every gather.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_dist_worker as worker
from misti_tpu_torch.dist.mesh import all_gather_rows, pad_to_multiple, row_block
from _torch_sweep_cases import one_torch_thread  # noqa: F401 (autouse fixture)

HERE = os.path.dirname(os.path.abspath(__file__))
KEYS = ("llh", "params", "nfev", "converged", "calls")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("arr", [torch.arange(15, dtype=torch.int64).reshape(5, 3, 1),
                                 torch.arange(15.0, dtype=torch.float64).reshape(5, 3)],
                         ids=["int64", "float64"])
def test_pad_to_multiple(arr):
    padded, orig = pad_to_multiple(arr, 4, fill=1.0)
    assert orig == 5 and tuple(padded.shape) == (8, *arr.shape[1:])
    assert padded.dtype == arr.dtype
    assert torch.equal(padded[:5], arr)
    assert (padded[5:] == 1).all()
    same, orig = pad_to_multiple(arr, 5)
    assert same is arr and orig == 5


def test_row_blocks_tile_the_rows():
    for world in (1, 2, 3):
        rows = sorted(i for r in range(world) for i in range(12)[row_block(12, world, r)])
        assert rows == list(range(12))
        assert len({row_block(12, world, r).stop - row_block(12, world, r).start
                    for r in range(world)}) == 1
    with pytest.raises(ValueError):
        row_block(10, 3, 0)


def test_gather_without_a_group_is_the_rows():
    t = torch.arange(6).reshape(3, 2)
    assert torch.equal(all_gather_rows(t, None, 2), t[:2])


def test_toy_is_the_jax_tests_grid():
    from test_sweep_fused import _toy

    assert worker.toy() == _toy()


def _start_group(tmp_path, world):
    coordinator = f"127.0.0.1:{_free_port()}"
    outs = [str(tmp_path / f"rank{world}_{r}.npz") for r in range(world)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "_torch_dist_worker.py"),
                               coordinator, str(world), str(r), outs[r]], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    return procs, outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2- and 3-rank groups, started together, and meanwhile the
    one-process port sweeps (fused with compaction, and per split).  A
    rank's failure is reported by the test of its group."""
    tmp = tmp_path_factory.mktemp("dist")
    groups = {world: _start_group(tmp, world) for world in (2, 3)}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = {"fused": worker.run_fused(), "per_split": worker.run_per_split()}
        done = {}
        for world, (procs, outs) in groups.items():
            logs = [p.communicate(timeout=240) + (p.returncode,) for p in procs]
            done[world] = (logs, outs)
    finally:
        torch.set_num_threads(n)
        for procs, _ in groups.values():
            for p in procs:
                p.kill()
    return single, done


def _group(runs, world):
    logs, outs = runs[1][world]
    for stdout, stderr, rc in logs:
        assert rc == 0, f"rank failed:\n{stdout}\n{stderr}"
    return [np.load(o) for o in outs]


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_sweep_is_bitwise_the_single_process_sweep(runs, world):
    single, ranks = runs[0], _group(runs, world)
    for r, z in enumerate(ranks):
        # a rank given other spectra fails, on every rank, before any stage
        assert "different replicate spectra" in str(z["mismatch"]), (r, z["mismatch"])
        for path in ("fused", "per_split"):
            want = single[path]
            for key in KEYS:
                np.testing.assert_array_equal(z[f"{path}_{key}"], getattr(want, key),
                                              err_msg=f"rank {r} {path} {key}")
            # every rank made objective calls; the busiest made all of one process's
            assert want.calls < int(z[f"{path}_calls_sum"]) <= world * want.calls
    lines = [str(z["stage_lines"]).splitlines() for z in ranks]
    assert all(not ln for ln in lines[1:])  # stage lines from rank 0 only
    assert [ln.split(":")[0] for ln in lines[0]] == [f"# sweep stage {k}/4" for k in (1, 2, 3, 4)]
    assert [ln.split(": ")[1].split(" resumed")[0] for ln in lines[0][1:]] == [
        "10 cells", "5 cells", "1 cells"]
