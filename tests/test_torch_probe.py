"""misti_tpu_torch.probe on the CPU, at a toy size: the width probe's stage
trace and op checks (every lane bitwise the same alone and in its batch, as
the card needs), and the mix probe's counts of how the post-split fit's
solves split the kernel's warps.  On the card they run at the north-star
sweep's full width."""

import json

import torch

from misti_tpu_torch import probe


def test_width_probe_finds_no_batch_dependence_on_the_cpu(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(probe, "REPLICATES", 1)  # 8 splits x 2 rows x 6 points = 96 lanes
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        assert probe.main(["width", "--device", "cpu", "--cell", "3",
                           "--out", str(tmp_path / "w.txt")]) == 0
    finally:
        torch.set_num_threads(n)
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    width = [r for r in rows if r["probe"] == "width"]
    assert [r["mode"] for r in width] == ["cpfit", "ect"]
    for r in width:
        assert r["lanes"] == 96 and r["stages_compared"] > 60
        assert r["first_stage_that_differs"] is None and r["max_abs_dllh"] == 0.0
    ops = {(r["mode"], r["op"]): r for r in rows if r["probe"] == "width-op"}
    for mode in ("cpfit", "ect"):
        for op in ("matvec k2 row_matmul kernel", "smooth_rates (product, sum over the last axis)",
                   "_sum_in_order of 27 (B,7)", "post_split_fit", "correction kernel"):
            assert "error" not in ops[(mode, op)] and all(ops[(mode, op)]["bitwise"].values())
    assert (tmp_path / "w.txt").read_text().splitlines()[0] == "cpu"


def test_mix_probe_counts_the_warps_and_the_skipped_work(monkeypatch, tmp_path, capsys):
    """The sweep's first ECT call (1 replicate: 8 splits x 2 rows x 2
    vertices = 32 lanes), the bench's (4096 lanes) and the single fit's:
    lane-major warps mix the residual's forms in no more warps than the PR 9
    mapping, none on the bench's series-only shared table; rounds 2-6
    repeat some prefixes, and the bisection stops before its 60th halving
    on average."""
    monkeypatch.setattr(probe, "REPLICATES", 1)
    # the plain ECT fits of 4096 lanes: one intra-op thread, as beside the
    # other test workers more threads take minutes where one takes seconds
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert probe.main(["mix", "--device", "cpu", "--out", str(tmp_path / "m.txt")]) == 0
    finally:
        torch.set_num_threads(threads)
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert [r["input"] for r in rows] == ["sweep, first ECT call", "bench, ECT",
                                          "single fit, ECT"]
    assert [r["lanes"] for r in rows] == [32, 4096, 2] and rows[1]["G"] == 1
    for r in rows:
        assert r["lane"]["mixed_forms"] <= r["old"]["mixed_forms"]
        assert 0 < r["work"]["repeated_prefix_share"] < 1 and r["work"]["halvings_mean"] < 60
    assert rows[1]["old"]["mixed_forms"] == rows[1]["lane"]["mixed_forms"] == 0.0
    assert rows[0]["old"]["zero_rows"] > 0 and rows[0]["tables"] == "per lane"


def test_same_bits_tells_signed_zeros_and_infinities_apart():
    """The width probe's lane check compares bits: -0 is not +0, inf is not
    the largest double, NaN masks must match, and dtypes and shapes too."""
    x = torch.tensor([0.0, 1.5, float("inf"), float("nan")], dtype=torch.float64)
    assert probe.same_bits(x, x.clone())
    assert not probe.same_bits(x, torch.tensor([-0.0, 1.5, float("inf"), float("nan")],
                                               dtype=torch.float64))
    big = torch.finfo(torch.float64).max
    assert not probe.same_bits(x, torch.tensor([0.0, 1.5, big, float("nan")],
                                               dtype=torch.float64))
    assert not probe.same_bits(x, torch.tensor([0.0, 1.5, float("inf"), 0.0],
                                               dtype=torch.float64))
    assert not probe.same_bits(x, x.float())
    assert not probe.same_bits(x, x[:3])
    n = torch.arange(4)
    assert probe.same_bits(n, n.clone()) and not probe.same_bits(n, n.flip(0))
    assert probe._diff(x, x.clone()) == (True, 0.0)
