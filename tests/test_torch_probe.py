"""misti_tpu_torch.probe on the CPU, at a toy size: the width probe's stage
trace and op checks (every lane bitwise the same alone and in its batch, as
the card needs).  On the card it runs at the north-star sweep's full width."""

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
