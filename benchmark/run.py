"""The benchmark of misti_tpu_torch on one card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs the cell named in BENCHMARK.json: sets up (the port's kernels built
into its ``build/`` on first use, the mix's warm-up requests), serves
requests back to back for ``--seconds``, each drawn from the seed as it is
served, and prints as its last line one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``compared``, the numbers the judge compared and
their limits, which are also the last lines on standard error.  Exits nonzero, printing no result,
without a card, when a named file is missing, or when the process holds
JAX or the JAX package once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "benchmark" / "out"
sys.path.insert(0, str(ROOT))  # the judge's worker processes inherit it
os.environ.setdefault("CUDA_CACHE_PATH", str(OUT / "cuda_cache"))


def process_start() -> float:
    """This process's start on the epoch clock, from /proc."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
    return boot + ticks / os.sysconf("SC_CLK_TCK")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    started = process_start()

    import torch

    from benchmark.harness import layout
    from benchmark.harness.cell import Cell, forbidden_modules
    from benchmark.harness.profiling import power_limit

    bench = layout.benchmark()
    chips = layout.cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    cell = Cell(bench, args.workload, args.seed, args.seconds)
    cell.warm_up()
    setup_s = time.time() - started
    cell.run_window()
    peak = torch.cuda.max_memory_allocated()

    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=1,
                  memory_peak_bytes=int(peak), card=power_limit())
    result = {}
    if args.trace:
        metrics, busy_s, window_s, breakdown = cell.traced()
        device.update(busy_s=busy_s, window_s=window_s)
        result["breakdown"] = breakdown
    else:
        values = dict(cell.end_to_end(), setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in layout.end_to_end(bench, args.workload)}
    found = forbidden_modules()
    if found:
        print(f"error: the process holds {found} once the window has closed", file=sys.stderr)
        return 4

    attempted, failed = cell.attempted_failed()
    cell.free()  # the program's state, freed before the reference runs
    torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    correct, compared, read = cell.judge()
    print(f"set-up {setup_s:.3f} s, window {cell.window_s:.3f} s ({attempted} requests), "
          f"judge {time.perf_counter() - t_judge:.3f} s", file=sys.stderr)
    if cell.mix["kind"] == "fit":  # beside the metric: the median sits between two modes
        ms = cell.fit_ms()
        print(f"fits: median {statistics.median(ms):.3f} ms, mean {statistics.mean(ms):.3f} ms",
              file=sys.stderr)
    correct = correct and failed == 0
    OUT.mkdir(parents=True, exist_ok=True)
    with open(OUT / f"{args.workload}.seed{args.seed}.trace{args.trace}.spans.jsonl", "w") as f:
        for r in cell.records:
            f.write(json.dumps(r) + "\n")
    found = forbidden_modules()
    if found:
        print(f"error: the process holds {found}", file=sys.stderr)
        return 4
    print("read beside, not compared: " + ", ".join(f"{k} = {v!r}" for k, v in read.items()),
          file=sys.stderr)
    for k, v in compared.items():
        print(f"compared {k} = {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(json.dumps(dict(correct=bool(correct), attempted=attempted, failed=failed,
                          metrics=metrics, device=device, **result, compared=compared)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
