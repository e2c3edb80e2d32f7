"""Readings for the judge's limits: the program's numbers over many seeds
and the control's, at a cell's own size, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 7 8 9 --requests 2 --out <file.json>

Each seed serves ``--requests`` requests of the cell's traffic as a run's
window does and judges them as a run does.  The control is the program with
its own lower-precision path switched on: float32 parameters and simplex
(``dtype=torch.float32``; the likelihood stays float64, the only precision
the port's kernels take).  One JSON line per seed goes to standard output
and all of them to ``--out``.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--requests", type=int, default=2)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    import torch

    from benchmark.harness import layout
    from benchmark.harness.cell import Cell

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 3
    bench = layout.benchmark()
    lines, warm = [], True
    for side, seeds, dtype in (("program", args.seeds, None),
                               ("control", args.control_seeds, torch.float32)):
        for seed in seeds:
            t0 = time.perf_counter()
            cell = Cell(bench, args.workload, seed, 0.0, dtype=dtype)
            if warm:
                cell.warm_up()
                warm = False
            cell.run_window(requests=args.requests)
            e2e = cell.end_to_end()
            cell.free()
            correct, compared, read = cell.judge()
            line = dict(workload=args.workload, side=side, seed=seed, correct=correct,
                        numbers={**{k: v["value"] for k, v in compared.items()}, **read},
                        end_to_end=e2e,
                        seconds=time.perf_counter() - t0)
            print(json.dumps(line), flush=True)
            lines.append(line)
            torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
