"""Work of the correction sweep, frozen: `sweep_work` and `sweep_ops` as
``misti_tpu_torch/kernels/correction_fused.py`` had them at commit 4de6f0d,
and `sweep_bytes`.  They count what the function needs on given inputs, by
a metered run of the reference's plain sweep, whatever kernel later
computes it."""

from __future__ import annotations

import math

import torch

from benchmark.reference.correction_sweep import _Work, correction_sweep_plain


# The bound's yardstick: the algorithm's work, counted on the base-6
# evaluation the kernel first had (a design that needs fewer instructions
# reads a higher share of the same bound).
# Operations of the kernel's building blocks (csrc/correction_sweep.cu),
# counting each scalar add, sub, mul, div, exp, log and sqrt as one; a dual
# number op counts its value and both tangent parts (D2*D2 = 7, D2+D2 = 3,
# D2*T = 3).  Per unit of the matching `sweep_work` count.
_OPS = {
    "chain": 669,  # expm3: scaling 21, powers 5 x 45, Horner 423
    "chain_sq": 45,  # one squaring of a 3x3
    "scan_step": 45,  # one Hillis-Steele product, per element
    "pulse": 165,  # pulse matrix (72) + its product (45) + entry states (48)
    "setup": 100,  # per element and round: normalise, merge, targets, closed form
    "cp": 2834,  # dual expm3_m1 (39 + 1215 + 1485) + residual 50 + LM step 45
    "cp_sq": 297,
    "ect": 6013,  # dual nc-moments (39 + 1215 + 3 x 1485 + 55) + residual 204 + LM 45
    "ect_sq": 946,
    "nomig": 409,  # dual series residual 364 + LM step 45
}


def sweep_work(inp: torch.Tensor, **opts) -> dict:
    """Counts of what a thread per (interval, lane) computes on this input
    (chain expms and their squarings, residual evaluations of unconverged
    lanes and their squarings), from a metered run of the plain version."""
    work = _Work()
    correction_sweep_plain(inp, work=work, **opts)
    return work.n


def sweep_ops(work: dict, s: int, B: int, *, has_pulse: bool, rounds: int = 2,
              **_) -> float:
    """Arithmetic operations of the sweep for `sweep_work` counts."""
    chains = work.get("chain", 0.0)
    ops = chains * (_OPS["chain"] + _OPS["scan_step"] * max(0, math.ceil(math.log2(s))))
    if has_pulse:
        ops += chains * _OPS["pulse"]
    ops += rounds * s * B * _OPS["setup"]
    for key in ("chain_sq", "cp", "cp_sq", "ect", "ect_sq", "nomig"):
        ops += work.get(key, 0.0) * _OPS[key]
    return ops


def sweep_bytes(s: int, B: int, itemsize: int = 8) -> int:
    """Bytes a call must move: the (7, s, B) input read once and the
    (8, s, B) output written once."""
    return 15 * s * B * itemsize
