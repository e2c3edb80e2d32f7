"""The benchmark's own rebuild of a sweep's first objective call, and the
work its correction sweep and its 44-state spectrum intervals need.

The first call of a sweep evaluates every cell's initial simplex at the
configuration's start: W = splits x spectra rows cells, n + 1 points each,
in the fused sweep's layout (each lane's pre-split intervals, then
zero-length rows up to the longest split).  A lane's correction input and
spectrum rates do not depend on its spectrum, so the work is counted on one
lane per (split, point) and multiplied by the rows.  Everything here comes
from the reference and the configuration's raw files.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.fit import flags, templates
from benchmark.reference.likelihood import SpectrumBasis, build_llh
from benchmark.reference.optimize import _initial_simplex
from benchmark.reference.readers import read_psmc
from benchmark.reference.spec import build_spec
from benchmark.roofline import correction, expm_action
from benchmark.roofline.peaks import bound_s


def lanes(config: dict):
    """(correction input (7, s_max, S (n + 1)), its options, the pre-split
    spectrum rates (S (n + 1), s_max, 4), their interval lengths
    (S (n + 1), s_max)) of one row's lanes."""
    times, lambdas, _ = read_psmc(config["paths"]["psmc1"], config["paths"]["psmc2"])
    splits = np.arange(config["splits"][0], config["splits"][1] + 1, dtype=float)
    specs = [build_spec(times, lambdas, [0.0] + [1.0] * 7, st, *templates(config, st),
                        **flags(config)) for st in splits]
    s_max = max(sp.splitT for sp in specs)
    points = _initial_simplex(torch.as_tensor(specs[0].init_params[None]))[0]
    P = points.shape[0]
    inp = torch.zeros((7, s_max, len(specs) * P), dtype=torch.float64)
    inp[1:3] = 1.0  # lh of the zero-length rows
    coeffs = torch.zeros((len(specs) * P, s_max, 4), dtype=torch.float64)
    coeffs[:, :, :2] = 1.0  # lc of the zero-length rows
    for i, sp in enumerate(specs):
        st, lanes_i = sp.splitT, slice(i * P, (i + 1) * P)
        llh = build_llh(sp)
        mi, pu = llh.map_params(points)
        lc, _ = llh.correct(mi, pu)
        T = torch.as_tensor(sp.times[:st])
        lh = torch.as_tensor(sp.lh[:st])
        for k, v in enumerate((T.expand(P, st), lh[:, 0].expand(P, st), lh[:, 1].expand(P, st),
                               mi[:, :st, 0], mi[:, :st, 1], pu[:, :st, 0], pu[:, :st, 1])):
            inp[k, :st, lanes_i] = v.T
        coeffs[lanes_i, :st] = torch.cat([lc[:, :st], mi[:, :st]], dim=-1)
    n_opt_mi = len(specs[0].opt_mi)
    opts = dict(cpfit=config["cpfit"], mixture_th=0.0,
                static_no_mig=n_opt_mi == 0 and all(
                    bool(np.all(sp.mi_base[:sp.splitT] == 0)) for sp in specs),
                has_pulse=bool(config.get("pu")) or any(
                    bool(np.any(sp.pu_base[:sp.splitT] != 0)) for sp in specs))
    return inp, opts, coeffs, inp[0].T.contiguous()


def correction_bound_s(config: dict, rows: int) -> tuple:
    """(least time of the correction sweep on the first call of a sweep of
    ``rows`` spectra, which bound, its operations, its bytes)."""
    inp, opts, _, _ = lanes(config)
    work = {k: v * rows for k, v in correction.sweep_work(inp, **opts).items()}
    s, B = inp.shape[1], inp.shape[2] * rows
    ops, nbytes = correction.sweep_ops(work, s, B, **opts), correction.sweep_bytes(s, B)
    return (*bound_s(ops, nbytes), ops, nbytes)


def expm_action_k2_bound_s(config: dict, rows: int) -> tuple:
    """(least time of the first call's 44-state spectrum intervals, one
    ``expm_action`` launch each, summed; its operations; its bytes)."""
    _, _, coeffs, T = lanes(config)
    basis = SpectrumBasis(torch.device("cpu"), torch.float64)
    B = coeffs.shape[0] * rows
    total = ops_all = bytes_all = 0.0
    for t in range(coeffs.shape[1]):
        ops = rows * expm_action.expm_action_ops(basis.sp2, coeffs[:, t], basis.norms2,
                                                 T[:, t], Q=7)
        nbytes = expm_action.expm_action_bytes(B, basis.sp2, itemsize=8, per_lane_t=True, Q=7,
                                               per_lane_catmask=True)
        total += bound_s(ops, nbytes)[0]
        ops_all, bytes_all = ops_all + ops, bytes_all + nbytes
    return total, ops_all, bytes_all
