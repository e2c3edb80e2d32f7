"""Forward direction: true EPS -> PSMC-style mixed coalescence rates.

Counterpart of MigrationInference.CoalescentRates (reference
MigrationInference.py:542-564), used by the TestModel flow to write .mi
files from an exactly-known demography.

Note: the reference builds the 3-state generator with whatever migration
rates were *last* set on its CorrectLambda singleton (SetMu is never called
inside CoalescentRates), i.e. the last pre-split interval's rates leak into
every interval.  As the JAX package does, this follows the evident intent
instead: each interval uses its own migration rates.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device, resolve_dtype
from ..kernels.correction import coal_rates
from .likelihood import _pulse_update_3state
from .spec import ModelSpec


def coalescent_rates(spec: ModelSpec, mi=None, pu=None, *, device=None, dtype=None):
    """Return numpy (lh_mixed (numT, 2), pr (splitT+1, 3, 2)).

    ``mi`` and ``pu`` (numT, 2) default to the spec's fixed tables.
    lh_mixed: pre-split rows are the forward-computed mixed rates; post-split
    rows keep the spec's input rates (the reference's post-split averaging
    loop, :563-564, has an empty range and never runs).  ``device`` defaults
    to CUDA (raising without a card), ``dtype`` to the device's default.
    """
    dev = resolve_device(device)
    dt = resolve_dtype(dev, dtype)

    def tens(a):
        a = a if torch.is_tensor(a) else np.asarray(a, dtype=float)
        return torch.as_tensor(a).to(device=dev, dtype=dt)

    s = spec.splitT
    mi = tens(spec.mi_base if mi is None else mi)
    pu = tens(spec.pu_base if pu is None else pu)
    lc = tens(spec.lh)
    times = tens(spec.times)

    # one lane: the pre-split chain is sequential in the state
    p0 = torch.tensor([[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]], dtype=dt, device=dev)
    p = p0
    lh_pre, pr_head, pr_tail = [], [], []
    for t in range(s):
        p = _pulse_update_3state(p, pu[t:t + 1, 0], 0)
        p = _pulse_update_3state(p, pu[t:t + 1, 1], 1)
        pr_head.append(p[0].T)
        lh_t, p = coal_rates(lc[t:t + 1], mi[t:t + 1], times[t:t + 1], p)
        lh_pre.append(lh_t[0])
        pr_tail.append(p[0].T)
    # reference Pr: the post-pulse initial state at t == 0, then the state
    # after each interval (:558-562)
    pr = torch.stack([pr_head[0] if s > 0 else p0[0].T, *pr_tail])
    lh = torch.cat([torch.stack(lh_pre), lc[s:]]) if s > 0 else lc
    return lh.cpu().numpy(), pr.cpu().numpy()
