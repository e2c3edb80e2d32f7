"""Fused bootstrap x split-time sweep: the split time as a per-lane index.

Every per-split quantity (padded interval tables, category masks, smoothing
matrices, parameter masks) is built once on the host, stacked over the split
axis, and gathered per lane by its split index, so cells of every split time
evaluate together in one batch.  Padding uses zero-length intervals, which are
exact no-ops through the whole pipeline:

* the correction kernel pins lc = 1 on a T == 0 row, and its chain step is
  expm(0) = I;
* the 44-state spectrum's sub-step there is expm(M*0) = I with occupancy 0,
  and pulse operators at rate 0 are the identity;
* the post-split fit treats T == 0 as `lc = 1, nc unchanged` (the
  reference's own rule, MigrationInference.py:357-359).

So a (split s, replicate b, params) cell evaluates as the per-split
likelihood does (engine/likelihood.py), and the whole grid is one lockstep
Nelder-Mead.  The pre-split correction is `fused_correction` with per-lane
``lh`` (B, s_max, 2) and ``times`` (B, s_max): the hand-written CUDA kernel on
the card, its plain torch version on the CPU.  The stages after it are the
per-split likelihood's own, fed per-lane tables.

With ``correct=False`` (trueEPS) the carry into the post-split fit holds
the pulses only, as the per-split likelihood's does; the JAX package's grid
sweep also runs the correction chain at the uncorrected rates there, which
moves the llh by ~2.6e-4 nats off the per-split path on its tests' toy grid.

Not ported from the JAX package, and why:

* the ``correction_mode`` switch (``scan``, ``fused-xla``,
  ``fused-interpret``): the port has one correction route per device, the
  kernel on the card and its plain version on the CPU;
* ``MISTI_SPECTRUM=matrix``: the materialised-expm spectrum existed for
  XLA's sake; the port keeps the vector path only;
* the AOT ``scenario_key``: there is no traced program to export.
  ``shape_key`` is a local hash of the static structure.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Sequence

import numpy as np
import torch

from ..config import LLH_DTYPE, resolve_device, resolve_dtype
from ..kernels.correction_fused import fused_correction, sweep_inputs
from ..kernels.spectrum import pack_spectrum
from ..spans import count, span
from .likelihood import (
    SpectrumBasis,
    _pulse_update_3state,
    hand_launches,
    jafs_spectrum,
    last_rate,
    multinomial_const,
    multinomial_llh,
    post_split_fit,
    smooth_rates,
)
from .spec import build_spec

_BOOL_TABLES = ("pad_pre", "is_sample")


@dataclasses.dataclass
class FusedSweep:
    split_times: np.ndarray  # (S,)
    n_params: int
    init_params: np.ndarray
    device: torch.device
    dtype: torch.dtype  # the parameters'; the llh computes in LLH_DTYPE
    llh: callable  # (st_idx (B,), params (B, n), data7 (B, 7)) -> (B,) llh
    tables: dict  # the stacked per-split tables (host numpy)
    shape_key: str  # a hash of the static structure (grid sizes and flags)
    # (st_idx, params) -> the correction kernel's (7, s_max, B) input, and
    # the kernel's options: for holding the kernel against its plain version
    # at the sweep's shapes
    kernel_input: callable = None
    kernel_opts: dict = None
    # (st_idx, params) -> (basis, args): the spectrum kernel's constant
    # tables and its packed arguments (kernels/spectrum.py `SpectrumArgs`)
    # for these lanes, for replaying the kernel alone
    spectrum_input: callable = None


def _device_tables(tables: dict, device, dtype) -> dict:
    """The host tables as tensors on the device: bool masks stay bool,
    ``s_of`` int64, the rest ``dtype``."""
    out = {}
    for k, v in tables.items():
        if k in _BOOL_TABLES:
            out[k] = torch.as_tensor(np.asarray(v, bool), device=device)
        elif k == "s_of":
            out[k] = torch.as_tensor(np.asarray(v, np.int64), device=device)
        else:
            out[k] = torch.as_tensor(np.asarray(v, float), dtype=dtype, device=device)
    return out


def _shape_key(*parts) -> str:
    return hashlib.sha256(repr(parts).encode()).hexdigest()[:16]


def build_fused_sweep(
    times: Sequence[float],
    lambdas,
    split_times: Sequence[float],
    mi_template=(),
    pu_template=(),
    *,
    sample_date: int = 0,
    correct: bool = True,
    cpfit: bool = False,
    smooth: bool = True,
    unfolded: bool = False,
    mixture_th: float = 0.0,
    device=None,
    dtype=None,
) -> FusedSweep:
    """Build the fused sweep's tables and its batched likelihood.

    ``mi_template`` rows may use "ST" for start/end to mean the (floor of
    the) split index (the test.bs convention).  Split times may be
    fractional: each split's spec pre-splits its containing interval on the
    host (the same preprocessing as build_spec / the reference
    MigrationInference.py:89-99), so lanes carry different tables.
    ``device`` defaults to CUDA (raising without a card); ``dtype``, the
    parameters' (rounded to it on the way in), to float64 on every device.
    Every stage computes in LLH_DTYPE and the llh comes back in it.
    """
    dev = resolve_device(device)
    dt = resolve_dtype(dev, dtype)
    ct = LLH_DTYPE
    splits = [float(v) for v in split_times]

    # per-split specs (host side; also validates the model per split).
    # "ST" means floor(st): textual substitution happens before the
    # fractional interval insert, exactly like the reference shell scripts.
    specs = []
    for st in splits:
        st_i = int(st)
        mi = [[int(r[0]), st_i if r[1] == "ST" else int(r[1]),
               st_i if r[2] == "ST" else int(r[2]), float(r[3]), int(r[4])]
              for r in mi_template]
        pu = [[int(r[0]), st_i if r[1] == "ST" else int(r[1]), float(r[2]),
               int(r[3])] for r in pu_template]
        specs.append(
            build_spec(
                list(times), [list(v) for v in lambdas], [0.0] + [1.0] * 7,
                st, mi, pu, correct=correct, cpfit=cpfit, smooth=smooth,
                unfolded=unfolded, sample_date=sample_date,
                mixture_th=mixture_th,
            )
        )
    n_par = specs[0].n_params
    # post-fractional-split grid sizes (splitT/numT grow by 1 when st % 1)
    s_of = [sp.splitT for sp in specs]
    s_max = max(s_of)
    n_post = max(sp.numT - 1 - sp.splitT for sp in specs)
    sd = int(sample_date)

    # stacked per-split tables, padded to (s_max / n_post); each spec
    # carries its own grid (fractional splits insert an interval)
    S = len(splits)
    t_pre = np.zeros((S, s_max))
    lh_pre = np.ones((S, s_max, 2))
    pad_pre = np.ones((S, s_max), dtype=bool)
    t_post = np.zeros((S, n_post))
    lh_post = np.ones((S, n_post, 2))
    catmask = np.ones((S, s_max, 7))
    is_sample = np.zeros((S, s_max), dtype=bool)
    mi_base = np.zeros((S, s_max, 2))
    pu_base = np.zeros((S, s_max, 2))
    mi_masks = np.zeros((S, max(n_par, 1), s_max, 2))
    lh_last = np.ones((S, 2))
    for i, sp in enumerate(specs):
        st = sp.splitT
        all_t = np.asarray(sp.times)
        all_lh = np.asarray(sp.lh)
        t_pre[i, :st] = all_t[:st]
        lh_pre[i, :st] = all_lh[:st]
        pad_pre[i, :st] = False
        npost_i = sp.numT - 1 - st
        t_post[i, :npost_i] = all_t[st : sp.numT - 1]
        lh_post[i, :npost_i] = all_lh[st : sp.numT - 1]
        catmask[i, :st] = 1.0
        catmask[i, :sd, 2:] = 0.0
        if sd < st:
            is_sample[i, sd] = True
        mi_base[i, :st] = sp.mi_base[:st]
        # pulses at t >= split are never applied by the reference (its loops
        # stop at splitT); only pre-split rows are stacked
        pu_base[i, :st] = sp.pu_base[:st]
        for k in range(len(sp.opt_mi)):
            mi_masks[i, k, :st] = sp.mi_masks[k][:st]
        for k in range(len(sp.opt_pu)):
            mi_masks[i, len(sp.opt_mi) + k, :st] = sp.pu_masks[k][:st]
        lh_last[i] = all_lh[sp.numT - 1]

    tables_np = dict(
        t_pre=t_pre, lh_pre=lh_pre, pad_pre=pad_pre, t_post=t_post,
        lh_post=lh_post, catmask=catmask, is_sample=is_sample,
        mi_base=mi_base, pu_base=pu_base, mi_masks=mi_masks,
        lh_last=lh_last, s_of=np.asarray(s_of, np.int32),
    )
    if smooth:
        smooth_ws = np.zeros((S, 2, s_max, s_max))
        for i, (st, sp) in enumerate(zip(s_of, specs)):
            smooth_ws[i, :, :st, :st] = sp.smooth_w
            # identity on padding so padded lc rows pass through
            for g in range(2):
                for k in range(st, s_max):
                    smooth_ws[i, g, k, k] = 1.0
        tables_np["smooth_w"] = smooth_ws

    n_opt_mi = len(specs[0].opt_mi)
    static_no_mig = n_opt_mi == 0 and bool(np.all(mi_base == 0))
    has_pulse = bool(pu_template) or bool(np.any(pu_base != 0))
    corr_opts = dict(cpfit=cpfit, mixture_th=float(mixture_th),
                     static_no_mig=static_no_mig, has_pulse=has_pulse)
    # host structure the spectrum loops branch on: pulses that may be
    # nonzero, rows where some split's ancient sample enters, a rebase at
    # the split (each lane then selects by its own table)
    pulse_site = (pu_base != 0).any(0) | (mi_masks[:, n_opt_mi:] != 0).any((0, 1))
    n_sites = int(pulse_site.sum())
    sample_rows = tuple(int(t) for t in np.flatnonzero(is_sample.any(0)))
    rebase_any = bool(np.any(np.asarray(s_of) == sd))
    tables = _device_tables(tables_np, dev, ct)
    basis = SpectrumBasis(dev, ct)
    p_start = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], dtype=ct, device=dev)

    def carry_no_corr(pu_pre):
        """trueEPS carry: the pulses only, as the per-split likelihood carries
        it (engine/likelihood.py `correct`, upstream's formulas); a pulse
        site that is statically zero is the identity and is skipped."""
        p = p_start.expand(pu_pre.shape[0], 2, 3)
        for t in range(s_max):
            for pop in (0, 1):
                if pulse_site[t, pop]:
                    p = _pulse_update_3state(p, pu_pre[:, t, pop], pop)
        return p

    def lanes(st_idx, params):
        """Each lane's split index and parameters on the device, its table
        gather, and its pre-split tables: T (B, s_max), lh, and the mapped
        migration and pulse rates (B, s_max, 2)."""
        st_idx = torch.as_tensor(st_idx, device=dev).to(torch.int64).reshape(-1)
        B = st_idx.shape[0]
        params = torch.as_tensor(params).to(device=dev, dtype=dt).to(ct).reshape(B, n_par)

        def take(name):
            return tables[name].index_select(0, st_idx)

        tp = take("t_pre")  # (B, s_max)
        lhp = take("lh_pre")  # (B, s_max, 2)
        mib = take("mi_base")  # (B, s_max, 2): pre-split rows only
        pub = take("pu_base")

        # parameter mapping (MapParameters, MigrationInference.py:291-298)
        if n_par:
            masks = take("mi_masks")  # (B, n_par, s_max, 2)

            def mapped(base, lo, hi):
                keep = 1.0 - torch.clamp(masks[:, lo:hi].sum(1), max=1.0)
                val = params[:, lo, None, None] * masks[:, lo]
                for k in range(lo + 1, hi):
                    val = val + params[:, k, None, None] * masks[:, k]
                return base * keep + val

            if n_opt_mi:
                mib = mapped(mib, 0, n_opt_mi)
            if n_par > n_opt_mi:
                pub = mapped(pub, n_opt_mi, n_par)
        return params, take, tp, lhp, mib, pub

    def kernel_input(st_idx, params):
        """The correction kernel's (7, s_max, B) input for these lanes."""
        _, _, tp, lhp, mib, pub = lanes(st_idx, params)
        return sweep_inputs(mib, pub, lhp, tp)

    def llh_fn(st_idx, params, data7):
        with span("llh") as sp:
            launched = hand_launches() if sp else 0
            llh = _llh(st_idx, params, data7)
            if sp:
                sp.set(lanes=llh.shape[0], hand_launches=hand_launches() - launched)
        return llh

    def _to_spectrum(st_idx, params):
        """The stages before the spectrum: (params, validity, the table
        gather, the spectrum's per-lane inputs)."""
        with span("llh.lanes"):
            params, take, tp, lhp, mib, pub = lanes(st_idx, params)
            B = params.shape[0]
            nonneg = (params >= 0).all(-1)

        # pre-split correction sweep: the kernel, per-lane tables
        with span("llh.correct") as sp:
            if correct:
                lc_pre, p_after = fused_correction(mib, pub, lhp, tp, **corr_opts)
                nc = p_after[:, -1].sum(-1)  # padding rows after the split are no-ops
                ok = torch.where(take("pad_pre")[..., None], torch.ones_like(lc_pre), lc_pre)
                valid = (ok > 0).all(-1).all(-1)
                sp.set(pulse=has_pulse)
                if has_pulse:
                    count("correction.pulse_rows", B * s_max)
            else:
                lc_pre = lhp
                nc = carry_no_corr(pub).sum(-1)
                valid = torch.ones(B, dtype=torch.bool, device=dev)

        with span("llh.post_split"):
            tq = take("t_post")
            lc_post, nc_fin = post_split_fit(nc, take("lh_post"), tq, cpfit=cpfit)
            lam_last = last_rate(nc_fin, take("lh_last"))
            if smooth:
                lc_pre = smooth_rates(lc_pre, take("smooth_w"))
            lc = torch.cat([lc_pre, lc_post, torch.stack([lam_last, lam_last], dim=-1)[:, None]],
                           dim=1)

        return params, nonneg & valid, take, (lc, mib, pub, tp, tq)

    def spectrum_args(take, lc, mib, pub, tp, tq):
        """`jafs_spectrum`'s arguments for the lanes of ``take``."""
        is_s = take("is_sample")
        sample_at = [is_s[:, t] if t in sample_rows else None for t in range(s_max)]
        rebase = (take("s_of") == sd) if rebase_any else None
        return (basis, lc, mib, pub, tp, tq, take("catmask"), sample_at, rebase, pulse_site)

    def _llh(st_idx, params, data7):
        params, valid, take, per_lane = _to_spectrum(st_idx, params)
        B = params.shape[0]
        with span("llh.spectrum", pulse_sites=n_sites):
            if n_sites:
                count("spectrum.pulse_ops", B * n_sites)
            jafs_raw = jafs_spectrum(*spectrum_args(take, *per_lane))
        with span("llh.multinomial"):
            data7 = torch.as_tensor(data7).to(device=dev, dtype=ct).reshape(B, 7)
            llh, _, pos = multinomial_llh(jafs_raw, data7, multinomial_const(data7, unfolded),
                                          unfolded)
            return torch.where(valid & pos, llh, torch.full_like(llh, -float("inf")))

    def spectrum_input(st_idx, params):
        """The spectrum kernel's (basis, packed arguments) for these lanes."""
        _, _, take, per_lane = _to_spectrum(st_idx, params)
        return basis, pack_spectrum(*spectrum_args(take, *per_lane))

    shape_key = _shape_key(
        "fused-sweep-torch-v1", S, s_max, n_post, n_par, n_opt_mi, sd, bool(correct),
        bool(cpfit), bool(smooth), bool(unfolded), float(mixture_th), static_no_mig,
        has_pulse, pulse_site.tobytes(), sample_rows, rebase_any, str(dev), str(dt),
    )
    return FusedSweep(
        split_times=np.asarray(splits, float), n_params=n_par,
        init_params=specs[0].init_params, device=dev, dtype=dt, llh=llh_fn,
        tables=tables_np, shape_key=shape_key, kernel_input=kernel_input,
        kernel_opts=corr_opts, spectrum_input=spectrum_input,
    )
