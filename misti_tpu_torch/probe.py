"""Probes of the port on one card.

    python -m misti_tpu_torch.probe width [--cell C] [--out FILE]
    python -m misti_tpu_torch.probe host [--out FILE]
    python -m misti_tpu_torch.probe mix [--device cpu] [--out FILE]

The north-star sweep is upstream's test.bs command on the repo's fixtures
(tests/fixtures/sweep*.psmc + sweep.jsfs, ``--splits 20 27 -bs 100 -mi 1 4
ST 3 1 -uf``, bootstrap seed 0; 808 cells), as the card runs it: float32
parameters, a float64 likelihood.

``width`` asks whether a lane's value depends on the batch it is evaluated
in.  It takes the sweep's first Nelder-Mead iteration (808 cells x
6 trial points = 4848 lanes) and one cell's 6 lanes, and

* evaluates the 6 lanes alone and inside the 4848-lane batch, records every
  stage's output in both runs (the mapped kernel input, the correction
  kernel, the post-split fit (its kernel on the card, its root solves on
  the CPU), the last rate,
  the smoothing, each interval's ``expm_action_pair_plain`` and the last
  interval's solve (on the CPU; on the card the spectrum is one kernel
  launch and makes neither call), the spectrum, the llh) and compares them
  on those lanes, bitwise and by the largest difference; cpfit and ECT;
* evaluates each batched operation of those stages on the batch's own
  inputs, over the whole batch and over sub-batches of 6, 42 and 960 lanes,
  and says which give a lane another value in a narrower batch: among them
  the one-launch spectrum, and the per-interval path's operations on the
  inputs of its first interval calls (on the card replayed through
  `jafs_spectrum_plain`, the spectrum's plain version).

``host`` splits the host time per call of the one-launch spectrum's
wrapper (`spectrum_kernel`, 27 + 27 intervals of per-lane tables, and the
packing of its inputs, `pack_spectrum`), of the per-interval path's hand
kernel's wrapper (`row_matmul` at the collapse map) and of the post-split
fit's (`post_fit`, cpfit, 33 intervals of per-lane tables), at the sweep's 4848
lanes, into its steps, each timed alone with the host clock over 200 calls
and no synchronise: the whole wrapper, the ctypes call that launches the
kernel (arguments made beforehand), the output allocations and the stream
lookup; and the same for ``torch.matmul`` of the collapse product.

``mix`` asks how the post-split fit's ECT root solves split the kernel's
warps.  It captures the first post-split fit of the north-star ECT sweep
(the sweep CLI; 808 cells x 2 simplex vertices = 1616 lanes, per-lane
tables), of the bench's ECT batch (4096 lanes, one shared table) and of the
north-star ECT single fit at split 24 (row 0), and prints for each
`kernels/post_fit.py` `warp_branch_mix` under the PR 9 kernel's mapping
("old") and the lane-major one at the G the kernel takes there ("lane"):
the share of warps that hold both forms of the residual, and T == 0 rows
beside live ones; and what the kernel's two shortcuts skip there (the
share of rounds 2-6's solves whose prefix repeats the last round's, bit for
bit, and the mean halvings a solve evaluates before its bracket stops
moving).  It counts rows with the plain version, so ``--device cpu`` gives
the card's numbers up to the roots' last bits.

Prints JSON lines and the card's name and power limit; ``--out`` also
writes them to a file.  Needs a card, but for ``--device cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .config import LLH_DTYPE
from .engine import likelihood as lk
from .engine import sweep_fused as sf
from .engine.bootstrap import _lane_objective, make_bootstrap_data
from .engine.optimize import nelder_mead
from .io import jsfs as io_jsfs
from .io import psmc as io_psmc
from .kernels import correction as kc
from .kernels import correction_fused as cf
from .kernels.row_matmul import row_matmul, row_matmul_plain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLITS = [float(v) for v in range(20, 28)]
MI = [["1", "4", "ST", "3", "1"]]
REPLICATES = 100
SUB_WIDTHS = (6, 42, 960)


def north_star(device, dtype, cpfit: bool):
    """(psmc input, replicate spectra (101, 7), fused sweep) of the north-star
    command."""
    fix = os.path.join(REPO, "tests", "fixtures")
    inp = io_psmc.read_psmc(os.path.join(fix, "sweep1.psmc"), os.path.join(fix, "sweep2.psmc"),
                            0, -1)
    data = make_bootstrap_data(io_jsfs.read_jafs(os.path.join(fix, "sweep.jsfs")), REPLICATES,
                               seed=0)
    fs = sf.build_fused_sweep(inp.times, inp.lambdas, SPLITS, MI,
                              sample_date=inp.sample_date_discr, unfolded=True, smooth=True,
                              cpfit=cpfit, device=device, dtype=dtype)
    return inp, data, fs


def first_iteration_lanes(fs, data):
    """The lanes of the sweep's first Nelder-Mead iteration over every cell:
    (split index (B,), parameters (B, n), data rows (B, 7)), cell-major."""
    dev, dt = fs.device, fs.dtype
    n_cells = len(SPLITS) * data.shape[0]
    st = torch.arange(len(SPLITS), device=dev).repeat_interleave(data.shape[0])
    d = torch.as_tensor(np.tile(data, (len(SPLITS), 1)), dtype=dt, device=dev)
    x0 = torch.as_tensor(np.tile(fs.init_params, (n_cells, 1)), dtype=dt, device=dev)
    seen = []
    f = _lane_objective(fs.llh, st, d, [0])

    def obj(points):
        seen.append(points)
        return f(points)

    nelder_mead(obj, x0, maxiter=1)
    W, P, n = seen[1].shape
    return st.repeat_interleave(P), seen[1].reshape(W * P, n), d.repeat_interleave(P, dim=0)


class _Trace:
    """Records the stage outputs of one `FusedSweep.llh` call, restricted to
    ``lanes`` (None: every lane), and the batched inputs of the calls named
    in ``keep``."""

    PATCHES = ((sf, "fused_correction"), (sf, "post_split_fit"), (sf, "last_rate"),
               (sf, "smooth_rates"), (sf, "jafs_spectrum"), (sf, "multinomial_llh"),
               (lk, "expm_action_pair_plain"), (lk, "fit_single_pop"),
               (torch.linalg, "solve_ex"))

    def __init__(self, lanes=None, keep=()):
        self.lanes, self.keep = lanes, set(keep)
        self.records, self.inputs, self.count = [], {}, {}

    def _cut(self, t, B):
        if torch.is_tensor(t) and t.dim() >= 1 and t.shape[0] == B and self.lanes is not None:
            return t.index_select(0, self.lanes)
        return t

    def _wrap(self, name, fn, B):
        def run(*args, **kw):
            i = self.count.get(name, 0)
            self.count[name] = i + 1
            key = f"{name}[{i}]"
            if name in self.keep and key not in self.inputs:
                self.inputs[key] = (args, kw)
            out = fn(*args, **kw)
            outs = out if isinstance(out, tuple) else (out,)
            self.records.append((key, [self._cut(t, B) for t in outs if torch.is_tensor(t)]))
            return out

        return run

    @contextlib.contextmanager
    def patched(self, B):
        saved = [(mod, name, getattr(mod, name)) for mod, name in self.PATCHES]
        try:
            for mod, name, fn in saved:
                setattr(mod, name, self._wrap(name, fn, B))
            yield self
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)


def trace_llh(fs, st, params, data7, lanes=None, keep=()):
    """One llh call under a `_Trace`: (trace, llh restricted to ``lanes``)."""
    tr = _Trace(lanes, keep)
    B = st.shape[0]
    inp = fs.kernel_input(st, params).permute(2, 0, 1)  # lanes first
    tr.records.append(("map_params", [tr._cut(inp, B)]))
    with tr.patched(B):
        out = fs.llh(st, params, data7)
    return tr, tr._cut(out, B)


def same_bits(a, b) -> bool:
    """Bitwise equal: the same shape, dtype and NaN mask, and the same bits
    everywhere else (so -0 is not +0, nor inf the largest double)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return bool(torch.equal(a, b))
    nan = a.isnan()
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return bool(torch.equal(nan, b.isnan())
                and torch.equal(a.view(ints)[~nan], b.view(ints)[~nan]))


def _diff(a, b):
    """(bitwise equal, max |a - b| over entries finite in both)."""
    same = same_bits(a, b)
    if a.shape != b.shape:
        return False, float("nan")
    fin = torch.isfinite(a) & torch.isfinite(b)
    d = (a.double() - b.double()).abs()[fin]
    return same, float(d.max()) if d.numel() else 0.0


def compare_traces(alone, batch):
    """Per recorded stage, in call order: name, bitwise equal, max |d|."""
    rows = []
    for (ka, ta), (kb, tb) in zip(alone.records, batch.records):
        assert ka == kb, (ka, kb)
        res = [_diff(a, b) for a, b in zip(ta, tb)]
        rows.append({"stage": ka, "bitwise": all(r[0] for r in res),
                     "max_abs": max((r[1] for r in res), default=0.0)})
    return rows


def op_checks(fs, tr, st, params, rng_seed=0):
    """Each batched op of the traced stages on the batch's own inputs, and
    the library forms the path no longer uses (cuBLAS GEMMs and batched
    products, a reduction over a stacked axis): does a lane get the same
    value in a sub-batch as in the whole batch?"""
    dev, dt = fs.device, LLH_DTYPE  # the stages' dtype
    B = st.shape[0]
    basis = lk.SpectrumBasis(dev, dt)
    gen = torch.Generator(device="cpu").manual_seed(rng_seed)
    perm = torch.randperm(B, generator=gen).to(dev)
    inputs = tr.inputs
    spec_args = inputs["jafs_spectrum[0]"][0]
    series = "expm_action_pair_plain"
    if f"{series}[10]" not in inputs:
        # the card: the spectrum is one launch; its per-interval path's
        # calls come from replaying it through the plain version
        sub = _Trace(keep=(series, "solve_ex"))
        with sub.patched(B):
            lk.jafs_spectrum_plain(*spec_args)
        inputs = {**sub.inputs, **inputs}
    pre = inputs[f"{series}[10]"][0]  # (kmat, coeffs, norms, t, p0)
    post_key = max((k for k in inputs if k.startswith(f"{series}[")),
                   key=lambda k: int(k[len(series) + 1:-1]))
    post = inputs[post_key][0]
    v44, c4 = pre[4].contiguous(), pre[1].contiguous()
    v8, c1 = post[4].contiguous(), post[1].contiguous()
    a8, b8 = inputs["solve_ex[0]"][0]
    psf_args, psf_kw = inputs["post_split_fit[0]"]
    sm_args = inputs["smooth_rates[0]"][0]
    n1p = lk.expm_action_pair_plain(*pre[:4], v44)[1].contiguous()
    gen_np = np.random.default_rng(rng_seed)
    terms = torch.as_tensor(gen_np.uniform(0.0, 1e-3, (27, B, 7)), dtype=dt, device=dev)
    dec = torch.as_tensor(gen_np.uniform(0.0, 0.1, (B, 30, 2)), dtype=dt, device=dev)
    pulse = lk.ss.pulse_operator(torch.as_tensor(gen_np.uniform(0.0, 0.3, B), dtype=dt,
                                                 device=dev), 1, basis.b2)
    sb, lc, mi, pu, tp, tq, cm, sample_at, rebase, sites = spec_args
    sample_rows = [t for t, v in enumerate(sample_at) if torch.is_tensor(v)]
    smask = (torch.stack([sample_at[t] for t in sample_rows], -1) if sample_rows
             else torch.zeros((B, 0), dtype=torch.bool, device=dev))

    def spectrum(lc, mi, pu, tp, tq, cm, smask, rebase):
        sa = list(sample_at)
        for i, t in enumerate(sample_rows):
            sa[t] = smask[:, i]
        return lk.jafs_spectrum(sb, lc, mi, pu, tp, tq, cm, sa, rebase, sites)

    ancT, colT = basis.ancientT, basis.collapseT

    ops = {
        "gemm (B,44)@(44,176) k2": (lambda v: v @ basis.k2, (v44,)),
        "matvec k2 torch (gemm, scale, sum over 4)": (
            lambda v, c: row_matmul_plain(v, basis.k2, c), (v44, c4)),
        "matvec k2 row_matmul kernel": (lambda v, c: row_matmul(v, basis.k2, c), (v44, c4)),
        "gemm (B,8)@(8,8) k1": (lambda v: v @ basis.k1, (v8,)),
        "matvec k1 row_matmul kernel": (lambda v, c: row_matmul(v, basis.k1, c), (v8, c1)),
        "gemm (B,44)@(44,7) jsfs2": (lambda v: v @ basis.jsfs2, (n1p,)),
        "jsfs2 row_matmul kernel": (lambda v: row_matmul(v, basis.jsfs2), (n1p,)),
        "gemm (B,44)@(44,44) ancient.T": (lambda v: v @ ancT, (v44,)),
        "ancient.T row_matmul kernel": (lambda v: row_matmul(v, ancT), (v44,)),
        "gemm (B,44)@(44,8) collapse.T": (lambda v: v @ colT, (v44,)),
        "collapse.T row_matmul kernel": (lambda v: row_matmul(v, colT), (v44,)),
        "gemm (B,8)@(8,7) jsfs1": (lambda v: v @ basis.jsfs1, (v8,)),
        "jsfs1 row_matmul kernel": (lambda v: row_matmul(v, basis.jsfs1), (v8,)),
        "bmm pulse (B,44,44)@(B,44,1)": (lambda p, v: (p @ v[..., None])[..., 0], (pulse, v44)),
        "solve_ex (B,8,8)": (lambda a, b: torch.linalg.solve_ex(a, b)[0], (a8, b8)),
        "smoothing as a batched matmul (B,2,s,s)@(B,2,s,1)": (
            lambda w, x: (w @ x.transpose(1, 2)[..., None])[..., 0].transpose(1, 2),
            (sm_args[1], sm_args[0])),
        "smooth_rates (product, sum over the last axis)": (
            lambda w, x: lk.smooth_rates(x, w), (sm_args[1], sm_args[0])),
        "sum(0) of a (27,B,7) stack": (lambda t: torch.stack(t.unbind(1)).sum(0),
                                       (terms.transpose(0, 1),)),
        "_sum_in_order of 27 (B,7)": (lambda t: lk._sum_in_order(t.unbind(1)),
                                      (terms.transpose(0, 1),)),
        "sum(-1) over 7": (lambda t: t.sum(-1), (terms[0],)),
        "cumsum dim 1 (B,30,2)": (lambda t: torch.cumsum(t, dim=1), (dec,)),
        "sum(1) (B,30,2)": (lambda t: t.sum(1), (dec,)),
        "jafs_spectrum (the one-launch spectrum kernel on the card)": (
            spectrum, (lc, mi, pu, tp, tq, cm, smask, rebase)),
        "expm_action_pair_plain pre-split": (
            lambda c, t, v: torch.cat(lk.expm_action_pair_plain(pre[0], c, pre[2], t, v), -1),
            (c4, pre[3], v44)),
        "fit_single_pop": (lambda a, b, c: kc.fit_single_pop(a, b, c),
                           inputs["fit_single_pop[0]"][0] if "fit_single_pop[0]" in inputs
                           else None),
        "post_split_fit": (lambda nc, lh, t: torch.cat(
            [sf.post_split_fit(nc, lh, t, **psf_kw)[0].flatten(1),
             sf.post_split_fit(nc, lh, t, **psf_kw)[1]], -1), psf_args),
        "correction kernel": (lambda x: cf.correction_sweep(
            x.permute(1, 2, 0).contiguous(), **fs.kernel_opts).permute(2, 0, 1),
            (fs.kernel_input(st, params).permute(2, 0, 1),)),
    }
    rows = []
    for name, (fn, args) in ops.items():
        if args is None:
            continue
        args = tuple(a.index_select(0, perm) if torch.is_tensor(a) and a.shape[0] == B else a
                     for a in args)
        res = {"op": name, "bitwise": {}, "max_abs": {}}
        try:
            full = fn(*args)
            for w in (w for w in SUB_WIDTHS if w < B):
                sub = torch.arange(w, device=dev)
                part = fn(*(a[:w] if torch.is_tensor(a) and a.shape[0] == B else a
                            for a in args))
                same, d = _diff(part, full.index_select(0, sub))
                res["bitwise"][w], res["max_abs"][w] = same, d
        except Exception as e:  # a candidate that fails is reported, not fatal
            res["error"] = f"{type(e).__name__}: {e}"[:2000]
        rows.append(res)
    return rows


def gpu_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def width_main(args, emit):
    dev = torch.device(args.device)
    for cpfit in (True, False):
        mode = "cpfit" if cpfit else "ect"
        _, data, fs = north_star(dev, torch.float32, cpfit)
        st, params, d7 = first_iteration_lanes(fs, data)
        B = st.shape[0]
        lanes = torch.arange(6 * args.cell, 6 * args.cell + 6, device=dev)
        keep = ("expm_action_pair_plain", "solve_ex", "post_split_fit", "smooth_rates",
                "fit_single_pop", "jafs_spectrum")
        batch, llh_b = trace_llh(fs, st, params, d7, lanes, keep)
        alone, llh_a = trace_llh(fs, st[lanes], params[lanes], d7[lanes])
        stages = compare_traces(alone, batch)
        first = next((r["stage"] for r in stages if not r["bitwise"]), None)
        emit({"probe": "width", "mode": mode, "lanes": B, "cell": args.cell,
              "llh_alone": llh_a.tolist(), "llh_in_batch": llh_b.tolist(),
              "max_abs_dllh": float((llh_a.double() - llh_b.double()).abs().max()),
              "first_stage_that_differs": first,
              "stages_that_differ": [r for r in stages if not r["bitwise"]],
              "stages_compared": len(stages)})
        for row in op_checks(fs, batch, st, params):
            emit({"probe": "width-op", "mode": mode, **row})
        # every cell's 6 lanes alone against the batch
        full = fs.llh(st, params, d7)
        moved = []
        for c in range(0, B // 6, 16):
            sl = slice(6 * c, 6 * c + 6)
            d = (fs.llh(st[sl], params[sl], d7[sl]).double() - full[sl].double()).abs()
            moved.append(float(d.max()))
        emit({"probe": "width-cells", "mode": mode, "cells_checked": len(moved),
              "cells_not_bitwise": int(sum(m != 0 for m in moved)),
              "max_abs_dllh": max(moved)})


def _host_us(fn, reps: int) -> float:
    """Host time per call of ``fn`` over ``reps`` calls, no synchronise
    (after a warm-up; the device has drained before)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


HOST_LANES = 4848  # the sweep's first iteration: 808 cells x 6 trial points
HOST_REPS = 200


def host_main(args, emit):
    from .kernels import post_fit as pf
    from .kernels import row_matmul as rm

    dev, B, reps = torch.device(args.device), HOST_LANES, HOST_REPS
    idx = dev.index or 0
    basis = lk.SpectrumBasis(dev, LLH_DTYPE)
    rng = np.random.default_rng(0)

    def tens(a):
        return torch.as_tensor(a, dtype=LLH_DTYPE, device=dev)

    stream = lambda: torch._C._cuda_getCurrentRawStream(idx)  # noqa: E731

    # the one-launch spectrum, 27 + 27 intervals of per-lane tables
    from .kernels import spectrum as ksp

    s, n_post = 27, 27
    lc = tens(rng.uniform(0.5, 2.0, (B, s + n_post + 1, 2)))
    mi = tens(rng.uniform(0.0, 1.0, (B, s, 2)))
    pu = torch.zeros_like(mi)
    tp = tens(rng.uniform(0.0, 0.05, (B, s)))
    tq = tens(rng.uniform(0.0, 0.3, (B, n_post)))
    cm = torch.ones((B, s, 7), dtype=LLH_DTYPE, device=dev)
    sample_at = [torch.ones(B, dtype=torch.bool, device=dev)] + [None] * (s - 1)
    inp = (lc, mi, pu, tp, tq, cm, sample_at, None, np.zeros((s, 2), dtype=bool))
    a = ksp.pack_spectrum(basis, *inp)
    out = lc.new_empty((B, 7))
    fn = ksp._load()
    c = ksp.c_args(basis, a, out)
    steps = {"jafs_spectrum": _host_us(lambda: lk.jafs_spectrum(basis, *inp), reps),
             "pack": _host_us(lambda: ksp.pack_spectrum(basis, *inp), reps),
             "wrapper": _host_us(lambda: ksp.spectrum_kernel(basis, a), reps),
             "launch": _host_us(lambda: fn(ctypes.addressof(c), idx, stream()), reps),
             "args": _host_us(lambda: ksp.c_args(basis, a, out), reps),
             "alloc": _host_us(lambda: lc.new_empty((B, 7)), reps),
             "stream": _host_us(stream, reps)}
    steps["checks_and_rest"] = (steps["wrapper"] - steps["launch"] - steps["args"]
                                - steps["alloc"] - steps["stream"])
    emit({"probe": "host", "kernel": "spectrum", "instance": "the whole spectrum, s = 27, "
          "n_post = 27, per-lane tables, the sample at interval 0", "lanes": B, "reps": reps,
          "us": steps})

    # row_matmul at the collapse map
    v, K = tens(rng.uniform(0.0, 1.0, (B, 44))), basis.collapseT
    out = v.new_empty((B, 8))
    fn = rm._load()
    a = (v.data_ptr(), K.data_ptr(), None, out.data_ptr(), B, 44, 8, 1, idx, stream())
    steps = {"wrapper": _host_us(lambda: rm.row_matmul(v, K), reps),
             "launch": _host_us(lambda: fn(*a), reps),
             "alloc": _host_us(lambda: v.new_empty((B, 8)), reps),
             "stream": _host_us(stream, reps)}
    steps["checks_and_rest"] = steps["wrapper"] - steps["launch"] - steps["alloc"] - steps["stream"]
    lib = {"torch.matmul": _host_us(lambda: torch.matmul(v, K), reps),
           "torch.empty": _host_us(lambda: torch.empty((B, 8), dtype=LLH_DTYPE, device=dev),
                                   reps)}
    emit({"probe": "host", "kernel": "row_matmul", "instance": "collapse (B, 44) @ (44, 8)",
          "lanes": B, "reps": reps, "us": steps, "library_us": lib})

    # post_fit, cpfit (a short kernel: the queue does not fill), per-lane tables
    n = 33
    nc = tens(-rng.uniform(0.0, 3.0, (B, 2)))
    lh = tens(rng.uniform(0.2, 3.0, (B, n, 2)))
    tq = tens(rng.uniform(0.005, 0.6, (B, n)))
    out = nc.new_empty((B, 2 * n + 2))
    fn = pf._load()
    a = (nc.data_ptr(), 2, 1, lh.data_ptr(), lh.stride(0), 2, 1, tq.data_ptr(), n, 1,
         out.data_ptr(), B, n, 1, 1, 1, 1, 1, idx, stream())  # cpfit: the launch shape 1, 1, 1, 1
    steps = {"wrapper": _host_us(lambda: pf.post_fit(nc, lh, tq, cpfit=True), reps),
             "launch": _host_us(lambda: fn(*a), reps),
             "alloc": _host_us(lambda: nc.new_empty((B, 2 * n + 2)), reps),
             "stream": _host_us(stream, reps)}
    steps["checks_and_rest"] = steps["wrapper"] - steps["launch"] - steps["alloc"] - steps["stream"]
    emit({"probe": "host", "kernel": "post_fit", "instance": "cpfit, per-lane tables, n = 33",
          "lanes": B, "reps": reps, "us": steps})


class _Captured(BaseException):
    """Stops a run at its first post-split fit."""


def _first_post_fit(run) -> tuple:
    """(nc, lh_post, T_post) of the first post-split fit ``run()`` makes."""
    seen, mods = [], (lk, sf)

    def rec(*a, **kw):
        seen.append(a)
        raise _Captured

    orig = [m.post_split_fit for m in mods]
    for m in mods:
        m.post_split_fit = rec
    try:
        run()
    except _Captured:
        pass
    finally:
        for m, f in zip(mods, orig):
            m.post_split_fit = f
    return seen[0]


def _solve_work(nc, lh, T) -> dict:
    """What the ECT kernel's two shortcuts skip on these inputs, counted with
    `kernels/post_fit.py` `ect_work` (the plain version's solves): of the
    live solves of rounds 2-6, the share whose prefix of T * lc repeats the
    last round's bit for bit; and the mean number of halvings a live solve
    evaluates before its bracket reaches a fixed point (60 without one),
    over every round's live solves and over those the kernel makes."""
    from .kernels import post_fit as pf

    work = pf.ect_work(nc, lh, T)
    live, rounds = work["solved"][0], len(work["solved"])
    skipped = sum(int((live & ~s).sum()) for s in work["solved"][1:])
    halvings = torch.stack(work["halvings"]).double()
    solved = torch.stack(work["solved"])
    return {"solves": int(live.sum()) * rounds, "solved": int(solved.sum()),
            "repeated_prefix_share": skipped / max(int(live.sum()) * (rounds - 1), 1),
            "halvings_mean": float(halvings[:, live].mean()),
            "halvings_mean_solved": float(halvings[solved].mean())}


def mix_main(args, emit):
    from . import build_likelihood, build_spec
    from .bench import bench_params, bench_spec
    from .cli import sweep as cli_sweep
    from .engine.optimize import solve
    from .kernels import post_fit as pf

    dev = torch.device(args.device)
    fix = os.path.join(REPO, "tests", "fixtures")
    files = [os.path.join(fix, f) for f in ("sweep1.psmc", "sweep2.psmc", "sweep.jsfs")]
    argv = files + ["--splits", "20", "27", "-bs", str(REPLICATES), "-mi", "1", "4", "ST", "3",
                    "1", "-uf", "--funits", "/nonexistent"]
    argv += ["--platform", "cpu"] if dev.type == "cpu" else []
    inp = io_psmc.read_psmc(files[0], files[1], 0, -1)
    sfs = list(io_jsfs.read_jafs(files[2]).jafs[0])
    spec = build_spec(inp.times, inp.lambdas, sfs, 24, [[1, 4, 24, 3.0, 1]], [], cpfit=False,
                      smooth=True, unfolded=True, sample_date=inp.sample_date_discr,
                      thrh=(inp.theta, inp.rho))
    bench = build_likelihood(bench_spec("ect"), device=dev, dtype=LLH_DTYPE)
    runs = {"sweep, first ECT call": lambda: cli_sweep.main(argv),
            "bench, ECT": lambda: bench.llh_batch(bench_params(4096, dev, LLH_DTYPE)),
            "single fit, ECT": lambda: solve(build_likelihood(spec, device=dev,
                                                              dtype=LLH_DTYPE))}
    for name, run in runs.items():
        nc, lh, T = _first_post_fit(run)
        B, (L, n) = nc.shape[0], T.shape
        G = pf.threads_per_solve(B, n)
        lc, _ = lk.post_split_fit_plain(nc, lh, T, cpfit=False)
        emit({"probe": "mix", "input": name, "lanes": B, "intervals": n,
              "tables": "per lane" if L > 1 else "shared", "G": G,
              "old": pf.warp_branch_mix(nc, lh, T, "old", lc=lc),
              "lane": pf.warp_branch_mix(nc, lh, T, "lane", G, lc=lc),
              "work": _solve_work(nc, lh, T)})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    w = sub.add_parser("width")
    w.add_argument("--cell", type=int, default=404)
    w.add_argument("--out", default="")
    w.add_argument("--device", default="cuda", help="cuda (default) or cpu (a dry run)")
    h = sub.add_parser("host")
    h.add_argument("--out", default="")
    h.set_defaults(device="cuda")
    m = sub.add_parser("mix")
    m.add_argument("--out", default="")
    m.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("probe: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    lines = [gpu_line() if args.device == "cuda" else "cpu"]
    print(lines[0], flush=True)

    def emit(obj):
        s = json.dumps(obj)
        lines.append(s)
        print(s, flush=True)

    with contextlib.redirect_stderr(io.StringIO()):
        {"width": width_main, "host": host_main, "mix": mix_main}[args.cmd](args, emit)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
