"""Batched likelihood: correction sweep -> JSFS spectrum -> multinomial llh.

The reference evaluates one likelihood with two sequential Python loops over
time intervals (MigrationInference.py:305-378 `CorrectLambdas` and :467-506
`JAFSpectrum`).  Here every function is batch-first over candidate parameter
vectors ``params (B, n_par)``: the pre-split correction is one fused sweep
(kernels/correction_fused.py: a hand-written CUDA kernel on the card, its
plain torch version on the CPU), the post-split fit one more
(kernels/post_fit.py), and the spectrum one more (kernels/spectrum.py; on
the CPU torch ops over (B, ...) tensors with a Python loop over intervals).

The stages after the pre-split sweep (`post_split_fit`, `last_rate`,
`smooth_rates`, `jafs_spectrum`, `multinomial_llh`) take interval tables
with a leading lane axis of 1 or B: `build_likelihood` passes its one
spec's tables with a lane axis of 1, the fused split-time sweep
(engine/sweep_fused.py) each lane's own.  Zero-length rows (T == 0) are
exact no-ops through all of them.

Failure semantics follow the reference: negative parameters or a failed
lambda correction (any corrected rate <= 0 pre-split) yield -inf
(MigrationInference.py:566-578) via a validity mask instead of early returns.

On the card the batch entry points (`llh_batch`, `llh_flags_batch`) replay a
CUDA graph of the whole call from a width's second call on (`BatchGraphs`):
one graph launch in place of the stages' ~50 torch launches and three hand
kernels, the same kernels in the same order.
"""

from __future__ import annotations

import contextlib
import dataclasses
from types import SimpleNamespace
from typing import Callable

import numpy as np
import torch

from ..config import LLH_DTYPE, resolve_device, resolve_dtype
from ..kernels.correction import fit_single_pop
from ..kernels.correction_fused import correction_sweep, fused_correction
from ..kernels.expm import expm_action_pair_plain, sparse_basis
from ..kernels.post_fit import post_fit
from ..kernels.row_matmul import row_matmul
from ..kernels.spectrum import pack_spectrum, pulse_nonzeros, spectrum_kernel
from ..model import statespace as ss
from ..spans import count, span, spanned
from .spec import ModelSpec

_POST_OUTERS = 6  # Jacobi rounds of the ECT post-split fit
_MAX_GRAPHS = 4  # graphs a likelihood keeps: a fit replays one width, basin-hopping two
# device index -> (side stream, memory pool, the graph that holds the pool) of
# every capture on it: one stream, so that the state torch keeps per stream
# (cuBLAS's workspace) is made once; one pool, whose blocks a dropped
# likelihood's graphs leave to the next capture, so that a capture allocates
# nothing new once one has run.  Torch drops a shared pool once its last graph
# goes (in its device allocator and in its pinned host allocator alike) and
# then refuses to capture into it again, so a graph of one fill, kept for the
# process, holds it
_CAPTURE: dict = {}


def hand_launches() -> int:
    """The launches of the likelihood's hand kernels so far, in this process."""
    return correction_sweep.launches + post_fit.launches + row_matmul.launches \
        + spectrum_kernel.launches


def _llh_call(body, params, **attrs):
    """``body(params)`` in an `llh` span that carries the hand kernels'
    launches made in it (none in a replay)."""
    with span("llh", lanes=params.shape[0], **attrs) as sp:
        launched = hand_launches() if sp else 0
        out = body(params)
        if sp:
            sp.set(hand_launches=hand_launches() - launched)
    return out


def cuda_capture(fn, static_in):
    """``fn(static_in)`` captured into a CUDA graph: an object with
    ``replay()``, which runs its kernels on the current stream, the outputs
    it writes (``outputs``) and ``static_in``.

    The capture runs on its device's side stream, after the current stream's
    work so far, into the device's pool, without the synchronise and cache
    flush of ``torch.cuda.graph``'s entry: those would empty the caching
    allocator that every later allocation of a fit needs.  Graphs share the
    pool, so a replay's intermediates may lie where another graph's outputs
    lie: every replay runs on the current stream, and `BatchGraphs` copies
    its outputs there before the next replay can start."""
    with torch.cuda.device(static_in.device):
        idx = torch.cuda.current_device()
        if idx not in _CAPTURE:
            side, pool, hold = torch.cuda.Stream(), torch.cuda.graph_pool_handle(), \
                torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                hold.capture_begin(pool=pool, capture_error_mode="thread_local")
                torch.zeros(1, device=static_in.device)
                hold.capture_end()
            _CAPTURE[idx] = (side, pool, hold)
        side, pool, _ = _CAPTURE[idx]
        side.wait_stream(torch.cuda.current_stream())
        g = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            g.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                outputs = fn(static_in)
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    g.capture_end()
                raise
            g.capture_end()
    return SimpleNamespace(replay=g.replay, outputs=outputs, static_in=static_in)


class BatchGraphs:
    """The batch entry points of one likelihood (`llh_batch`,
    `llh_flags_batch`) as CUDA graph replays, a graph per entry point and
    batch width.

    A width's first call runs eagerly: it also makes what a call builds
    once (the spectrum kernel's constant arguments and pulse sites, the
    libraries' state for that shape).  Its second call captures the eager
    call on a static input (``capture``: `cuda_capture`; None on the CPU,
    which never captures) and replays it; every later call copies its
    parameters into the static input and replays.  A caller whose widths
    never repeat never captures, and at most `_MAX_GRAPHS` graphs are kept.
    A call served by a replay returns copies of the graph's outputs, which
    the next replay overwrites.  A replay runs none of the stages' Python
    and launches no hand kernel through its wrapper; it counts the work
    counters the captured call counted (``per_lane``: each counter's count
    per lane of a call).  ``captures`` and ``replays`` count, in this
    process, the calls that captured and the calls a replay served (the
    capturing ones too).
    """

    captures = 0
    replays = 0

    def __init__(self, bodies: dict, per_lane: dict, as_params: Callable, capture=None):
        self.bodies = bodies  # entry -> fn(params (B, n_par)) -> tuple of tensors
        self.per_lane = per_lane
        self.as_params = as_params  # the caller's parameters as the bodies take them
        self.capture = capture
        self.seen = set()  # (entry, width) called once
        self.graphs = {}  # (entry, width) -> graph

    def eager(self, entry: str, params):
        """The entry point's call, eagerly."""
        return _llh_call(self.bodies[entry], self.as_params(params))

    def __call__(self, entry: str, params):
        params = self.as_params(params)
        key = (entry, params.shape[0])
        if key not in self.graphs and (self.capture is None or key not in self.seen
                                       or len(self.graphs) >= _MAX_GRAPHS):
            self.seen.add(key)
            return _llh_call(self.bodies[entry], params)
        return _llh_call(lambda p: self._replay(key, p), params, graph=True)

    def _replay(self, key, params):
        g = self.graphs.get(key)
        if g is None:  # the width's second call: capture it, then replay it
            with span("llh.capture"):
                g = self.graphs[key] = self.capture(self.bodies[key[0]], params.clone())
            BatchGraphs.captures += 1
            count("llh.graph_captures", 1)
        else:
            g.static_in.copy_(params)
            for name, per in self.per_lane.items():
                if per:
                    count(name, params.shape[0] * per)
        g.replay()
        BatchGraphs.replays += 1
        count("llh.graph_replays", 1)
        return tuple(t.clone() for t in g.outputs)


def _pulse_update_3state(p, rate, pop: int):
    """Closed-form pulse update of the (B, 2, 3) correction state
    (MigrationInference.py:315-323).  Identity at rate == 0."""
    q = 1 - pop
    rate = rate[:, None]
    cp, cq, c2 = p[..., pop], p[..., q], p[..., 2]
    cols = [None, None, None]
    cols[pop] = cp * (1.0 - rate) ** 2
    cols[q] = cp * rate**2 + cq + c2 * rate
    cols[2] = cp * 2.0 * (1.0 - rate) * rate + c2 * (1.0 - rate)
    return torch.stack(cols, dim=-1)


def post_split_fit(nc, lh_post, T_post, *, cpfit: bool):
    """Post-split single-population rates (MigrationInference.py:355-370).

    ``nc`` (B, 2) is the pre-split carry; ``lh_post`` (L, n, 2) and
    ``T_post`` (L, n) with L = 1 or B.  A T == 0 row gets lc = 1 and leaves
    the carry as it is (the reference's rule, :357-359).  Returns lc_post
    (B, n, 2) and the final carry (B, 2).  CUDA tensors go to the hand
    kernel (kernels/post_fit.py: one launch per call), CPU tensors to
    `post_split_fit_plain`.
    """
    if nc.is_cuda:
        return post_fit(nc, lh_post, T_post, cpfit=cpfit)
    return post_split_fit_plain(nc, lh_post, T_post, cpfit=cpfit)


def post_split_fit_plain(nc, lh_post, T_post, *, cpfit: bool, moves=None):
    """`post_split_fit` in torch ops: cpfit's closed form row by row, ECT's
    _POST_OUTERS Jacobi rounds of batched root solves.  ``moves``, a list,
    collects each ECT round's expansion counts (`fit_single_pop`)."""
    B, n_post = nc.shape[0], T_post.shape[1]
    if cpfit or n_post == 0:
        lc_post = []
        for t in range(n_post):
            T_t = T_post[:, t]
            zero = T_t == 0
            # deviation form of :366: form pnc - 1 from expm1 masses and
            # take -log1p (f32-stable; the weight is O(1))
            ed = torch.exp(nc[:, 1] - nc[:, 0])
            dpnc = -(
                -torch.expm1(-T_t * lh_post[:, t, 0])
                + ed * -torch.expm1(-T_t * lh_post[:, t, 1])
            ) / (1.0 + ed)
            lam = -torch.log1p(dpnc) / torch.where(zero, torch.ones_like(T_t), T_t)
            lam = torch.where(zero, torch.ones_like(lam), lam)
            lc_t = torch.stack([lam, lam], dim=-1)
            nc = nc - T_t[:, None] * lc_t
            lc_post.append(lc_t)
        lc_post = (torch.stack(lc_post, dim=1) if lc_post
                   else torch.zeros((B, 0, 2), dtype=nc.dtype, device=nc.device))
        return lc_post, nc
    # Jacobi fixed point: given lc guesses, every nc is one cumsum and every
    # interval's fit runs in one batched call
    zero = T_post == 0
    t_safe = torch.where(zero, torch.ones_like(T_post), T_post)
    lh_post = lh_post.expand(B, n_post, 2)
    lc_post = lh_post.mean(dim=-1, keepdim=True).expand(B, n_post, 2)
    for _ in range(_POST_OUTERS):
        dec = T_post[..., None] * lc_post  # (B, n_post, 2)
        csum = torch.cumsum(dec, dim=1)
        nc_t = nc[:, None, :] - torch.cat(
            [torch.zeros_like(csum[:, :1]), csum[:, :-1]], dim=1)
        # shift by the per-interval max: ratio-invariant, immune to f32 exp
        # underflow of the cumulative log no-coal mass
        w = torch.exp(nc_t - nc_t.max(dim=-1, keepdim=True).values)
        lam = fit_single_pop(lh_post, t_safe, w, moves=moves)
        lam = torch.where(zero, torch.ones_like(lam), lam)
        lc_post = torch.stack([lam, lam], dim=-1)
    return lc_post, nc - (T_post[..., None] * lc_post).sum(1)


def last_rate(nc_fin, lh_last):
    """Rate of the last (infinite) interval, (B,): the weighted harmonic mean
    (:371-376), with a max-shifted exp (the mean is invariant to the common
    factor).  ``lh_last`` (L, 2)."""
    m_nc = torch.maximum(nc_fin[:, 0], nc_fin[:, 1])
    pr0 = torch.exp(nc_fin[:, 0] - m_nc)
    pr1 = torch.exp(nc_fin[:, 1] - m_nc)
    return (pr0 + pr1) / (pr0 / lh_last[:, 0] + pr1 / lh_last[:, 1])


def smooth_rates(lc_pre, smooth_w):
    """Smoothed pre-split rates (B, s, 2): ``smooth_w`` (2, s, s) for every
    lane, or (B, 2, s, s) per lane.  The per-lane form is a product and a
    sum over the last axis, not a batched matmul: the library's batched
    product picks its algorithm by the batch size, so a lane's float32
    value would depend on how many lanes there are."""
    if smooth_w.dim() == 3:
        return torch.stack(
            [lc_pre[..., 0] @ smooth_w[0].T, lc_pre[..., 1] @ smooth_w[1].T], dim=-1)
    return (smooth_w * lc_pre.transpose(1, 2)[:, :, None, :]).sum(-1).transpose(1, 2)


class SpectrumBasis:
    """The spectrum's constant tables on one device and dtype."""

    def __init__(self, dev: torch.device, dt: torch.dtype):
        def tens(a):
            # row-major: MKL's product with a transposed (44, 176) operand
            # rounds a row differently at different batch sizes, which would
            # make a lane's value depend on its batch
            return torch.as_tensor(np.ascontiguousarray(a, dtype=float), dtype=dt,
                                   device=dev)

        b2 = ss.two_pop_basis()
        b1 = ss.one_pop_basis()
        self.b2, self.b1 = b2, b1
        # the products' right-hand matrices, row-major (x @ M^T = x @ ancientT)
        self.ancientT = tens(b2.ancient.T)
        self.collapseT = tens(b2.collapse.T)
        self.jsfs2 = tens(b2.jsfs)  # (44, 7)
        self.jsfs1 = tens(b1.jsfs)  # (8, 7)
        self.k2 = tens(np.concatenate(
            [b2.coal[0].T, b2.coal[1].T, b2.migr[0].T, b2.migr[1].T], axis=1))  # (44, 176)
        self.norms2 = tens(np.abs(np.stack(
            [b2.coal[0], b2.coal[1], b2.migr[0], b2.migr[1]])).sum(axis=1).max(axis=1))
        self.k1 = tens(b1.coal.T)  # (8, 8)
        self.norms1 = tens(np.abs(b1.coal).sum(axis=0).max(keepdims=True))
        # the stacked bases' nonzeros, as the spectrum's series reads them
        self.sp2 = sparse_basis(self.k2, 4)
        self.sp1 = sparse_basis(self.k1, 1)
        # the pulse operators' nonzeros, as the spectrum kernel reads them
        idx, coef = pulse_nonzeros(b2.pulse_coeff, b2.pulse_k)
        self.pulse_idx = torch.as_tensor(idx, device=dev)
        self.pulse_coef = tens(coef)
        # the spectrum kernel's constant arguments and pulse sites, made at
        # their first use (kernels/spectrum.py, `pack_spectrum`)
        self.kernel_cache = {}


def _select(mask, a, b):
    """``a`` where ``mask`` holds, else ``b``; ``mask`` is None (no lane),
    True (every lane) or a (B,) bool tensor."""
    if mask is None:
        return b
    if mask is True:
        return a
    return torch.where(mask[:, None], a, b)


def jafs_spectrum(basis: SpectrumBasis, lc, mi, pu, T_pre, T_post, catmask,
                  sample_at, rebase, pulse_site):
    """Unnormalised 7-category spectrum, (B, 7) (JAFSpectrum,
    MigrationInference.py:467-506), as `jafs_spectrum_plain` sets it out.

    CUDA tensors go to the one-launch spectrum kernel (kernels/spectrum.py,
    its inputs read in place), CPU tensors to `jafs_spectrum_plain`."""
    if lc.is_cuda:
        return spectrum_kernel(basis, pack_spectrum(basis, lc, mi, pu, T_pre, T_post, catmask,
                                                    sample_at, rebase, pulse_site))
    return jafs_spectrum_plain(basis, lc, mi, pu, T_pre, T_post, catmask, sample_at, rebase,
                               pulse_site)


def jafs_spectrum_plain(basis: SpectrumBasis, lc, mi, pu, T_pre, T_post, catmask,
                        sample_at, rebase, pulse_site, parts: dict | None = None):
    """Unnormalised 7-category spectrum, (B, 7) (JAFSpectrum,
    MigrationInference.py:467-506), as a loop over intervals: the CPU's
    path and the spectrum kernel's plain version.

    ``lc`` (B, s + n_post + 1, 2) holds the rates of every interval, ``mi``
    and ``pu`` (B, >= s, 2) the pre-split migration and pulse rates;
    ``T_pre`` (L, s), ``T_post`` (L, n_post); ``catmask`` (s, 7) or
    (B, s, 7).  ``sample_at[t]`` says where the ancient sample enters before
    interval t and ``rebase`` where it enters at the split (each None, True
    or a (B,) bool tensor); ``pulse_site`` (s, 2) host bools mark the pulses
    that may be nonzero (P(0) is the identity, so the others are skipped).

    Only the action of E and N1 on the carried state is needed, so each
    interval is Taylor sub-stepping with each lane's generator over the
    bases' nonzeros, with N1 p0's projection onto the categories folded in
    (kernels/expm.py `expm_action_pair_plain`).  Every other product with
    a constant matrix is a `row_matmul`, the per-lane pulse operators are
    applied as a product and a last-axis sum, and the interval terms are
    added in order, so a lane's spectrum does not depend on the batch it is
    evaluated in.  ``parts``, a dict, gets the sums of the pre- and
    post-split terms ("pre", "post": None where there is no such interval)
    and the 8-state p0 before the last interval ("p8").
    """
    B = lc.shape[0]
    s, n_post = T_pre.shape[1], T_post.shape[1]
    p0 = torch.zeros((B, 44), dtype=lc.dtype, device=lc.device)
    p0[:, 2] = 1.0
    coeffs_pre = torch.cat([lc[:, :s], mi[:, :s]], dim=-1)  # (B, s, 4)
    coeffs_post = lc[:, s:s + n_post, :1]  # (B, n_post, 1)

    jafs_pre = []
    for t in range(s):
        if sample_at[t] is not None:
            p0 = _select(sample_at[t], row_matmul(p0, basis.ancientT), p0)
        for pop in (0, 1):
            if pulse_site[t, pop]:
                # a product and a last-axis sum, as in smooth_rates
                p0 = (ss.pulse_operator(pu[:, t, pop], pop, basis.b2) * p0[:, None, :]).sum(-1)
        cm = catmask[t] if catmask.dim() == 2 else catmask[:, t]
        p0, _, jafs_t = expm_action_pair_plain(basis.sp2, coeffs_pre[:, t], basis.norms2,
                                               T_pre[:, t], p0, jsfs=basis.jsfs2, catmask=cm)
        jafs_pre.append(jafs_t)

    # ancient rebase exactly at the split happens before the collapse
    if rebase is not None:
        p0 = _select(rebase, row_matmul(p0, basis.ancientT), p0)
    p0 = row_matmul(p0, basis.collapseT)  # (B, 8)

    jafs_post = []
    for t in range(n_post):
        p0, _, jafs_t = expm_action_pair_plain(basis.sp1, coeffs_post[:, t], basis.norms1,
                                               T_post[:, t], p0, jsfs=basis.jsfs1)
        jafs_post.append(jafs_t)

    # last interval, T = infinity: occupancy = -M^{-1} P0 (:530-540)
    m_last = ss.one_pop_matrix(lc[:, s + n_post, 0], basis.b1)
    occ_last, _ = torch.linalg.solve_ex(m_last, -p0)
    jafs = row_matmul(occ_last, basis.jsfs1)
    pre = _sum_in_order(jafs_pre) if jafs_pre else None
    post = _sum_in_order(jafs_post) if jafs_post else None
    if parts is not None:
        parts.update(pre=pre, post=post, p8=p0)
    if post is not None:
        jafs = post + jafs
    if pre is not None:
        jafs = pre + jafs
    return jafs


def _sum_in_order(terms):
    """terms[0] + terms[1] + ... left to right: elementwise adds, so a lane's
    sum does not depend on how many lanes there are (a reduction over a
    stacked axis picks its order by the tensor's size)."""
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def _fold(x):
    """Folded pairing (0,6) (1,5) (2,4) 3 (:600-605)."""
    return torch.stack([x[..., 0] + x[..., 6], x[..., 1] + x[..., 5],
                        x[..., 2] + x[..., 4], x[..., 3]], dim=-1)


def multinomial_const(data, unfolded: bool):
    """log n! - sum_i log d_i! of (B, 7) data spectra, per lane, in float64
    (see `multinomial_llh`)."""
    data = data.double()
    n = data.sum(-1)
    cats = data if unfolded else _fold(data)
    return torch.lgamma(n + 1) - torch.lgamma(cats + 1).sum(-1)


def multinomial_llh(jafs_raw, data, llh_const, unfolded: bool):
    """Multinomial llh of an unnormalised spectrum (B, 7) against data (B, 7)
    or (7,).  Returns (llh, normalised jafs, pos): llh holds where pos.

    Taken in float64 and returned in the spectrum's dtype: the data term and
    the multinomial constant are each ~1e4-1e5 nats and cancel to the llh,
    so in float32 the llh would carry their rounding (~4e-3 nats at 4e4),
    an order of magnitude more than the float32 spectrum itself causes."""
    dt = jafs_raw.dtype
    norm = jafs_raw.double().sum(-1)
    jafs = jafs_raw.double() / norm[:, None]
    data = data.double()
    cats, dat = (jafs, data) if unfolded else (_fold(jafs), _fold(data))
    pos = (cats > 0).all(-1) & torch.isfinite(norm) & (norm > 0)
    safe = torch.where(cats > 0, cats, torch.ones_like(cats))
    llh = llh_const + (dat * torch.log(safe)).sum(-1)
    return llh.to(dt), jafs.to(dt), pos


@dataclasses.dataclass
class Likelihood:
    """Likelihood functions for one ModelSpec on one device and dtype."""

    spec: ModelSpec
    device: torch.device
    dtype: torch.dtype  # the parameters'; every stage computes in LLH_DTYPE
    llh: Callable  # params (n_par,) -> () llh (-inf on failure)
    llh_aux: Callable  # params (n_par,) -> (llh, dict(jafs, lc, pr, valid, ...))
    llh_batch: Callable  # params (B, n_par) -> (B,) llh
    llh_data: Callable  # (params (B, n_par), data7 (B, 7)) -> (B,) llh
    llh_flags: Callable  # params (n_par,) -> (llh, [corr_called, corr_failed])
    llh_flags_batch: Callable  # params (B, n_par) -> (llh (B,), flags (B, 2))
    # the stages, batch-first, for timing them apart
    map_params: Callable  # params (B, n_par) -> (mi, pu) (B, numT, 2)
    correct: Callable  # (mi, pu) -> (lc (B, numT, 2), pr, valid (B,))
    spectrum: Callable  # (lc, mi, pu) -> unnormalised jafs (B, 7)
    sweep_tables: tuple = ()  # (lh (s, 2), times (s,)) of the fused sweep
    sweep_opts: dict = dataclasses.field(default_factory=dict)  # its options
    # the batch entry points' graphs; ``graphs.eager(entry, params)`` is their eager call
    graphs: BatchGraphs | None = dataclasses.field(default=None, repr=False, compare=False)


@spanned("likelihood.build")
def build_likelihood(spec: ModelSpec, *, device=None, dtype=None) -> Likelihood:
    """Build the batched likelihood for ``spec``.

    ``device`` defaults to CUDA and raises when there is no card; ``dtype``,
    the parameters' (rounded to it on the way in), defaults to float64 on
    every device.  Every stage computes in LLH_DTYPE and the llh comes back
    in it.
    """
    dev = resolve_device(device)
    dt = resolve_dtype(dev, dtype)
    ct = LLH_DTYPE
    s = spec.splitT
    # statically migration-free: no fixed bands and no optimised rates
    static_no_mig = (len(spec.opt_mi) == 0) and bool(np.all(spec.mi_base == 0))
    has_pulse = bool(spec.opt_pu) or bool(np.any(np.asarray(spec.pu_base)[:s] != 0))
    # the sweep's variant; its Jacobi/LM budgets keep their defaults (2/8/2)
    sweep_opts = {"cpfit": spec.cpfit, "mixture_th": float(spec.mixture_th),
                  "static_no_mig": static_no_mig, "has_pulse": has_pulse}

    def tens(a):
        return torch.as_tensor(np.asarray(a, dtype=float), dtype=ct, device=dev)

    numT = spec.numT
    sd = spec.sample_date

    times = np.asarray(spec.times, dtype=float)  # (numT-1,)
    lh = np.asarray(spec.lh, dtype=float)  # (numT, 2)
    # genome-2 categories are zeroed before the ancient sample exists
    # (MigrationInference.py:503-505)
    catmask = np.ones((s, 7))
    catmask[:sd, 2:] = 0.0
    sample_at = [True if t == sd else None for t in range(s)]

    n_mi = len(spec.opt_mi)
    n_pu = len(spec.opt_pu)
    n_par = n_mi + n_pu
    mi_any = spec.mi_masks.sum(0) if n_mi else np.zeros((numT, 2))
    pu_any = spec.pu_masks.sum(0) if n_pu else np.zeros((numT, 2))
    # pulse sites: P(0) is the identity, so statically zero pulses are skipped
    pulse_site = (np.asarray(spec.pu_base) != 0) | (pu_any != 0)  # (numT, 2)
    n_sites = int(pulse_site[:s].sum())

    mi_base, pu_base = tens(spec.mi_base), tens(spec.pu_base)
    mi_keep, pu_keep = tens(1.0 - mi_any), tens(1.0 - pu_any)
    mi_masks, pu_masks = tens(spec.mi_masks), tens(spec.pu_masks)
    lh_t = tens(lh)
    pre_T_t = tens(times[:s])
    # the per-lane tables of the shared stages, with one lane
    pre_T1, post_T1 = pre_T_t[None], tens(times[s:numT - 1])[None]
    lh_post1, lh_last1 = lh_t[None, s:numT - 1], lh_t[None, numT - 1]
    catmask_t = tens(catmask)
    smooth_w = tens(spec.smooth_w) if (spec.smooth and s > 0) else None
    basis = SpectrumBasis(dev, ct)
    # the correction's start state, made here: a copy from the host inside a
    # call would keep the call from being captured
    p0 = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], dtype=ct, device=dev)

    def map_params(params):
        """MapParameters (MigrationInference.py:291-298): overwrite the
        optimised regions of the fixed-rate tables with the parameters."""
        B = params.shape[0]
        mi = mi_base.expand(B, numT, 2)
        pu = pu_base.expand(B, numT, 2)
        if n_mi:
            mi = mi * mi_keep + torch.einsum("bk,ktc->btc", params[:, :n_mi], mi_masks)
        if n_pu:
            pu = pu * pu_keep + torch.einsum("bk,ktc->btc", params[:, n_mi:], pu_masks)
        return mi, pu

    # -- correction (CorrectLambdas, MigrationInference.py:305-378) ---------

    def correct(mi, pu):
        with span("llh.correct") as sp:
            B = mi.shape[0]
            p0b = p0.expand(B, 2, 3)
            lh_pre = lh_t[:s].expand(B, s, 2)
            if not spec.correct or s == 0:
                # trueEPS: rates pass through; p0 evolves only by pulses
                p = p0b
                pr_tail = []
                for t in range(s):
                    p = _pulse_update_3state(p, pu[:, t, 0], 0)
                    p = _pulse_update_3state(p, pu[:, t, 1], 1)
                    pr_tail.append(p.transpose(1, 2))
                lc_pre = lh_pre
                pr = torch.stack([p0b.transpose(1, 2), *pr_tail], dim=1)
                nc = p.sum(-1)
                valid = torch.ones(B, dtype=torch.bool, device=dev)
            else:
                lc_pre, p_after = fused_correction(
                    mi[:, :s], pu[:, :s], lh_t[:s], pre_T_t, **sweep_opts)
                sp.set(pulse=has_pulse)
                if has_pulse:
                    count("correction.pulse_rows", B * s)
                pr = torch.cat([p0b.transpose(1, 2)[:, None], p_after.transpose(2, 3)], dim=1)
                nc = p_after[:, -1].sum(-1)
                valid = (lc_pre > 0).all(-1).all(-1)

        with span("llh.post_split"):
            lc_post, nc_fin = post_split_fit(nc, lh_post1, post_T1, cpfit=spec.cpfit)
            lam_last = last_rate(nc_fin, lh_last1)
            lc_last = torch.stack([lam_last, lam_last], dim=-1)[:, None]
            if smooth_w is not None:
                lc_pre = smooth_rates(lc_pre, smooth_w)
            lc = torch.cat([lc_pre, lc_post, lc_last], dim=1)  # (B, numT, 2)
        return lc, pr, valid

    def spectrum(lc, mi, pu):
        return jafs_spectrum(basis, lc, mi, pu, pre_T1, post_T1, catmask_t, sample_at,
                             True if sd == s else None, pulse_site)

    # -- full likelihood ------------------------------------------------------

    def _stages(params, data, llh_const):
        with span("llh.lanes"):
            nonneg = (params >= 0).all(-1)
            mi, pu = map_params(params)
        lc, pr, valid_corr = correct(mi, pu)
        with span("llh.spectrum", pulse_sites=n_sites):
            if n_sites:
                count("spectrum.pulse_ops", params.shape[0] * n_sites)
            jafs_raw = spectrum(lc, mi, pu)
        with span("llh.multinomial"):
            llh, jafs, pos = multinomial_llh(jafs_raw, data, llh_const, spec.unfolded)
            valid = nonneg & valid_corr & pos
            llh = torch.where(valid, llh, torch.full_like(llh, -float("inf")))
        # Report() counters (MigrationInference.py:306,336,347,567): "called"
        # once per eval past the negative-rate guard, "failed" when the sweep
        # ran and left a rate <= 0
        return llh, {"jafs": jafs, "lc": lc, "pr": pr, "valid": valid,
                     "mi": mi, "pu": pu, "corr_called": nonneg,
                     "corr_failed": nonneg & ~valid_corr}

    def _core(params, data, llh_const):
        return _llh_call(lambda p: _stages(p, data, llh_const), params)

    def as_params(params):
        """(B, n_par) tensor on the device, rounded to the run's dtype and
        computed in LLH_DTYPE; a single vector becomes B = 1."""
        if not torch.is_tensor(params):
            params = np.asarray(params, dtype=float)
        p = torch.as_tensor(params).to(device=dev, dtype=dt).to(ct)
        return p.reshape(1, n_par) if p.dim() <= 1 else p.reshape(p.shape[0], n_par)

    data_t = tens(spec.data_jafs)

    def llh_aux(params):
        llh, aux = _core(as_params(params), data_t, spec.llh_const)
        return llh[0], {k: v[0] for k, v in aux.items()}

    def llh_only(params):
        return llh_aux(params)[0]

    def batch_llh(params):
        return (_stages(params, data_t, spec.llh_const)[0],)

    def batch_flags(params):
        llh, aux = _stages(params, data_t, spec.llh_const)
        return llh, torch.stack([aux["corr_called"], aux["corr_failed"]], dim=-1).to(dt)

    # what a call counts per lane, as `correct` and the spectrum stage count it
    per_lane = {"correction.pulse_rows": s if (spec.correct and s and has_pulse) else 0,
                "spectrum.pulse_ops": n_sites}
    graphs = BatchGraphs({"llh": batch_llh, "flags": batch_flags}, per_lane, as_params,
                         cuda_capture if dev.type == "cuda" else None)

    def llh_batch(params):
        return graphs("llh", params)[0]

    def llh_data(params, data7):
        """Likelihood with the 7-category data spectrum as an argument (for
        bootstrap replicates); the multinomial constant is recomputed."""
        single = (params.dim() if torch.is_tensor(params) else np.ndim(params)) <= 1
        p = as_params(params)
        d = torch.as_tensor(np.asarray(data7, dtype=float) if not torch.is_tensor(data7)
                            else data7).to(device=dev, dtype=ct)
        d = d.expand(p.shape[0], 7)
        llh = _core(p, d, multinomial_const(d, spec.unfolded))[0]
        return llh[0] if single else llh

    def llh_flags_batch(params):
        """(llh (B,), Report() counters (B, 2): corr_called, corr_failed) for
        the optimiser's per-evaluation accumulation."""
        return graphs("flags", params)

    def llh_flags(params):
        """`llh_flags_batch` of one parameter vector, eagerly: (llh, counters (2,))."""
        llh, flags = graphs.eager("flags", params)
        return llh[0], flags[0]

    return Likelihood(
        spec=spec, device=dev, dtype=dt, llh=llh_only, llh_aux=llh_aux,
        llh_batch=llh_batch, llh_data=llh_data, llh_flags=llh_flags,
        llh_flags_batch=llh_flags_batch,
        map_params=lambda params: map_params(as_params(params)),
        correct=correct, spectrum=spectrum, sweep_tables=(lh_t[:s], pre_T_t),
        sweep_opts=sweep_opts, graphs=graphs,
    )
