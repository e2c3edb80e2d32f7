"""The JSFS spectrum of a likelihood call in one launch: CUDA kernel wrapper.

``spectrum_kernel(basis, args)`` launches csrc/spectrum.cu: per lane (a warp)
the 44-state pre-split intervals with the ancient sample and the pulses,
the collapse, the 8-state post-split intervals, the last interval's
occupancy and the sum of every interval's JSFS term in the plain
version's order, writing only the (B, 7) spectrum.  Each interval runs the
series of csrc/expm_series.cuh, each value rounded as kernels/expm.py
`expm_action_pair_plain` rounds it on the card, at the series settings of
kernels/expm.py (THETA, DEGREE, MAX_SUBSTEPS).  Float64 only, the likelihood's dtype
(config.LLH_DTYPE).  Its plain version is engine/likelihood.py
`jafs_spectrum_plain`; `jafs_spectrum` there takes this kernel, on the
inputs `pack_spectrum` packs, for CUDA tensors.

* `SpectrumArgs` is what the kernel reads of a call, as it reads it: each
  table with its lane stride (0: one row for every lane) and its row stride.
* `pack_spectrum` makes one from `jafs_spectrum`'s inputs, in place.
* ``spectrum_kernel.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from pathlib import Path

import numpy as np
import torch

from .correction_fused import BUILD_DIR, build_stale, stale
from .expm import DEGREE, MAX_SUBSTEPS, THETA

_CSRC = Path(__file__).resolve().parent / "csrc" / "spectrum.cu"
_LIB_PATH = BUILD_DIR / "spectrum_f64.so"
_LIBS: dict = {}
_LIB_LOCK = threading.Lock()
_F64 = torch.float64
Q = 7  # JSFS categories


@dataclasses.dataclass
class SpectrumArgs:
    """One spectrum call's inputs as the kernel reads them.  Strides are in
    elements; a lane stride of 0 gives every lane the same row; every last
    axis is contiguous."""

    B: int
    s: int  # pre-split intervals
    n_post: int  # post-split intervals before the last
    lc: torch.Tensor  # rates, row t of lane b at lc[b * lc_ld + t * lc_rs + (0, 1)]
    lc_ld: int
    lc_rs: int
    mi: torch.Tensor  # pre-split migration rates, likewise
    mi_ld: int
    mi_rs: int
    pu: torch.Tensor  # pre-split pulse rates, likewise
    pu_ld: int
    pu_rs: int
    t_pre: torch.Tensor  # interval lengths, t_pre[b * tp_ld + t]
    tp_ld: int
    t_post: torch.Tensor
    tq_ld: int
    catmask: torch.Tensor  # catmask[b * cm_ld + t * cm_rs + q]
    cm_ld: int
    cm_rs: int
    sample_row: int  # the row before which the sample enters; -1: none
    sample: torch.Tensor | None  # bool, sample[b * sample_ld]; None: every lane
    sample_ld: int
    rebase: bool  # the sample may enter at the split
    rebase_mask: torch.Tensor | None  # bool, likewise; None: every lane
    rebase_ld: int
    pulse_site: torch.Tensor | None  # (s, 2) uint8 on the device; None: no pulse


def _strides(x, B: int, name: str, dims: int, rows: int) -> tuple:
    """(lane stride, row stride) of a table of ``dims`` axes whose first is
    the lane's (B, or 1: one row for every lane) and whose second holds at
    least ``rows`` rows; its last axis must be contiguous."""
    shape, st = x.shape, x.stride()
    if len(shape) != dims or shape[0] not in (1, B) or shape[1] < rows \
            or (shape[-1] > 1 and st[-1] != 1):
        raise ValueError(f"{name}: expected {dims} axes, ({B} or 1, >= {rows}, ...), with a "
                         f"contiguous last axis; got {tuple(shape)} strides {st}")
    return (0 if shape[0] == 1 else st[0]), st[1]


def _lanes(mask, B: int, name: str):
    """(mask, lane stride) of a sample mask: None, True (every lane) or a
    (B,) / (1,) bool tensor."""
    if mask is True:
        return None, 0
    if mask.dim() != 1 or mask.shape[0] not in (1, B) or mask.dtype is not torch.bool:
        raise ValueError(f"{name}: expected True or a ({B},) bool tensor")
    return mask, (0 if mask.shape[0] == 1 else mask.stride(0))


def pack_spectrum(basis, lc, mi, pu, T_pre, T_post, catmask, sample_at, rebase,
                  pulse_site) -> SpectrumArgs:
    """engine/likelihood.py `jafs_spectrum`'s inputs as the kernel reads
    them: each table in place with its lane stride (0 where one row serves
    every lane) and row stride; the sample's row (the ancient sample enters
    at one interval, its sampling date) and its lanes; the rebase's lanes;
    the pulse sites as a device table, made once per basis and pattern (in
    ``basis.kernel_cache``).  Raises on what the kernel does not take."""
    B = lc.shape[0]
    s, n_post = T_pre.shape[1], T_post.shape[1]
    lc_ld, lc_rs = _strides(lc, B, "lc", 3, s + n_post + 1)
    mi_ld, mi_rs = _strides(mi, B, "mi", 3, s)
    pu_ld, pu_rs = _strides(pu, B, "pu", 3, s)
    tp_ld, _ = _strides(T_pre, B, "T_pre", 2, s)
    tq_ld, _ = _strides(T_post, B, "T_post", 2, n_post)
    cm_ld, cm_rs = _strides(catmask if catmask.dim() == 3 else catmask[None], B, "catmask", 3, s)
    if lc.shape[2] < 2 or mi.shape[2] < 2 or pu.shape[2] < 2 or catmask.shape[-1] != Q:
        raise ValueError("expected lc, mi, pu (..., 2) and catmask (..., 7)")
    rows = [t for t in range(s) if sample_at[t] is not None]
    if len(rows) > 1:
        raise ValueError(f"the ancient sample enters at one interval, not at {rows}")
    sample, sample_ld = _lanes(sample_at[rows[0]], B, "sample_at") if rows else (None, 0)
    rebase_mask, rebase_ld = (None, 0) if rebase is None else _lanes(rebase, B, "rebase")
    sites = np.asarray(pulse_site[:s], dtype=bool)
    site_t = None
    if sites.any():
        key = ("pulse_site", sites.tobytes(), s)
        site_t = basis.kernel_cache.get(key)
        if site_t is None:
            site_t = torch.as_tensor(sites.astype(np.uint8), device=lc.device)
            basis.kernel_cache[key] = site_t
    return SpectrumArgs(
        B=B, s=s, n_post=n_post, lc=lc, lc_ld=lc_ld, lc_rs=lc_rs, mi=mi, mi_ld=mi_ld,
        mi_rs=mi_rs, pu=pu, pu_ld=pu_ld, pu_rs=pu_rs, t_pre=T_pre, tp_ld=tp_ld, t_post=T_post,
        tq_ld=tq_ld, catmask=catmask, cm_ld=cm_ld, cm_rs=cm_rs,
        sample_row=rows[0] if rows else -1, sample=sample, sample_ld=sample_ld,
        rebase=rebase is not None, rebase_mask=rebase_mask, rebase_ld=rebase_ld,
        pulse_site=site_t)


def pulse_nonzeros(pulse_coeff: np.ndarray, pulse_k: np.ndarray):
    """The pulse operators' nonzeros as the kernel reads them: for each
    population and output state d, its sources' (src, a, k_src - a) (idx,
    int32, (2, n, L, 3)) and counts (coef, (2, n, L)), so that
    P(r)[d, src] = coef * r^a * (1 - r)^(k_src - a); padded with src n
    (the buffer's zero) and count 0."""
    n = pulse_coeff.shape[-1]
    nz = [[np.argwhere(pulse_coeff[pop][:, d, :].T != 0) for d in range(n)] for pop in (0, 1)]
    L = max(len(e) for row in nz for e in row)
    idx = np.zeros((2, n, L, 3), dtype=np.int32)
    idx[..., 0] = n
    coef = np.zeros((2, n, L))
    for pop in (0, 1):
        for d in range(n):
            for l, (src, a) in enumerate(nz[pop][d]):  # sources in increasing order
                idx[pop, d, l] = (src, a, pulse_k[pop, src] - a)
                coef[pop, d, l] = pulse_coeff[pop, a, d, src]
    return idx, coef


def build_jobs(force: bool = False) -> list:
    """The nvcc job of this kernel's library for
    `correction_fused.compile_libs`; without ``force`` only if stale."""
    jobs = [(_LIB_PATH, _CSRC, ())]
    return jobs if force else stale(jobs)


_P, _L, _D = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_double


class _Args(ctypes.Structure):
    """csrc/spectrum.cu `Args`, field for field (all 8 bytes wide)."""

    _fields_ = [(name, kind) for names, kind in (
        ("src2 slot2 vals2", _P), ("nnz2", _L), ("src1 slot1 vals1", _P), ("nnz1", _L),
        ("norms2 norms1 ancT colT jsfs2 jsfs1 k1 pidx pcoef", _P), ("pulse_len", _L),
        ("lc", _P), ("lc_ld lc_rs", _L), ("mi", _P), ("mi_ld mi_rs", _L),
        ("pu", _P), ("pu_ld pu_rs", _L), ("t_pre", _P), ("tp_ld", _L), ("t_post", _P),
        ("tq_ld", _L), ("catmask", _P), ("cm_ld cm_rs sample_row", _L), ("sample", _P),
        ("sample_ld rebase", _L), ("rebase_mask", _P), ("rebase_ld", _L),
        ("pulse_site out parts", _P), ("B s n_post", _L), ("theta", _D), ("cap degree", _L),
    ) for name in names.split()]


def _load():
    with _LIB_LOCK:
        if "fn" not in _LIBS:
            build_stale()
            lib = ctypes.CDLL(str(_LIB_PATH))
            fn = lib.misti_spectrum
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            lib.misti_spectrum_attrs.argtypes = [ctypes.c_void_p]
            lib.misti_spectrum_attrs.restype = ctypes.c_int
            if lib.misti_spectrum_args_size() != ctypes.sizeof(_Args):
                raise RuntimeError("csrc/spectrum.cu's Args and _Args differ in layout")
            _LIBS["lib"], _LIBS["fn"] = lib, fn
        return _LIBS["fn"]


def kernel_attrs() -> dict:
    """Registers per thread, local (spill) bytes per thread and resident
    blocks per SM.  Needs a card."""
    buf = (ctypes.c_int * 3)()
    _load()
    err = _LIBS["lib"].misti_spectrum_attrs(ctypes.addressof(buf))
    if err != 0:
        raise RuntimeError(f"misti_spectrum_attrs failed: CUDA error {err}")
    return dict(registers=buf[0], local_bytes=buf[1], blocks_per_sm=buf[2])


def _tables(basis) -> _Args:
    """The constant part of the kernel's arguments for ``basis`` (an
    engine/likelihood.py `SpectrumBasis` on the card), made once per basis."""
    tmpl = basis.kernel_cache.get("spectrum_args")
    if tmpl is None:
        sp2, sp1 = basis.sp2, basis.sp1
        if (sp2.n, sp2.C, sp2.L, sp1.n, sp1.C, sp1.L) != (44, 4, 5, 8, 1, 3):
            raise ValueError("the spectrum kernel takes the 44-state (C = 4, L = 5) and the "
                             "8-state (C = 1, L = 3) bases")
        tmpl = _Args(
            src2=sp2.src.data_ptr(), slot2=sp2.slot.data_ptr(), vals2=sp2.vals.data_ptr(),
            nnz2=sp2.nnz, src1=sp1.src.data_ptr(), slot1=sp1.slot.data_ptr(),
            vals1=sp1.vals.data_ptr(), nnz1=sp1.nnz, norms2=basis.norms2.data_ptr(),
            norms1=basis.norms1.data_ptr(), ancT=basis.ancientT.data_ptr(),
            colT=basis.collapseT.data_ptr(), jsfs2=basis.jsfs2.data_ptr(),
            jsfs1=basis.jsfs1.data_ptr(), k1=basis.k1.data_ptr(),
            pidx=basis.pulse_idx.data_ptr(), pcoef=basis.pulse_coef.data_ptr(),
            pulse_len=basis.pulse_idx.shape[2], theta=THETA, cap=MAX_SUBSTEPS, degree=DEGREE)
        basis.kernel_cache["spectrum_args"] = tmpl
    return tmpl


def c_args(basis, a: SpectrumArgs, out: torch.Tensor, parts: torch.Tensor | None = None
           ) -> _Args:
    """The kernel's arguments for one call writing ``out`` (and ``parts``):
    the basis's constant part, copied, and the call's own."""
    c = _Args.from_buffer_copy(_tables(basis))
    c.lc, c.lc_ld, c.lc_rs = a.lc.data_ptr(), a.lc_ld, a.lc_rs
    c.mi, c.mi_ld, c.mi_rs = a.mi.data_ptr(), a.mi_ld, a.mi_rs
    c.pu, c.pu_ld, c.pu_rs = a.pu.data_ptr(), a.pu_ld, a.pu_rs
    c.t_pre, c.tp_ld, c.t_post, c.tq_ld = a.t_pre.data_ptr(), a.tp_ld, a.t_post.data_ptr(), a.tq_ld
    c.catmask, c.cm_ld, c.cm_rs = a.catmask.data_ptr(), a.cm_ld, a.cm_rs
    c.sample_row, c.sample_ld = a.sample_row, a.sample_ld
    c.sample = None if a.sample is None else a.sample.data_ptr()
    c.rebase, c.rebase_ld = int(a.rebase), a.rebase_ld
    c.rebase_mask = None if a.rebase_mask is None else a.rebase_mask.data_ptr()
    c.pulse_site = None if a.pulse_site is None else a.pulse_site.data_ptr()
    c.out, c.parts = out.data_ptr(), None if parts is None else parts.data_ptr()
    c.B, c.s, c.n_post = a.B, a.s, a.n_post
    return c


def spectrum_kernel(basis, a: SpectrumArgs, *, parts: torch.Tensor | None = None):
    """The (B, 7) spectrum of ``a`` (a `SpectrumArgs`) on the card; raises on
    anything the kernel does not take.  ``basis`` holds the constant tables
    on the same device.  With ``parts`` ((B, 3, 8) float64) the kernel also
    writes each lane's pre-split terms' sum, its post-split terms' sum
    (categories 0-6 of rows 0 and 1) and its 8-state p0 before the last
    interval (row 2).  The launch path is kept lean (attribute reads, one
    allocation, one ctypes call): it runs once per objective call."""
    lc = a.lc
    if not lc.is_cuda:
        raise ValueError(f"spectrum_kernel runs on a CUDA device, not {lc.device}")
    dev = lc.get_device()
    for x in (lc, a.mi, a.pu, a.t_pre, a.t_post, a.catmask, basis.sp2.vals, parts):
        if x is not None and (x.dtype is not _F64 or x.get_device() != dev):
            raise TypeError("spectrum_kernel takes float64 operands (the likelihood's dtype) "
                            "on one device")
    for x in (a.sample, a.rebase_mask, a.pulse_site):
        if x is not None and (x.dtype not in (torch.bool, torch.uint8) or x.get_device() != dev):
            raise TypeError("the sample masks and pulse sites are bool or uint8 on the device")
    B = a.B
    if parts is not None and (parts.shape != (B, 3, 8) or not parts.is_contiguous()):
        raise ValueError(f"expected a contiguous parts ({B}, 3, 8), got {tuple(parts.shape)}")
    out = lc.new_empty((B, Q))
    if B == 0:
        return out
    fn = _LIBS.get("fn") or _load()  # no lock once loaded
    c = c_args(basis, a, out, parts)
    err = fn(ctypes.addressof(c), dev, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"spectrum kernel launch failed: CUDA error {err}")
    spectrum_kernel.launches += 1
    return out


spectrum_kernel.launches = 0
