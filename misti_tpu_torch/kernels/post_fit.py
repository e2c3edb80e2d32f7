"""The likelihood's post-split fit: CUDA kernel wrapper.

``post_fit(nc, lh_post, T_post, cpfit=...)`` launches csrc/post_fit.cu:
every lane's post-split rates and final carry in one launch, in either
residual mode (the ECT Jacobi rounds of root solves, a thread per (lane,
interval); the cpfit closed form, a thread per lane).  It is built in
float64 only, the likelihood's dtype (config.LLH_DTYPE).  Its plain version
is engine/likelihood.py `post_split_fit_plain`; `post_split_fit` there
takes this kernel for CUDA tensors and the plain version for CPU ones.

* ``post_fit.launches`` counts kernel launches.
* `post_fit_ops` / `post_fit_bytes` meter the work a call needs on its
  inputs (each root solve's own expansion count), for the kernel's bound.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from .correction_fused import BUILD_DIR, compile_libs, stale

_CSRC = Path(__file__).resolve().parent / "csrc" / "post_fit.cu"
_LIB_PATH = BUILD_DIR / "post_fit_f64.so"
_LIBS: dict = {}
_LIB_LOCK = threading.Lock()
_F64 = torch.float64
MAX_ECT_INTERVALS = 256  # one ECT block holds every interval of a lane
KERNELS = (("ect", 256), ("cpfit", 128))  # (kernel, threads a block)


def build_jobs(force: bool = False) -> list:
    """The nvcc job of this kernel's library (float64) for
    `correction_fused.compile_libs`; without ``force`` only if stale."""
    jobs = [(_LIB_PATH, _CSRC, torch.float64, False, ())]
    return jobs if force else stale(jobs)


def _load():
    with _LIB_LOCK:
        if "fn" not in _LIBS:
            compile_libs(build_jobs())
            lib = ctypes.CDLL(str(_LIB_PATH))
            fn = lib.misti_post_fit
            P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            fn.argtypes = [P, L, L, P, L, L, L, P, L, L, P, I, I, I, I, P]
            fn.restype = I
            lib.misti_post_fit_attrs.argtypes = [P]
            lib.misti_post_fit_attrs.restype = I
            _LIBS["lib"] = lib
            _LIBS["fn"] = fn
        return _LIBS["fn"]


def kernel_attrs() -> list:
    """Per kernel (ECT, cpfit): registers per thread, local (spill) bytes per
    thread and resident blocks per SM at its block size.  Needs a card."""
    buf = (ctypes.c_int * 6)()
    _load()
    err = _LIBS["lib"].misti_post_fit_attrs(ctypes.addressof(buf))
    if err != 0:
        raise RuntimeError(f"misti_post_fit_attrs failed: CUDA error {err}")
    return [dict(kernel=k, threads=th, registers=buf[3 * i], local_bytes=buf[3 * i + 1],
                 blocks_per_sm=buf[3 * i + 2]) for i, (k, th) in enumerate(KERNELS)]


def post_fit(nc: torch.Tensor, lh_post: torch.Tensor, T_post: torch.Tensor, *, cpfit: bool):
    """(lc_post (B, n, 2), nc_fin (B, 2)) on the card; raises on anything the
    kernel does not take.

    ``nc`` (B, 2), ``lh_post`` (L, n, 2) and ``T_post`` (L, n) with L = 1
    (one table for every lane) or B, float64, any strides.  Both outputs
    are views of one (B, 2n + 2) buffer."""
    dev = nc.get_device()
    for x in (nc, lh_post, T_post):
        if x.dtype is not _F64 or x.get_device() != dev:
            raise TypeError("post_fit takes float64 operands (the likelihood's dtype) on nc's "
                            f"device, not {x.dtype} on {x.device}")
    if not nc.is_cuda:
        raise ValueError(f"post_fit runs on a CUDA device, not {nc.device}")
    B, (L, n) = nc.shape[0], T_post.shape
    if (nc.dim() != 2 or nc.shape[1] != 2 or lh_post.shape != (L, n, 2) or L not in (1, B)
            or (not cpfit and n > MAX_ECT_INTERVALS)):
        raise ValueError(f"expected nc (B, 2), lh_post (L, n, 2), T_post (L, n) with L in "
                         f"(1, B) and n <= {MAX_ECT_INTERVALS} for ECT; got "
                         f"{tuple(nc.shape)}, {tuple(lh_post.shape)}, {tuple(T_post.shape)}")
    out = nc.new_empty((B, 2 * n + 2))
    if B:
        shared = L == 1
        fn = _LIBS.get("fn") or _load()  # no lock once loaded
        err = fn(nc.data_ptr(), nc.stride(0), nc.stride(1), lh_post.data_ptr(),
                 0 if shared else lh_post.stride(0), lh_post.stride(1), lh_post.stride(2),
                 T_post.data_ptr(), 0 if shared else T_post.stride(0), T_post.stride(1),
                 out.data_ptr(), B, n, int(cpfit), dev, torch._C._cuda_getCurrentRawStream(dev))
        if err != 0:
            raise RuntimeError(f"post_fit kernel launch failed: CUDA error {err}")
        post_fit.launches += 1
    return out[:, :2 * n].unflatten(1, (n, 2)), out[:, 2 * n:]


post_fit.launches = 0

# FP64 operations of the work the function needs (see `post_fit_ops`)
EXP_OPS = 20  # exp, expm1, log1p: a range reduction and a polynomial
DEV_OPS = 11  # one residual evaluation at its cheaper form
PREFIX_OPS = 2 + 2 + 1 + 2 + 2 * EXP_OPS + 1 + 2  # T*lc, prefix, carries, max, weights, sum, w/sum
SETUP_OPS = 5 * DEV_OPS + 3 + 3 + 2 + 3 + 2  # te_dev, x0, lower, the 3 tests, hi
STEP_OPS = DEV_OPS + 3  # a residual evaluation, its test and the new bound
CPFIT_ROW_OPS = 1 + EXP_OPS + 2 * (1 + EXP_OPS) + 4 + EXP_OPS + 1 + 3  # ed, masses, dpnc, lam, nc


def post_fit_ops(nc, lh_post, T_post, *, cpfit: bool) -> float:
    """FP64 operations one call needs on these inputs (`post_fit`'s
    arguments), counting each of the function's steps on the rows with
    T != 0 (a T == 0 row needs none: its rate is 1 and the carry stays).

    cpfit: per row CPFIT_ROW_OPS (the ratio exp(nc1 - nc0), the two
    expm1 masses, the deviation, -log1p over T, the carry).  ECT: per
    (lane, round, interval) PREFIX_OPS (T lc, the prefix add, the two
    carries, their max, the two weights, their normalisation), SETUP_OPS
    (five residual evaluations: the target's two, the upper branch's limit,
    the lower branch's two ends; x0, the lower bound, the tests, the
    bracket), STEP_OPS for each expansion test the solve needs (those that
    move hi, and the one that stops it; at most 40) and for each of the 60
    halvings, and the midpoint; per lane the final carry (2 n + 2).

    Costs: an add, a product, a division and a comparison each 1; exp,
    expm1 and log1p EXP_OPS; a residual evaluation DEV_OPS, the cheaper of
    the function's two forms (x = lam T, then the Bernoulli series in
    Horner form: x^2, four multiply-adds and a product; the direct form
    1/x - 1/expm1(x) - 1/2 costs 1 + EXP_OPS + 4), so that the bound stays
    a floor.  The expansion counts come from running the plain version
    on these inputs."""
    from ..engine.likelihood import _POST_OUTERS, post_split_fit_plain

    B, n = nc.shape[0], T_post.shape[1]
    live = (T_post != 0).expand(B, n)
    if cpfit or n == 0:
        return float(live.sum()) * CPFIT_ROW_OPS
    moves = []
    post_split_fit_plain(nc, lh_post, T_post, cpfit=False, moves=moves)
    tests = sum(float(torch.clamp(m + 1, max=40)[live].sum()) for m in moves)
    solves = float(live.sum()) * _POST_OUTERS
    return (solves * (PREFIX_OPS + SETUP_OPS + 60 * (STEP_OPS + 2) + 2) + tests * STEP_OPS
            + B * (2 * n + 2))


def post_fit_bytes(B: int, L: int, n: int, *, itemsize: int = 8) -> int:
    """Bytes a call must move: each input read once (nc, the L tables),
    each output written once (lc_post, nc_fin)."""
    return (2 * B + 3 * L * n + 2 * B * n + 2 * B) * itemsize
