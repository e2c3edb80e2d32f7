"""The spectrum's per-interval action (E p0, N1 p0): CUDA kernel wrapper.

``expm_action(basis, coeffs, basis_norms, t, p0, ...)`` launches
csrc/expm_action.cu: every lane's Taylor sub-steps of one interval, a warp
per lane over its own sparse generator (``basis`` a kernels/expm.py
`SparseBasis`), and optionally the projection of N1 p0 onto the JSFS
categories, in one launch.  It is built in float64 only, the likelihood's
dtype (config.LLH_DTYPE).  Its plain version is kernels/expm.py
`expm_action_pair_plain`; `expm_action_pair` there takes this kernel for
CUDA tensors and the plain version for CPU ones.

* ``expm_action.launches`` counts kernel launches.
* `expm_action_ops` / `expm_action_bytes` meter the work a call needs on
  its inputs (each lane's own sub-step count), for the kernel's bound.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from .correction_fused import BUILD_DIR, compile_libs, stale

_CSRC = Path(__file__).resolve().parent / "csrc" / "expm_action.cu"
_LIB_PATH = BUILD_DIR / "expm_action_f64.so"
_LIBS: dict = {}
_LIB_LOCK = threading.Lock()
_F64 = torch.float64
SHAPES = ((44, 4, 5), (8, 1, 3))  # (n, C, L): the pre-split and the post-split basis
MAX_DEGREE = 32


def build_jobs(force: bool = False) -> list:
    """The nvcc job of this kernel's library for
    `correction_fused.compile_libs`; without ``force`` only if stale."""
    jobs = [(_LIB_PATH, _CSRC, torch.float64, False, ())]
    return jobs if force else stale(jobs)


def _load():
    with _LIB_LOCK:
        if "lib" not in _LIBS:
            compile_libs(build_jobs())
            lib = ctypes.CDLL(str(_LIB_PATH))
            fn = lib.misti_expm_action
            P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            fn.argtypes = [P, P, P, I, I, P, L, P, P, L, P, P, I, P, L, P, P, P, I, I, I,
                           ctypes.c_double, I, I, I, P]
            fn.restype = I
            lib.misti_expm_action_attrs.argtypes = [P]
            lib.misti_expm_action_attrs.restype = I
            _LIBS["lib"] = lib
            _LIBS["fn"] = fn
        return _LIBS["fn"]


def kernel_attrs() -> list:
    """Per (n, C, L) instance: registers per thread, local (spill) bytes per
    thread and resident blocks per SM.  Needs a card."""
    buf = (ctypes.c_int * 6)()
    _load()
    err = _LIBS["lib"].misti_expm_action_attrs(ctypes.addressof(buf))
    if err != 0:
        raise RuntimeError(f"misti_expm_action_attrs failed: CUDA error {err}")
    return [dict(n=n, C=C, L=L, registers=buf[3 * i], local_bytes=buf[3 * i + 1],
                 blocks_per_sm=buf[3 * i + 2]) for i, (n, C, L) in enumerate(SHAPES)]


def _lane_stride(x: torch.Tensor, B: int, name: str) -> int:
    """Lane stride of a (B, k) or (1, k) / (k,) operand (0: shared by every
    lane); its last axis must be contiguous."""
    if x.dim() == 1 or x.shape[0] == 1:
        if x.dim() == 2 and x.shape[1] > 1 and x.stride(1) != 1:
            raise ValueError(f"{name}: the last axis must be contiguous")
        return 0
    if x.shape[0] != B or (x.shape[1] > 1 and x.stride(1) != 1):
        raise ValueError(f"{name}: expected ({B}, k) with a contiguous last axis, got "
                         f"{tuple(x.shape)} strides {x.stride()}")
    return x.stride(0)


def expm_action(basis, coeffs: torch.Tensor, basis_norms: torch.Tensor, t,
                p0: torch.Tensor, *, theta: float = 2.0, degree: int = 20,
                max_substeps: int = 1024, jsfs: torch.Tensor | None = None,
                catmask: torch.Tensor | None = None):
    """(E p0, N1 p0, the projection or None) of one interval on the card;
    raises on anything the kernel does not take.

    ``basis`` a `SparseBasis` (its tables on p0's device) with (n, C, L) in
    SHAPES, ``coeffs`` (B, C) (a view with a lane stride, e.g. one interval
    of (B, s, C)), ``basis_norms`` (C,), ``t`` a scalar, (1,) or (B,),
    ``p0`` (B, n); ``jsfs`` (n, Q) projects N1 p0, scaled by ``catmask``
    (Q,) or (B, Q) when given.  The launch path is kept lean (attribute
    reads, three allocations, one ctypes call): the spectrum makes some 60
    of these calls per objective call."""
    if not p0.is_cuda:
        raise ValueError(f"expm_action runs on a CUDA device, not {p0.device}")
    if p0.dtype is not _F64:
        raise TypeError(f"expm_action takes float64 (the likelihood's dtype), not {p0.dtype}")
    dev = p0.get_device()
    if not torch.is_tensor(t):
        t = torch.tensor([float(t)], dtype=_F64, device=p0.device)
    elif t.dim() != 1:
        t = t.reshape(-1)
    for x in (basis.vals, coeffs, basis_norms, t, jsfs, catmask):
        if x is not None and (x.dtype is not _F64 or x.get_device() != dev):
            raise TypeError("expm_action operands must share p0's dtype and device")
    n, C, L = basis.n, basis.C, basis.L
    B = p0.shape[0]
    if (n, C, L) not in SHAPES or p0.dim() != 2 or p0.shape[1] != n or coeffs.dim() != 2:
        raise ValueError(f"expected p0 (B, n), coeffs (B, C) and a basis with (n, C, L) in "
                         f"{SHAPES}; got {tuple(p0.shape)}, {tuple(coeffs.shape)}, "
                         f"{(n, C, L)}")
    if coeffs.shape != (B, C) or basis_norms.shape != (C,) or t.shape[0] not in (1, B):
        raise ValueError(f"expected coeffs ({B}, {C}), basis_norms ({C},), t (1,) or ({B},)")
    if not 1 <= degree <= MAX_DEGREE or max_substeps < 1 or not theta > 0:
        raise ValueError("expected 1 <= degree <= 32, max_substeps >= 1, theta > 0")
    c_ld = _lane_stride(coeffs, B, "coeffs")
    t_ld = 0 if t.shape[0] == 1 else t.stride(0)
    Q, cm_ld = 0, 0
    if jsfs is not None:
        Q = jsfs.shape[1]
        if jsfs.dim() != 2 or jsfs.shape[0] != n or Q > n or not jsfs.is_contiguous():
            raise ValueError(f"expected a contiguous jsfs ({n}, Q <= {n}), got "
                             f"{tuple(jsfs.shape)}")
        if catmask is not None:
            if catmask.shape[-1] != Q or catmask.dim() > 2:
                raise ValueError(f"expected catmask ({Q},) or ({B}, {Q}), got "
                                 f"{tuple(catmask.shape)}")
            cm_ld = _lane_stride(catmask, B, "catmask")
    elif catmask is not None:
        raise ValueError("catmask scales the projection: pass jsfs too")
    p0 = p0.contiguous()
    ep, n1p = torch.empty_like(p0), torch.empty_like(p0)
    proj = None if jsfs is None else p0.new_empty((B, Q))
    if B == 0:
        return ep, n1p, proj
    fn = _LIBS.get("fn") or _load()  # no lock once loaded
    err = fn(basis.src.data_ptr(), basis.slot.data_ptr(), basis.vals.data_ptr(), basis.nnz, L,
             coeffs.data_ptr(), c_ld, basis_norms.data_ptr(), t.data_ptr(), t_ld,
             p0.data_ptr(), None if jsfs is None else jsfs.data_ptr(), Q,
             None if catmask is None else catmask.data_ptr(), cm_ld, ep.data_ptr(),
             n1p.data_ptr(), None if proj is None else proj.data_ptr(), B, n, C, float(theta),
             int(max_substeps), int(degree), dev, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"expm_action kernel launch failed: CUDA error {err}")
    expm_action.launches += 1
    return ep, n1p, proj


expm_action.launches = 0


def expm_action_ops(basis, coeffs: torch.Tensor, basis_norms, t, *, theta: float = 2.0,
                    degree: int = 20, max_substeps: int = 1024, Q: int = 0) -> float:
    """Arithmetic operations one call needs on these inputs (`expm_action`'s
    arguments, ``basis`` a `SparseBasis`), from each lane's own sub-step
    count: per lane that runs the series, the step's scaled rates (C) and
    the generator sum_c cs_c B_c from the bases' nonzeros (a multiply-add
    each); per sub-step and term a matvec with that generator over its
    nonzeros, the term's scale, the two sums and the pv term's scale (4 n);
    per sub-step the acc update (2 n).  A lane with t == 0 (p0 and 0) or
    past the cap (NaN) needs no series.  Every lane: the projection
    (2 n Q + Q).  The kernel's matvec runs over each state's nonzeros padded
    to the longest column (n L products: 220 against 196 at k2), and it
    forms each generator entry from all C bases (2 C - 1 operations)."""
    from .expm import substep_counts  # kernels/expm.py imports this module

    m, overflow = substep_counts(coeffs, basis_norms, t, theta, max_substeps)
    tt = torch.as_tensor(t, dtype=coeffs.dtype, device=coeffs.device).reshape(-1)
    series = ~overflow & (tt != 0)
    n, C = basis.n, basis.C
    nnz_bases = int(torch.count_nonzero(basis.vals))
    steps = float(m[series].double().sum())
    per_step = degree * (2 * basis.nnz + 4 * n) + 2 * n
    per_lane = C + 2 * nnz_bases
    return (steps * per_step + int(series.sum()) * per_lane
            + int(m.numel()) * (2 * n * Q + Q))


def expm_action_bytes(B: int, basis, *, itemsize: int, per_lane_t: bool, Q: int = 0,
                      per_lane_catmask: bool = False) -> int:
    """Bytes a call must move: each input read once, each output written
    once; the basis as the kernel reads it, its `SparseBasis` tables."""
    n, C = basis.n, basis.C
    tables = 2 * n * basis.L * basis.src.element_size()  # src, slot
    words = (C * basis.nnz + B * C + C + (B if per_lane_t else 1) + B * n  # vals .. p0
             + n * Q + (B * Q if per_lane_catmask else Q if Q else 0)  # jsfs, catmask
             + 2 * B * n + B * Q)  # E p0, N1 p0, projection
    return tables + words * itemsize
