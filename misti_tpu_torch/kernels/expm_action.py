"""The spectrum's per-interval action (E p0, N1 p0): CUDA kernel wrapper.

``expm_action(kmat, coeffs, basis_norms, t, p0, ...)`` launches
csrc/expm_action.cu: every lane's Taylor sub-steps of one interval, and
optionally the projection of N1 p0 onto the JSFS categories, in one launch.
It is built in float64 only, the likelihood's dtype (config.LLH_DTYPE).
Its plain version is kernels/expm.py `expm_action_pair_plain` (the loop of
`row_matmul` products and torch ops the kernel replaces); `expm_action_pair`
there takes this kernel for CUDA tensors and the plain version for CPU ones.

* ``expm_action.launches`` counts kernel launches.
* `expm_action_ops` / `expm_action_bytes` meter a call's work from its
  per-lane sub-step counts, for the kernel's bound.
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
SHAPES = ((44, 4), (8, 1))  # (n, C): the pre-split and the post-split basis
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
            fn.argtypes = [P, P, L, P, P, L, P, P, I, P, L, P, P, P, I, I, I,
                           ctypes.c_double, I, I, P]
            fn.restype = I
            lib.misti_expm_action_attrs.argtypes = [P]
            lib.misti_expm_action_attrs.restype = I
            _LIBS["lib"] = lib
        return _LIBS["lib"]


def kernel_attrs() -> list:
    """Per (n, C) instance: registers per thread, local (spill) bytes per
    thread and resident blocks per SM.  Needs a card."""
    buf = (ctypes.c_int * 6)()
    err = _load().misti_expm_action_attrs(ctypes.addressof(buf))
    if err != 0:
        raise RuntimeError(f"misti_expm_action_attrs failed: CUDA error {err}")
    return [dict(n=n, C=C, registers=buf[3 * i], local_bytes=buf[3 * i + 1],
                 blocks_per_sm=buf[3 * i + 2]) for i, (n, C) in enumerate(SHAPES)]


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


def expm_action(kmat: torch.Tensor, coeffs: torch.Tensor, basis_norms: torch.Tensor, t,
                p0: torch.Tensor, *, theta: float = 2.0, degree: int = 20,
                max_substeps: int = 1024, jsfs: torch.Tensor | None = None,
                catmask: torch.Tensor | None = None):
    """(E p0, N1 p0, the projection or None) of one interval on the card;
    raises on anything the kernel does not take.

    ``kmat`` (n, C*n) with (n, C) in SHAPES, ``coeffs`` (B, C) (a view with
    a lane stride, e.g. one interval of (B, s, C)), ``basis_norms`` (C,),
    ``t`` a scalar, (1,) or (B,), ``p0`` (B, n); ``jsfs`` (n, Q) projects N1
    p0, scaled by ``catmask`` (Q,) or (B, Q) when given."""
    dev, dt = p0.device, p0.dtype
    if dev.type != "cuda":
        raise ValueError(f"expm_action runs on a CUDA device, not {dev}")
    if dt != torch.float64:
        raise TypeError(f"expm_action takes float64 (the likelihood's dtype), not {dt}")
    if not torch.is_tensor(t):
        t = torch.tensor([float(t)], dtype=dt, device=dev)
    t = t.reshape(-1)
    basis_norms = torch.as_tensor(basis_norms)
    ops = [kmat, coeffs, basis_norms, t] + [x for x in (jsfs, catmask) if x is not None]
    if any(x.dtype != dt or x.device != dev for x in ops):
        raise TypeError("expm_action operands must share p0's dtype and device")
    n = p0.shape[-1]
    B = p0.shape[0]
    C = coeffs.shape[-1] if coeffs.dim() == 2 else -1
    if p0.dim() != 2 or (n, C) not in SHAPES or tuple(kmat.shape) != (n, C * n):
        raise ValueError(f"expected p0 (B, n), coeffs (B, C), kmat (n, C*n) with (n, C) in "
                         f"{SHAPES}; got {tuple(p0.shape)}, {tuple(coeffs.shape)}, "
                         f"{tuple(kmat.shape)}")
    if coeffs.shape[0] != B or basis_norms.shape != (C,) or t.shape[0] not in (1, B):
        raise ValueError(f"expected coeffs ({B}, {C}), basis_norms ({C},), t (1,) or ({B},)")
    if not 1 <= degree <= MAX_DEGREE or max_substeps < 1 or not theta > 0:
        raise ValueError("expected 1 <= degree <= 32, max_substeps >= 1, theta > 0")
    c_ld = _lane_stride(coeffs, B, "coeffs")
    t_ld = _lane_stride(t[:, None], B, "t")
    Q, cm_ld = 0, 0
    if jsfs is not None:
        Q = jsfs.shape[1]
        if jsfs.dim() != 2 or jsfs.shape[0] != n or Q > n:
            raise ValueError(f"expected jsfs ({n}, Q <= {n}), got {tuple(jsfs.shape)}")
        jsfs = jsfs.contiguous()
        if catmask is not None:
            if catmask.shape[-1] != Q or catmask.dim() > 2:
                raise ValueError(f"expected catmask ({Q},) or ({B}, {Q}), got "
                                 f"{tuple(catmask.shape)}")
            cm_ld = _lane_stride(catmask, B, "catmask")
    elif catmask is not None:
        raise ValueError("catmask scales the projection: pass jsfs too")
    kmat, basis_norms, p0 = kmat.contiguous(), basis_norms.contiguous(), p0.contiguous()
    ep, n1p = torch.empty_like(p0), torch.empty_like(p0)
    proj = None if jsfs is None else torch.empty((B, Q), dtype=dt, device=dev)
    if B == 0:
        return ep, n1p, proj
    fn = _load().misti_expm_action
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(kmat.data_ptr(), coeffs.data_ptr(), c_ld, basis_norms.data_ptr(), t.data_ptr(),
                 t_ld, p0.data_ptr(), ptr(jsfs), Q, ptr(catmask), cm_ld, ep.data_ptr(),
                 n1p.data_ptr(), ptr(proj), B, n, C, float(theta), int(max_substeps),
                 int(degree), stream)
    if err != 0:
        raise RuntimeError(f"expm_action kernel launch failed: CUDA error {err}")
    expm_action.launches += 1
    return ep, n1p, proj


expm_action.launches = 0


def expm_action_ops(m: torch.Tensor, kmat: torch.Tensor, C: int, *, degree: int = 20,
                    Q: int = 0) -> float:
    """Arithmetic operations one call needs for per-lane sub-step counts
    ``m`` (B,) over the basis ``kmat`` (n, C*n): per lane, the step's scaled
    rates (C) and the generator sum_c cs_c B_c from the bases' nonzeros (a
    multiply-add each); per lane, sub-step and term a matvec with that
    generator over its nonzeros, the term's scale, the two sums and the pv
    term's scale (4 n); per sub-step the acc update (2 n); the projection
    (2 n Q + Q).  The kernel does more: to keep the plain loop's order it
    multiplies by each basis in turn, C dense (n, n) matvecs per term."""
    n = kmat.shape[0]
    nnz_bases = int(torch.count_nonzero(kmat))
    nnz_gen = int(torch.count_nonzero(kmat.reshape(n, C, n).abs().sum(1)))
    steps = float(m.double().sum())
    per_step = degree * (2 * nnz_gen + 4 * n) + 2 * n
    per_lane = C + 2 * nnz_bases + 2 * n * Q + Q
    return steps * per_step + int(m.numel()) * per_lane


def expm_action_bytes(B: int, n: int, C: int, *, itemsize: int, per_lane_t: bool,
                      Q: int = 0, per_lane_catmask: bool = False) -> int:
    """Bytes a call must move: each input read once, each output written once."""
    words = (n * C * n + B * C + C + (B if per_lane_t else 1) + B * n  # kmat .. p0
             + n * Q + (B * Q if per_lane_catmask else Q if Q else 0)  # jsfs, catmask
             + 2 * B * n + B * Q)  # E p0, N1 p0, projection
    return words * itemsize
