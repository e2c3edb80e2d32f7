"""Row-vector products with a constant matrix: CUDA kernel wrapper and its
plain version.

``row_matmul(v, K, cs)`` = sum_c cs[:, c] * (v @ K)[:, c*m:(c+1)*m]: the
spectrum's products with its constant matrices (engine/likelihood.py
`jafs_spectrum`: the collapse map, the last interval's JSFS projection, the
ancient-sample map; kernels/expm.py `expm_action_pair_plain`: N1 p0's
projection) and, with ``cs``, a weighted product with the stacked basis
(the width probe, probe.py).

* `row_matmul` is the wrapper: CPU tensors take `row_matmul_plain`, CUDA
  tensors launch the hand-written kernel (csrc/row_matmul.cu, float64
  only: the likelihood's dtype) or raise.  ``row_matmul.launches`` counts
  kernel launches.
* `row_matmul_plain` is the same sums in torch ops.

On the card the kernel keeps a lane's value independent of the batch it is
evaluated in, which a library GEMM does not (its algorithm follows the
number of rows); the sweep's staged compaction relies on that.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from .correction_fused import BUILD_DIR, compile_libs, stale

_CSRC = Path(__file__).resolve().parent / "csrc" / "row_matmul.cu"
_LIB_PATH = BUILD_DIR / "row_matmul_f64.so"
_LIBS: dict = {}
_LIB_LOCK = threading.Lock()
_F64 = torch.float64


def row_matmul_plain(v: torch.Tensor, K: torch.Tensor, cs: torch.Tensor | None = None):
    """v (B, n) @ K (n, C*m), the C blocks weighted by cs (B, C) and summed."""
    y = v @ K
    if cs is None:
        return y
    return (cs[..., None] * y.reshape(y.shape[:-1] + (cs.shape[-1], -1))).sum(-2)


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
            fn = lib.misti_row_matmul
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            lib.misti_row_matmul_attrs.argtypes = [ctypes.c_void_p]
            lib.misti_row_matmul_attrs.restype = ctypes.c_int
            _LIBS["lib"], _LIBS["fn"] = lib, fn
        return _LIBS["fn"]


def kernel_attrs() -> dict:
    """Registers per thread, local (spill) bytes per thread and resident
    blocks per SM at the path's largest product.  Needs a card."""
    buf = (ctypes.c_int * 3)()
    _load()
    err = _LIBS["lib"].misti_row_matmul_attrs(ctypes.addressof(buf))
    if err != 0:
        raise RuntimeError(f"misti_row_matmul_attrs failed: CUDA error {err}")
    return dict(registers=buf[0], local_bytes=buf[1], blocks_per_sm=buf[2])


def row_matmul(v: torch.Tensor, K: torch.Tensor, cs: torch.Tensor | None = None):
    """``row_matmul_plain`` on the CPU; the kernel on a CUDA tensor (raises
    on anything it does not take).  ``K`` is a constant table: it must be
    contiguous and is not copied.  The launch path is kept lean (a few
    attribute reads, one allocation, one ctypes call): on the path it is
    launched thrice per objective call and its device time is microseconds."""
    if not v.is_cuda:
        if v.is_cpu:
            return row_matmul_plain(v, K, cs)
        raise ValueError(f"unsupported device {v.device}")
    if v.dtype is not _F64 or K.dtype is not _F64 or (cs is not None and cs.dtype is not _F64):
        raise TypeError("row_matmul takes float64 operands (the likelihood's dtype)")
    dev = v.get_device()
    if K.get_device() != dev or (cs is not None and cs.get_device() != dev):
        raise TypeError("row_matmul operands must share a device")
    if v.dim() != 2 or K.dim() != 2 or v.shape[1] != K.shape[0] or not K.is_contiguous():
        raise ValueError(f"expected v (B, n) and a contiguous K (n, C*m), got "
                         f"{tuple(v.shape)}, {tuple(K.shape)}")
    B, n = v.shape
    C = 1
    if cs is not None:
        C = cs.shape[-1]
        if cs.dim() != 2 or cs.shape[0] != B or K.shape[1] % C:
            raise ValueError(f"expected cs (B, C) with C dividing {K.shape[1]}, got "
                             f"{tuple(cs.shape)}")
        cs = cs.contiguous()
    m = K.shape[1] // C
    v = v.contiguous()
    out = v.new_empty((B, m))
    if B == 0:
        return out
    fn = _LIBS.get("fn") or _load()  # no lock once loaded
    err = fn(v.data_ptr(), K.data_ptr(), None if cs is None else cs.data_ptr(), out.data_ptr(),
             B, n, m, C, dev, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"row_matmul kernel launch failed: CUDA error {err}")
    row_matmul.launches += 1
    return out


row_matmul.launches = 0
