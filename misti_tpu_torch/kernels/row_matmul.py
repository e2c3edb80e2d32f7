"""Row-vector products with a constant matrix: CUDA kernel wrapper and its
plain version.

``row_matmul(v, K, cs)`` = sum_c cs[:, c] * (v @ K)[:, c*m:(c+1)*m]: the
spectrum's Taylor sub-step matvec against the stacked basis (``cs`` the
lane's scaled rates, kernels/expm.py `expm_action_pair`) and, without
``cs``, its products with the JSFS projections and the ancient-sample and
collapse maps (engine/likelihood.py `jafs_spectrum`).

* `row_matmul` is the wrapper: CPU tensors take `row_matmul_plain`, CUDA
  tensors launch the hand-written kernel (csrc/row_matmul.cu) or raise.
  ``row_matmul.launches`` counts kernel launches.
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

from .correction_fused import _DTYPES, BUILD_DIR, compile_libs, stale

_CSRC = Path(__file__).resolve().parent / "csrc" / "row_matmul.cu"
_LIBS: dict = {}
_LIB_LOCK = threading.Lock()


def row_matmul_plain(v: torch.Tensor, K: torch.Tensor, cs: torch.Tensor | None = None):
    """v (B, n) @ K (n, C*m), the C blocks weighted by cs (B, C) and summed."""
    y = v @ K
    if cs is None:
        return y
    return (cs[..., None] * y.reshape(y.shape[:-1] + (cs.shape[-1], -1))).sum(-2)


def _lib_path(dtype: torch.dtype) -> Path:
    return BUILD_DIR / f"row_matmul_{_DTYPES[dtype][1]}.so"


def build_jobs(force: bool = False) -> list:
    """The nvcc jobs of this kernel's libraries (one per dtype) for
    `correction_fused.compile_libs`; without ``force`` only stale ones."""
    jobs = [(_lib_path(d), _CSRC, d, False, ()) for d in _DTYPES]
    return jobs if force else stale(jobs)


def _load(dtype: torch.dtype):
    with _LIB_LOCK:
        if dtype not in _LIBS:
            compile_libs([j for j in build_jobs() if j[2] == dtype])
            fn = ctypes.CDLL(str(_lib_path(dtype))).misti_row_matmul
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _LIBS[dtype] = fn
        return _LIBS[dtype]


def row_matmul(v: torch.Tensor, K: torch.Tensor, cs: torch.Tensor | None = None):
    """``row_matmul_plain`` on the CPU; the kernel on a CUDA tensor (raises
    on anything it does not take)."""
    if v.device.type == "cpu":
        return row_matmul_plain(v, K, cs)
    if v.device.type != "cuda":
        raise ValueError(f"unsupported device {v.device}")
    if v.dtype not in _DTYPES:
        raise TypeError(f"row_matmul takes float32 or float64, not {v.dtype}")
    ops = (v, K) if cs is None else (v, K, cs)
    if any(t.dtype != v.dtype or t.device != v.device for t in ops):
        raise TypeError("row_matmul operands must share dtype and device")
    if v.dim() != 2 or K.dim() != 2 or v.shape[1] != K.shape[0]:
        raise ValueError(f"expected v (B, n) and K (n, C*m), got {tuple(v.shape)}, "
                         f"{tuple(K.shape)}")
    C = 1 if cs is None else cs.shape[-1]
    if cs is not None and (cs.dim() != 2 or cs.shape[0] != v.shape[0]
                           or K.shape[1] % C):
        raise ValueError(f"expected cs (B, C) with C dividing {K.shape[1]}, got "
                         f"{tuple(cs.shape)}")
    v, K = v.contiguous(), K.contiguous()
    cs = None if cs is None else cs.contiguous()
    B, n, m = v.shape[0], v.shape[1], K.shape[1] // C
    out = torch.empty((B, m), dtype=v.dtype, device=v.device)
    if B == 0:
        return out
    fn = _load(v.dtype)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = fn(v.data_ptr(), K.data_ptr(), None if cs is None else cs.data_ptr(),
                 out.data_ptr(), B, n, m, C, stream)
    if err != 0:
        raise RuntimeError(f"row_matmul kernel launch failed: CUDA error {err}")
    row_matmul.launches += 1
    return out


row_matmul.launches = 0
