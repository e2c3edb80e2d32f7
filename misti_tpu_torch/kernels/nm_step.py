"""The Nelder-Mead simplex update in one launch per iteration: CUDA kernel
wrapper.

``NMRun(sim, fsim, it, nfev, aux_sum, ...)`` holds a lockstep Nelder-Mead
run's state on the card and steps it with csrc/nm_step.cu, one thread per
lane: a start launch orders the start or resumed simplex, tests it for
convergence and writes the first trial points; each ``step(fall, auxall)``
after an objective call applies scipy's update to every live lane, freezes
the halted ones, tests them again and writes the next trial points.  Both
count the live lanes into a device scalar that ``live_lanes()`` reads, the
run's one host read an iteration.  On the card its state and points are
bitwise those of engine/optimize.py's plain torch loop, the kernel's plain
version, which every CPU tensor takes.

* `takes` says whether the kernel steps a state: every CUDA state, with
  float64 or float32 simplexes (and aux counters) and the objective's
  values in float64 (the likelihood's dtype); it raises for a CUDA state in
  other dtypes, which no instance has.  Simplexes of 1 to ``MAX_N``
  parameters are stepped in registers, larger ones by the generic instance.
* ``nm_step.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from .correction_fused import BUILD_DIR, build_stale, stale

_CSRC = Path(__file__).resolve().parent / "csrc" / "nm_step.cu"
_LIB_PATH = BUILD_DIR / "nm_step.so"
_LIBS: dict = {}
_LIB_LOCK = threading.Lock()
_F32, _F64, _I64 = torch.float32, torch.float64, torch.int64
MAX_N = 4  # csrc/nm_step.cu kMaxN: the largest n with a register instance


def takes(sim, fsim, it, nfev, aux_sum) -> bool:
    """Whether the kernel steps this state (sim (B, n+1, n), fsim (B, n+1),
    it and nfev (B,), aux_sum (B, naux)): every state on a CUDA device, CPU
    states take the plain loop.  Raises TypeError for a CUDA state in dtypes
    that no instance has."""
    if sim.device.type != "cuda":
        return False
    if not (sim.dtype in (_F32, _F64) and fsim.dtype == _F64 and it.dtype == nfev.dtype == _I64
            and sim.shape[-1] >= 1
            and (aux_sum.shape[-1] == 0 or aux_sum.dtype == sim.dtype)):
        raise TypeError(
            f"nm_step has no instance for a simplex of {sim.shape[-1]} parameters in "
            f"{sim.dtype}, values in {fsim.dtype}, counters in {it.dtype} / {nfev.dtype} and "
            f"aux sums in {aux_sum.dtype}: it takes float64 or float32 simplexes with "
            f"float64 values, int64 counters and aux sums in the simplex's dtype")
    return True


def build_jobs(force: bool = False) -> list:
    """The nvcc job of this kernel's library for
    `correction_fused.compile_libs`, built without FMA contraction so that
    each expression rounds as its torch op does; without ``force`` only if
    stale."""
    jobs = [(_LIB_PATH, _CSRC, ("--fmad=false",))]
    return jobs if force else stale(jobs)


_P, _L, _D = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_double


class _Args(ctypes.Structure):
    """csrc/nm_step.cu `Args`, field for field (all 8 bytes wide)."""

    _fields_ = [(name, kind) for names, kind in (
        ("in_sim in_fsim in_it in_nfev in_aux fall auxall", _P),
        ("sim fsim it nfev aux live conv points count work fwork", _P),
        ("B n naux start slot maxiter s_f64", _L), ("xatol fatol", _D),
    ) for name in names.split()]


def _load():
    with _LIB_LOCK:
        if "fn" not in _LIBS:
            build_stale()
            lib = ctypes.CDLL(str(_LIB_PATH))
            fn = lib.misti_nm_step
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            lib.misti_nm_step_attrs.argtypes = [ctypes.c_void_p]
            lib.misti_nm_step_attrs.restype = ctypes.c_int
            if lib.misti_nm_step_args_size() != ctypes.sizeof(_Args):
                raise RuntimeError("csrc/nm_step.cu's Args and _Args differ in layout")
            if lib.misti_nm_step_max_n() != MAX_N:
                raise RuntimeError("csrc/nm_step.cu's kMaxN and MAX_N differ")
            _LIBS["lib"], _LIBS["fn"] = lib, fn
        return _LIBS["fn"]


def kernel_attrs() -> list:
    """Registers and local (spill) bytes per thread of each instance, as
    (simplex dtype, n, registers, local bytes), n being "generic" for the
    instance of every n above MAX_N.  Needs a card."""
    per = MAX_N + 1
    buf = (ctypes.c_int * (2 * 2 * per))()
    _load()
    err = _LIBS["lib"].misti_nm_step_attrs(ctypes.addressof(buf))
    if err != 0:
        raise RuntimeError(f"misti_nm_step_attrs failed: CUDA error {err}")
    return [(dt, n if n <= MAX_N else "generic", buf[2 * (p * per + n - 1)],
             buf[2 * (p * per + n - 1) + 1])
            for p, dt in enumerate(("float64", "float32")) for n in range(1, per + 1)]


def nm_step(args: _Args, device: int) -> None:
    """One launch of the kernel with ``args`` on ``device``'s current
    stream."""
    fn = _LIBS.get("fn") or _load()  # no lock once loaded
    err = fn(ctypes.addressof(args), device, torch._C._cuda_getCurrentRawStream(device))
    if err != 0:
        raise RuntimeError(f"nm_step kernel launch failed: CUDA error {err}")
    nm_step.launches += 1


nm_step.launches = 0


class NMRun:
    """A lockstep Nelder-Mead run's state on the card, stepped by the kernel.

    The constructor copies the start or resumed state (the caller's tensors
    are left as they are) into the run's own, ordered, and writes the first
    trial points; ``points`` is then the next objective call's input
    (B, n+5, n), a new tensor each iteration.  ``sim``, ``fsim``, ``it``,
    ``nfev``, ``aux_sum`` and ``conv`` (whether each lane has converged)
    hold the state after the last launch.  A run of no lanes launches
    nothing."""

    def __init__(self, sim, fsim, it, nfev, aux_sum, *, xatol: float, fatol: float,
                 maxiter: int):
        B, V, n = sim.shape
        sim, fsim, it, nfev, aux_sum = (t.contiguous() for t in (sim, fsim, it, nfev, aux_sum))
        self._dev = sim.get_device()
        self._shape = (B, n + 5, n)
        self.sim, self.fsim = torch.empty_like(sim), torch.empty_like(fsim)
        self.it, self.nfev = torch.empty_like(it), torch.empty_like(nfev)
        self.aux_sum = torch.empty_like(aux_sum)
        self._live = torch.empty(B, dtype=torch.bool, device=sim.device)
        self.conv = torch.empty(B, dtype=torch.bool, device=sim.device)
        count = (torch.empty if B else torch.zeros)(2, dtype=torch.int32, device=sim.device)
        self._count = (count[0], count[1])
        self.points = sim.new_empty(self._shape)
        # the generic instance's candidate simplex, past the register instances
        work, fwork = (torch.empty_like(sim), torch.empty_like(fsim)) if n > MAX_N else (None,) * 2
        self._work = (work, fwork)
        self._naux = aux_sum.shape[1]
        self._slot = 1
        self._args = c = _Args(
            in_sim=sim.data_ptr(), in_fsim=fsim.data_ptr(), in_it=it.data_ptr(),
            in_nfev=nfev.data_ptr(), in_aux=aux_sum.data_ptr(), sim=self.sim.data_ptr(),
            fsim=self.fsim.data_ptr(), it=self.it.data_ptr(), nfev=self.nfev.data_ptr(),
            aux=self.aux_sum.data_ptr(), live=self._live.data_ptr(), conv=self.conv.data_ptr(),
            points=self.points.data_ptr(), count=count.data_ptr(),
            work=work.data_ptr() if work is not None else None,
            fwork=fwork.data_ptr() if fwork is not None else None, B=B, n=n,
            naux=self._naux, start=1, slot=1, maxiter=maxiter,
            s_f64=int(sim.dtype is _F64), xatol=xatol, fatol=fatol)
        if B:
            nm_step(c, self._dev)
        c.start = 0

    def step(self, fall, auxall=None) -> None:
        """One iteration's update from the objective's values ``fall``
        (B, n+5, float64) of ``points`` and, with aux counters, their aux vectors
        ``auxall`` (B, n+5, naux) in the simplex's dtype."""
        B, P, _ = self._shape
        if fall.shape != (B, P) or fall.dtype is not _F64 or fall.get_device() != self._dev:
            raise TypeError(f"expected the objective's values ({B}, {P}) in float64 on the "
                            f"run's device, got {tuple(fall.shape)} {fall.dtype} on {fall.device}")
        c = self._args
        fall = fall.contiguous()  # held until the launch, as every operand is
        c.fall = fall.data_ptr()
        if self._naux:
            want = (B, P, self._naux)
            if auxall.shape != want or auxall.dtype is not self.aux_sum.dtype \
                    or auxall.get_device() != self._dev:
                raise TypeError(f"expected aux vectors {want} in {self.aux_sum.dtype} on the "
                                f"run's device, got {tuple(auxall.shape)} {auxall.dtype}")
            auxall = auxall.contiguous()
            c.auxall = auxall.data_ptr()
        points = self.points = fall.new_empty(self._shape, dtype=self.sim.dtype)
        c.points = points.data_ptr()
        self._slot = c.slot = 1 - self._slot
        if B:
            nm_step(c, self._dev)

    def live_lanes(self) -> int:
        """The lanes live after the last launch: the host's read, which waits
        for the card."""
        return int(self._count[self._slot].item())
