"""Device and dtype resolution for the PyTorch port.

Entry points take an explicit ``device`` and ``dtype``.  The default device
is ``cuda``: with no card, resolution raises instead of quietly picking the
CPU (tests and CPU users pass ``device="cpu"``).  A run's dtype is that of
its parameters and its optimiser's simplex: float64 on every device, as the
JAX package's is where its platform has float64 (its CPU) and as upstream
MiSTI's is.  The JAX package's float32 on the TPU came from the v5e having
no float64; the H100 has it, and a float32 simplex there stops short of the
float64 optimum at no gain in speed (ROADMAP C5, PERF.md).  A caller may
still pass ``dtype=torch.float32``.  The likelihood itself computes in
``LLH_DTYPE`` (float64) whatever the run's dtype.
"""

from __future__ import annotations

import torch

# TF32 keeps ~10 mantissa bits.  The spectrum's (B, 44) @ (44, 176) basis
# products and the 8x8 last-interval solve are exactly the float32 products
# TF32 would truncate: the same chains went wrong on the TPU under one-pass
# bf16 matmuls (max |dllh| 6-22 against the f64 reference, enough to flip
# the optimiser's argmax).  Pin both switches to full float32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Every stage of the likelihood, and the llh it returns, in float64.  The
# llh is a difference of category terms over ~1e5 sites, so it needs ~1e-9
# relative precision in the spectrum: in float32 every tensor passed between
# stages (rates, carry, state vector) added ~1e-4 nats of noise, ~2e-3 in
# all, above the optimiser's 1e-4 fatol, and float32 sweeps left cells that
# never converged (PERF.md section 6, tests/torch_float32_noise_stages.py).
LLH_DTYPE = torch.float64


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA; asking for CUDA without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def resolve_dtype(device: torch.device, dtype=None) -> torch.dtype:
    """A run's dtype: float64 on every device, unless given."""
    return torch.float64 if dtype is None else dtype
