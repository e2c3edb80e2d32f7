"""PyTorch/CUDA port of misti_tpu: batched MiSTI likelihoods on an NVIDIA GPU.

The pre-split lambda-correction sweep runs as a hand-written CUDA kernel on
the card (kernels/csrc/correction_sweep.cu) and as its plain torch version on
the CPU.  Entry points take ``device`` (default CUDA) and ``dtype``.
"""

from .engine.likelihood import Likelihood, build_likelihood
from .engine.optimize import SolveResult, solve
from .engine.spec import ModelSpec, build_spec, params_from_jax

__all__ = ["Likelihood", "ModelSpec", "SolveResult", "build_likelihood", "build_spec",
           "params_from_jax", "solve"]
