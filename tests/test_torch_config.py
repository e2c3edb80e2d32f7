"""The port's dtype policy: a run's parameters and simplex are float64 on
every device unless the caller asks for another dtype; the likelihood
computes in float64 either way."""

import pytest
import torch

from misti_tpu_torch.config import LLH_DTYPE, resolve_dtype


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_resolve_dtype_is_float64_unless_given(device):
    dev = torch.device(device)  # resolving a dtype needs no card
    assert resolve_dtype(dev) == torch.float64
    assert resolve_dtype(dev, None) == torch.float64
    assert resolve_dtype(dev, torch.float32) == torch.float32
    assert LLH_DTYPE == torch.float64
