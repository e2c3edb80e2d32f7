"""The spectrum's row-vector products (misti_tpu_torch/kernels/row_matmul.py).

On the CPU: the plain version against the JAX package's matvec of
``expm_action_pair`` and its other basis products, each lane's value the
same in every batch, and the wrapper taking the plain version for CPU
tensors.  The CUDA kernel itself runs only on a card: those tests skip here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from misti_tpu_torch.engine.likelihood import SpectrumBasis
from misti_tpu_torch.kernels import row_matmul as rm

# the spectrum's instances: (name, basis attribute, C weights per lane)
CASES = [("k2", "k2", 4), ("k1", "k1", 1), ("jsfs2", "jsfs2", 0), ("jsfs1", "jsfs1", 0),
         ("ancientT", "ancientT", 0), ("collapseT", "collapseT", 0)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the row_matmul kernel has no CPU form")
    return torch.device("cuda")


def _inputs(attr, C, B, dtype=torch.float64, device="cpu", seed=0):
    K = getattr(SpectrumBasis(torch.device(device), dtype), attr)
    rng = np.random.default_rng(seed)
    v = torch.tensor(rng.uniform(0.0, 1.0, (B, K.shape[0])), dtype=dtype, device=device)
    cs = torch.tensor(rng.uniform(0.0, 0.5, (B, C)), dtype=dtype, device=device) if C else None
    return v, K, cs


@pytest.mark.parametrize("name, attr, C", CASES, ids=[c[0] for c in CASES])
def test_plain_matches_jax_products(name, attr, C):
    """The JAX package's forms: ``expm_action_pair``'s matvec
    ``sum_c cs[:, c] * (v @ kmat)[:, c]`` and the plain ``v @ M``."""
    v, K, cs = _inputs(attr, C, 9)
    y = jnp.asarray(v.numpy()) @ jnp.asarray(K.numpy())
    if C:
        y = (jnp.asarray(cs.numpy())[..., None] * y.reshape(9, C, -1)).sum(-2)
    np.testing.assert_allclose(rm.row_matmul_plain(v, K, cs).numpy(), np.asarray(y),
                               rtol=1e-13, atol=1e-16)


@pytest.mark.parametrize("name, attr, C", CASES, ids=[c[0] for c in CASES])
def test_cpu_lane_values_do_not_depend_on_the_batch(name, attr, C):
    """In float64, the CPU's dtype, every prefix of a batch and a strided
    pick give each lane the value it has in the whole batch, bitwise (the
    CPU's float32 product of one row may round otherwise); the CPU takes the
    plain version and launches nothing."""
    before = rm.row_matmul.launches
    v, K, cs = _inputs(attr, C, 500)
    full = rm.row_matmul(v, K, cs)
    assert torch.equal(full, rm.row_matmul_plain(v, K, cs))
    for sel in (slice(0, 1), slice(0, 6), slice(0, 42), slice(3, 500, 7)):
        part = rm.row_matmul(v[sel], K, None if cs is None else cs[sel])
        assert torch.equal(part, full[sel]), sel
    assert rm.row_matmul.launches == before


def test_expm_action_pair_uses_it():
    """The spectrum's sub-step matvec goes through row_matmul."""
    from misti_tpu_torch.kernels import expm as kexpm

    seen = []
    orig = kexpm.row_matmul
    kexpm.row_matmul = lambda v, K, cs=None: seen.append(K.shape) or orig(v, K, cs)
    try:
        v, K, cs = _inputs("k2", 4, 5)
        kexpm.expm_action_pair(K, cs, SpectrumBasis(torch.device("cpu"), torch.float64).norms2,
                               0.3, torch.softmax(v, -1))
    finally:
        kexpm.row_matmul = orig
    assert seen and all(s == (44, 176) for s in seen)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_kernel_matches_plain_on_card(cuda, dtype):
    rtol, atol = (1e-6, 1e-9) if dtype == torch.float64 else (1e-4, 1e-6)
    for _, attr, C in CASES:
        v, K, cs = _inputs(attr, C, 4851, dtype, cuda)
        before = rm.row_matmul.launches
        got = rm.row_matmul(v, K, cs)
        torch.cuda.synchronize()
        assert rm.row_matmul.launches == before + 1
        torch.testing.assert_close(got, rm.row_matmul_plain(v, K, cs), rtol=rtol, atol=atol)
        for w in (1, 6, 42, 960):
            part = rm.row_matmul(v[:w], K, None if cs is None else cs[:w])
            assert torch.equal(part, got[:w])


def test_kernel_rejects_what_it_does_not_take(cuda):
    v, K, cs = _inputs("k2", 4, 8, torch.float64, cuda)
    with pytest.raises(TypeError):
        rm.row_matmul(v.half(), K, cs)
    with pytest.raises(TypeError):
        rm.row_matmul(v, K.float(), cs)
    with pytest.raises(ValueError):
        rm.row_matmul(v[:, :40], K, cs)
    with pytest.raises(ValueError):
        rm.row_matmul(v, K, cs[:, :3])
