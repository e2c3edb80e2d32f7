"""The spectrum's row-vector products (misti_tpu_torch/kernels/row_matmul.py).

On the CPU: the plain version against the JAX package's matvec of
``expm_action_pair`` and its other basis products, each lane's value the
same in every batch, the wrapper taking the plain version for CPU tensors,
and the spectrum's products with its constant matrices going through it.
The CUDA kernel itself (float64 only) runs only on a card: those tests skip
here.
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
    """The spectrum's products with its constant matrices go through
    row_matmul: the ancient-sample map where the sample enters, the
    collapse map at the split and the last interval's projection; and the
    series' projection of N1 p0 (kernels/expm.py) too."""
    from misti_tpu_torch.engine import likelihood as lk
    from misti_tpu_torch.kernels import expm as kexpm

    basis = SpectrumBasis(torch.device("cpu"), torch.float64)
    rng = np.random.default_rng(3)
    B, s, n_post = 5, 4, 2
    tens = lambda a: torch.tensor(a, dtype=torch.float64)  # noqa: E731
    lc = tens(rng.uniform(0.5, 2.0, (B, s + n_post + 1, 2)))
    mi = tens(rng.uniform(0.0, 0.5, (B, s, 2)))
    pu = torch.zeros((B, s, 2), dtype=torch.float64)
    T_pre, T_post = tens(rng.uniform(0.05, 0.2, (1, s))), tens(rng.uniform(0.1, 0.3, (1, n_post)))
    catmask = torch.ones((s, 7), dtype=torch.float64)
    sample_at = [True if t == 1 else None for t in range(s)]
    pulse_site = np.zeros((s, 2), dtype=bool)
    seen = {"likelihood": [], "expm": []}
    origs = (lk.row_matmul, kexpm.row_matmul)

    def rec(where, orig):
        return lambda v, K, cs=None: seen[where].append(tuple(K.shape)) or orig(v, K, cs)

    lk.row_matmul, kexpm.row_matmul = rec("likelihood", origs[0]), rec("expm", origs[1])
    try:
        jafs = lk.jafs_spectrum(basis, lc, mi, pu, T_pre, T_post, catmask, sample_at, None,
                                pulse_site)
    finally:
        lk.row_matmul, kexpm.row_matmul = origs
    assert jafs.shape == (B, 7) and bool(torch.isfinite(jafs).all())
    assert seen["likelihood"] == [(44, 44), (44, 8), (8, 7)]
    assert seen["expm"] == [(44, 7)] * s + [(8, 7)] * n_post


def test_kernel_matches_plain_on_card(cuda):
    """Float64 (the likelihood's dtype): rtol 1e-6 / atol 1e-9 at every
    product, the first 1 / 6 / 42 / 960 lanes alone bitwise as in the
    batch, a batch that fills no whole block (4851 lanes), the counter."""
    rtol, atol = 1e-6, 1e-9
    for _, attr, C in CASES:
        v, K, cs = _inputs(attr, C, 4851, torch.float64, cuda)
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
    with pytest.raises(TypeError):  # built in float64 only
        rm.row_matmul(v.float(), K.float(), cs.float())
    with pytest.raises(TypeError):
        rm.row_matmul(v, K.float(), cs)
    with pytest.raises(ValueError):
        rm.row_matmul(v[:, :40], K, cs)
    with pytest.raises(ValueError):
        rm.row_matmul(v, K, cs[:, :3])
    with pytest.raises(ValueError):  # a constant table is not copied
        rm.row_matmul(v[:, :8], SpectrumBasis(cuda, torch.float64).k1.T)
