"""The port's forward model (misti_tpu_torch.kernels.correction.coal_rates,
misti_tpu_torch.engine.forward.coalescent_rates) against the JAX package's,
float64 on the CPU."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FIXDIR
from misti_tpu.engine.forward import coalescent_rates as jax_coalescent_rates
from misti_tpu.engine.spec import build_spec as jax_build_spec
from misti_tpu.kernels.correction import coal_rates as jax_coal_rates
from misti_tpu_torch import build_spec
from misti_tpu_torch.engine.forward import coalescent_rates
from misti_tpu_torch.io import ms_parse
from misti_tpu_torch.kernels.correction import coal_rates

with open(os.path.join(FIXDIR, "readms_strings.json")) as _f:
    # the README scenario, and one with two migration bands and a pulse
    MS = dict(zip(["readme", "bands_pulse"], json.load(_f)))


def test_coal_rates_matches_jax():
    """A batch of lanes against the JAX function lane by lane, to 1e-12:
    rates and interval lengths over two decades, mixed entry states."""
    rng = np.random.default_rng(0)
    B = 9
    lc = rng.uniform(0.1, 5.0, (B, 2))
    mu = rng.uniform(0.0, 3.0, (B, 2))
    mu[::3] = 0.0
    T = 10.0 ** rng.uniform(-2, 0.5, B)
    p0 = rng.dirichlet(np.ones(3), (B, 2)) * rng.uniform(0.2, 1.0, (B, 2, 1))
    lh, p_out = coal_rates(*(torch.tensor(a) for a in (lc, mu, T, p0)))
    run = jax.jit(jax_coal_rates)
    for b in range(B):
        lh_j, p_j = run(jnp.asarray(lc[b]), jnp.asarray(mu[b]), jnp.asarray(T[b]),
                        jnp.asarray(p0[b]))
        np.testing.assert_allclose(lh[b].numpy(), np.asarray(lh_j), rtol=1e-12, atol=0)
        np.testing.assert_allclose(p_out[b].numpy(), np.asarray(p_j), rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("name", sorted(MS))
def test_coalescent_rates_matches_jax(name):
    """The ms scenario's trueEPS spec through both forward models: the
    mixed rates and the location probabilities, to 1e-12."""
    d = ms_parse.read_ms(MS[name])
    args = (d.times, d.lambdas, [1.0] * 8, d.divergence_time, d.mi, d.pu)
    spec = build_spec(*args, correct=False, unfolded=True)
    if name == "bands_pulse":
        assert np.any(spec.mi_base[:spec.splitT] != 0) and np.any(spec.pu_base != 0)
    lh, pr = coalescent_rates(spec, device="cpu")
    lh_j, pr_j = jax_coalescent_rates(jax_build_spec(*args, correct=False, unfolded=True))
    assert lh.shape == (spec.numT, 2) and pr.shape == (spec.splitT + 1, 3, 2)
    np.testing.assert_allclose(lh, lh_j, rtol=1e-12, atol=0)
    np.testing.assert_allclose(pr, pr_j, rtol=1e-12, atol=1e-15)


def test_coalescent_rates_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    d = ms_parse.read_ms(MS["readme"])
    spec = build_spec(d.times, d.lambdas, [1.0] * 8, d.divergence_time, d.mi, d.pu,
                      correct=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        coalescent_rates(spec)
