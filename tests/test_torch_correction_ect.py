"""The port's fused sweep in expected-coalescence-time mode (upstream MiSTI's
default residual) against the JAX package's CPU form of the TPU kernel.

Its own file so the two slowest JAX compiles of the parity tests run on
another worker than the cpfit ones (test_torch_correction_fused.py).
"""

from _torch_sweep_cases import assert_sweeps_agree, draw


def test_plain_sweep_matches_jax_ect_with_migration():
    """One combined LM: the no-migration lane takes the series residual and
    its bound, the others the moment residual."""
    lh, times, mi, pu = draw(21)
    assert_sweeps_agree(lh, times, mi, pu, cpfit=False, has_pulse=False)


def test_plain_sweep_matches_jax_ect_static_no_mig():
    lh, times, mi, pu = draw(22, mig=False)
    assert_sweeps_agree(lh, times, mi, pu, cpfit=False, static_no_mig=True,
                        has_pulse=False)
