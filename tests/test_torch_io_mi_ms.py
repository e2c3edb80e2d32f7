"""The port's own copies of the .mi format and the ms command parser
(misti_tpu_torch.io.mi_format, misti_tpu_torch.io.ms_parse) against the JAX
package's and upstream's fixtures."""

import dataclasses
import json
import os

import numpy as np
import pytest

from conftest import FIXDIR, load_fixture
from misti_tpu.io import mi_format as jax_mi_format
from misti_tpu.io import ms_parse as jax_ms_parse
from misti_tpu_torch.io import mi_format, ms_parse

MI_FIXTURES = ["ref_fit.mi", "ref_fit_pu.mi", "ref_fit_sdate.mi"]


def _format_args(d):
    """format_migration's arguments rebuilt from a parsed .mi file."""
    cum = np.asarray(d.times) / d.scale_time
    n = len(cum)
    split = d.split_t
    pr = np.zeros((n, 3, 2))
    pr[:, 0] = np.asarray(d.pr11).T
    pr[:, 1] = np.asarray(d.pr22).T
    pr[:, 2] = np.asarray(d.pr12).T
    return dict(
        llh=d.llh, split_t=split, sample_date=d.sample_date, thrh=d.thrh,
        jafs=np.asarray(d.jafs), data_jafs=np.asarray(d.jafs) * 1000.0,
        times=list(np.diff(cum)),
        lc=np.stack([d.lambda1, d.lambda2], axis=1) * d.scale_eps,
        lh=np.stack([d.lambdah1, d.lambdah2], axis=1) * d.scale_eps,
        mi=np.stack([d.mu1, d.mu2], axis=1), pr=pr[:max(split, 1)],
        scale_time=d.scale_time, scale_eps=d.scale_eps,
    )


@pytest.mark.parametrize("name", MI_FIXTURES)
def test_format_migration_byte_identical_to_jax(name, tmp_path):
    path = os.path.join(FIXDIR, name)
    ours = mi_format.read_migration(path)
    ref = jax_mi_format.read_migration(path)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)

    args = _format_args(ours)
    text = mi_format.format_migration(**args)
    assert text == jax_mi_format.format_migration(**args)
    # written and read back, the file holds what was formatted
    out = tmp_path / "back.mi"
    mi_format.write_migration(str(out), text)
    assert out.read_text() == text
    back = mi_format.read_migration(str(out))
    np.testing.assert_allclose(back.llh, ours.llh, rtol=1e-15)
    np.testing.assert_allclose(back.lambda1, ours.lambda1, rtol=1e-14)
    np.testing.assert_allclose(np.asarray(back.pr11), np.asarray(ours.pr11), rtol=1e-15)


def _read_ms_strings():
    with open(os.path.join(FIXDIR, "readms_strings.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("i", range(len(_read_ms_strings())))
def test_read_ms_matches_reference_and_jax(i):
    """Each ms string against upstream's ReadMS output (readms.npz) and the
    JAX package's parser, field by field."""
    fx = load_fixture("readms.npz")
    s = _read_ms_strings()[i]
    d = ms_parse.read_ms(s)
    np.testing.assert_array_equal(np.asarray(d.times), fx[f"s{i}_times"])
    np.testing.assert_array_equal(np.asarray(d.lambdas), fx[f"s{i}_lambdas"])
    assert d.divergence_time == int(fx[f"s{i}_split"])
    np.testing.assert_array_equal(np.asarray(d.mi, dtype=float).reshape(-1, 5), fx[f"s{i}_mi"])
    np.testing.assert_array_equal(np.asarray(d.pu, dtype=float).reshape(-1, 4), fx[f"s{i}_pu"])
    assert dataclasses.asdict(d) == dataclasses.asdict(jax_ms_parse.read_ms(s))


def test_read_ms_needs_a_split():
    with pytest.raises(ValueError, match="merged"):
        ms_parse.read_ms("-n 1 10 -n 2 4.5 -eN 0.025 0.2")
