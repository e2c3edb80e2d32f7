"""The spectrum's per-interval action (misti_tpu_torch/kernels/expm.py
`expm_action_pair` and its kernel, kernels/expm_action.py).

On the CPU: the plain version against the loop it was before the kernel
(each Taylor term a `row_matmul` product and four torch ops), bitwise, at
both of the spectrum's instances and in both dtypes, with per-lane interval
lengths that hold zeros, ragged sub-step counts and runaway lanes; its
folded JSFS projection against `row_matmul(N1 p0, jsfs)`; the wrapper
taking the plain version for CPU tensors.  The CUDA kernel itself, built
in float64 only (the likelihood's dtype), runs only on a card: those tests
skip here.
"""

import numpy as np
import pytest
import torch

from misti_tpu_torch.engine.likelihood import SpectrumBasis
from misti_tpu_torch.kernels import expm as kexpm
from misti_tpu_torch.kernels import expm_action as kea
from misti_tpu_torch.kernels.row_matmul import row_matmul_plain

# the spectrum's instances: (name, kmat, norms, jsfs)
INSTANCES = [("k2", "k2", "norms2", "jsfs2"), ("k1", "k1", "norms1", "jsfs1")]
DTYPES = [torch.float64, torch.float32]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the expm_action kernel has no CPU form")
    return torch.device("cuda")


def loop_before_the_kernel(kmat, coeffs, basis_norms, t, p0, theta=2.0, degree=20,
                           max_substeps=1024):
    """`expm_action_pair` as it was before the kernel, on the CPU."""
    m, overflow = kexpm.substep_counts(coeffs, basis_norms, t, theta, max_substeps)
    n_loop = int(m.max())
    h = torch.as_tensor(t, dtype=p0.dtype, device=p0.device) / m
    cs = coeffs * h[..., None]
    p = p0
    acc = torch.zeros_like(p0)
    for j in range(n_loop):
        term, ev, pv = p, p, p
        for k in range(1, degree + 1):
            term = row_matmul_plain(term, kmat, cs) / k
            ev = ev + term
            pv = pv + term / (k + 1)
        live = (j < m)[..., None]
        p = torch.where(live, ev, p)
        acc = torch.where(live, acc + h[..., None] * pv, acc)
    bad = torch.full((), float("nan"), dtype=p0.dtype, device=p0.device)
    ov = overflow[..., None]
    return torch.where(ov, bad, p), torch.where(ov, bad, acc)


def _inputs(inst, B, dtype, device="cpu", seed=0):
    """(kmat, coeffs (B, C), norms, t (B,), p0 (B, n), jsfs, catmask (B, 7)):
    rates over three decades (ragged sub-step counts, 1 to ~60), every 5th
    lane t == 0, lane 3 past the sub-step cap and lane 7 with a NaN rate."""
    _, kname, nname, jname = inst
    basis = SpectrumBasis(torch.device(device), dtype)
    kmat, norms, jsfs = getattr(basis, kname), getattr(basis, nname), getattr(basis, jname)
    n, C = kmat.shape[0], norms.shape[0]
    rng = np.random.default_rng(seed)
    coeffs = rng.uniform(0.0, 1.0, (B, C)) * 10.0 ** rng.uniform(-1, 2, (B, 1))
    t = rng.uniform(0.01, 0.5, B)
    t[::5] = 0.0
    if B > 7:
        coeffs[3] = 1e6
        coeffs[7, 0] = np.nan
    p0 = rng.uniform(0.0, 1.0, (B, n))
    p0 /= p0.sum(-1, keepdims=True)
    cm = (rng.uniform(0.0, 1.0, (B, jsfs.shape[1])) > 0.3).astype(float)
    tens = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    return kmat, tens(coeffs), norms, tens(t), tens(p0), jsfs, tens(cm)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("inst", INSTANCES, ids=[i[0] for i in INSTANCES])
def test_plain_equals_the_loop_before_the_kernel(inst, dtype):
    kmat, coeffs, norms, t, p0, _, _ = _inputs(inst, 23, dtype)
    m, over = kexpm.substep_counts(coeffs, norms, t)
    assert over[3] and over[7] and not over[:3].any()
    assert (m[t == 0] == 1).all() and len(set(m[~over].tolist())) >= 5  # ragged
    want = loop_before_the_kernel(kmat, coeffs, norms, t, p0)
    got = kexpm.expm_action_pair_plain(kmat, coeffs, norms, t, p0, matvec=row_matmul_plain)
    for g, w in zip(got, want):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        assert torch.equal(torch.nan_to_num(g), torch.nan_to_num(w))
    # t == 0: p0 and 0 exactly; past the cap: NaN
    zero = (t == 0) & ~over
    assert torch.equal(got[0][zero], p0[zero]) and not got[1][zero].any()
    assert got[0][over].isnan().all() and got[1][over].isnan().all()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("inst", INSTANCES, ids=[i[0] for i in INSTANCES])
def test_folded_projection_equals_row_matmul(inst, dtype):
    """With ``jsfs`` the third output is ``row_matmul(N1 p0, jsfs)``, times a
    per-lane or a shared category mask."""
    kmat, coeffs, norms, t, p0, jsfs, cm = _inputs(inst, 11, dtype, seed=1)
    ep, n1p = kexpm.expm_action_pair_plain(kmat, coeffs, norms, t, p0)
    for mask in (None, cm, cm[0]):
        out = kexpm.expm_action_pair_plain(kmat, coeffs, norms, t, p0, jsfs=jsfs, catmask=mask)
        want = row_matmul_plain(n1p, jsfs)
        want = want if mask is None else mask * want
        assert torch.equal(out[0].nan_to_num(), ep.nan_to_num())
        assert torch.equal(out[2].isnan(), want.isnan())
        assert torch.equal(out[2].nan_to_num(), want.nan_to_num())


def test_wrapper_takes_the_plain_version_on_the_cpu():
    """CPU tensors: `expm_action_pair` is the plain version and launches
    nothing; the kernel's own wrapper refuses them."""
    kmat, coeffs, norms, t, p0, jsfs, cm = _inputs(INSTANCES[0], 13, torch.float64, seed=2)
    before = kea.expm_action.launches
    got = kexpm.expm_action_pair(kmat, coeffs, norms, t, p0, jsfs=jsfs, catmask=cm)
    want = kexpm.expm_action_pair_plain(kmat, coeffs, norms, t, p0, jsfs=jsfs, catmask=cm)
    assert len(got) == 3 and all(torch.equal(a.nan_to_num(), b.nan_to_num())
                                 for a, b in zip(got, want))
    assert len(kexpm.expm_action_pair(kmat, coeffs, norms, t, p0)) == 2
    assert kea.expm_action.launches == before
    with pytest.raises(ValueError):
        kea.expm_action(kmat, coeffs, norms, t, p0)


def test_work_meter_counts_each_lanes_own_substeps():
    """Operations the function needs from the per-lane sub-step counts (not
    the batch's largest): per lane the generator from the bases' nonzeros,
    per sub-step and term a matvec over the generator's nonzeros; bytes from
    the operands once."""
    basis = SpectrumBasis(torch.device("cpu"), torch.float64)
    assert int(torch.count_nonzero(basis.k2)) == 264 and int(torch.count_nonzero(basis.k1)) == 18
    m = torch.tensor([1.0, 3.0, 2.0])
    per_step = 20 * (2 * 196 + 4 * 44) + 2 * 44  # the generator's union of nonzeros: 196
    per_lane = 4 + 2 * 264 + 2 * 44 * 7 + 7
    assert kea.expm_action_ops(m, basis.k2, 4, Q=7) == 6 * per_step + 3 * per_lane
    assert kea.expm_action_ops(m, basis.k1, 1) == 6 * (20 * (2 * 18 + 4 * 8) + 16) + 3 * 37
    dense = torch.ones(44, 176, dtype=torch.float64)  # no zeros: 2 n^2 per term
    assert kea.expm_action_ops(m[:1], dense, 4) == 20 * (2 * 44 * 44 + 4 * 44) + 88 + 4 + 2 * 7744
    words = 44 * 176 + 3 * 4 + 4 + 3 + 3 * 44 + 44 * 7 + 3 * 7 + 2 * 3 * 44 + 3 * 7
    assert kea.expm_action_bytes(3, 44, 4, itemsize=8, per_lane_t=True, Q=7,
                                 per_lane_catmask=True) == words * 8


# --- on the card ------------------------------------------------------------

SUB_WIDTHS = (1, 6, 42, 960)


@pytest.mark.parametrize("inst", INSTANCES, ids=[i[0] for i in INSTANCES])
def test_kernel_matches_plain_on_card(cuda, inst):
    """One float64 launch against the plain loop: rtol 1e-6 / atol 1e-9,
    equal NaN masks, and bitwise (the kernel keeps the loop's order and
    roundings, whose matvec is the row_matmul kernel on the card); the first
    1 / 6 / 42 / 960 lanes alone bitwise as in the batch; the launch
    counter."""
    rtol, atol = 1e-6, 1e-9
    kmat, coeffs, norms, t, p0, jsfs, cm = _inputs(inst, 4851, torch.float64, cuda)
    before = kea.expm_action.launches
    got = kexpm.expm_action_pair(kmat, coeffs, norms, t, p0, jsfs=jsfs, catmask=cm)
    torch.cuda.synchronize()
    assert kea.expm_action.launches == before + 1
    want = kexpm.expm_action_pair_plain(kmat, coeffs, norms, t, p0, jsfs=jsfs, catmask=cm)
    for g, w in zip(got, want):
        assert torch.equal(g.isnan(), w.isnan())
        torch.testing.assert_close(g.nan_to_num(), w.nan_to_num(), rtol=rtol, atol=atol)
        assert torch.equal(g.nan_to_num(), w.nan_to_num())
    for w in SUB_WIDTHS:
        part = kexpm.expm_action_pair(kmat, coeffs[:w], norms, t[:w], p0[:w], jsfs=jsfs,
                                      catmask=cm[:w])
        for a, b in zip(part, got):
            assert torch.equal(a.nan_to_num(), b[:w].nan_to_num()), w


def test_kernel_takes_strided_lanes_and_shared_t_on_card(cuda):
    """The spectrum's operands: one interval of a (B, s, C) rate table, one
    interval length for every lane, a shared category mask."""
    kmat, coeffs, norms, t, p0, jsfs, cm = _inputs(INSTANCES[0], 300, torch.float64, cuda)
    table = torch.stack([coeffs * 0.5, coeffs, coeffs * 2.0], dim=1)  # (B, 3, C)
    got = kexpm.expm_action_pair(kmat, table[:, 1], norms, t[1:2], p0, jsfs=jsfs,
                                 catmask=cm[0])
    want = kexpm.expm_action_pair(kmat, coeffs.contiguous(), norms,
                                  t[1:2].expand(300).contiguous(), p0, jsfs=jsfs,
                                  catmask=cm[0].expand(300, -1).contiguous())
    for a, b in zip(got, want):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())


def test_kernel_rejects_what_it_does_not_take(cuda):
    kmat, coeffs, norms, t, p0, jsfs, cm = _inputs(INSTANCES[0], 8, torch.float64, cuda)
    with pytest.raises(TypeError):
        kea.expm_action(kmat, coeffs, norms, t, p0.float())
    f32 = _inputs(INSTANCES[0], 8, torch.float32, cuda)
    with pytest.raises(TypeError):  # built in float64 only
        kexpm.expm_action_pair(*f32[:5])
    with pytest.raises(ValueError):
        kea.expm_action(kmat, coeffs[:, :3], norms, t, p0)
    with pytest.raises(ValueError):
        kea.expm_action(kmat, coeffs, norms, t, p0, catmask=cm)
    with pytest.raises(ValueError):
        kea.expm_action(kmat, coeffs, norms, t, p0, degree=40)
