"""The spectrum's per-interval action (misti_tpu_torch/kernels/expm.py
`expm_action_pair_plain`) and its work meters (kernels/expm_action.py).

On the CPU: the plain version (each lane's generator formed once over the
bases' nonzeros, every Taylor term a matvec over them) against the loop it
was before (each Taylor term a dense `row_matmul` product with the stacked
basis and four torch ops), at both of the spectrum's instances and in both
dtypes, with per-lane interval lengths that hold zeros, ragged sub-step
counts, runaway lanes and a lane whose p0 holds a NaN at t == 0; the
basis's nonzero table and the once-formed generator; its folded JSFS
projection against `row_matmul(N1 p0, jsfs)`; the spectrum's per-interval
path (`jafs_spectrum_plain`) running each interval through it; the meters'
counts and their series settings, which are the spectrum kernel's.  On the
card the spectrum kernel is held to this path
(tests/test_torch_spectrum_kernel.py).
"""

import numpy as np
import pytest
import torch

from misti_tpu_torch.engine.likelihood import SpectrumBasis
from misti_tpu_torch.kernels import expm as kexpm
from misti_tpu_torch.kernels import expm_action as kea
from misti_tpu_torch.kernels.row_matmul import row_matmul_plain

# the spectrum's instances: (name, sparse basis, norms, jsfs)
INSTANCES = [("k2", "sp2", "norms2", "jsfs2"), ("k1", "sp1", "norms1", "jsfs1")]
NAN_P0 = 10  # a lane with t == 0 whose p0 holds a NaN
DTYPES = [torch.float64, torch.float32]



def loop_before_the_kernel(kmat, coeffs, basis_norms, t, p0, theta=2.0, degree=20,
                           max_substeps=1024):
    """`expm_action_pair_plain` as it was before its sparse form."""
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
    """(basis, coeffs (B, C), norms, t (B,), p0 (B, n), jsfs, catmask (B, 7)):
    rates over three decades (ragged sub-step counts, 1 to ~60), every 5th
    lane t == 0, lane 3 past the sub-step cap, lane 7 with a NaN rate and
    lane NAN_P0 (t == 0) with a NaN in p0."""
    _, sname, nname, jname = inst
    basis = SpectrumBasis(torch.device(device), dtype)
    sp, norms, jsfs = getattr(basis, sname), getattr(basis, nname), getattr(basis, jname)
    n, C = sp.n, sp.C
    rng = np.random.default_rng(seed)
    coeffs = rng.uniform(0.0, 1.0, (B, C)) * 10.0 ** rng.uniform(-1, 2, (B, 1))
    t = rng.uniform(0.01, 0.5, B)
    t[::5] = 0.0
    if B > 7:
        coeffs[3] = 1e6
        coeffs[7, 0] = np.nan
    p0 = rng.uniform(0.0, 1.0, (B, n))
    p0 /= p0.sum(-1, keepdims=True)
    if B > NAN_P0:
        p0[NAN_P0, 1] = np.nan
    cm = (rng.uniform(0.0, 1.0, (B, jsfs.shape[1])) > 0.3).astype(float)
    tens = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    return sp, tens(coeffs), norms, tens(t), tens(p0), jsfs, tens(cm)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("inst", INSTANCES, ids=[i[0] for i in INSTANCES])
def test_plain_equals_the_loop_before_the_kernel(inst, dtype):
    """The sparse generator's order against the dense loop: rtol 1e-12 in
    float64, 1e-5 in float32 (the sums run in another order), NaN masks
    equal, t == 0 and runaway lanes exact.  A NaN in p0 at t == 0 runs the
    series: it stays NaN in both outputs and makes the projection NaN, as
    in the loop (which spreads it to every state; the sparse matvec spreads
    it along the generator's nonzeros)."""
    sp, coeffs, norms, t, p0, jsfs, _ = _inputs(inst, 23, dtype)
    m, over = kexpm.substep_counts(coeffs, norms, t)
    assert over[3] and over[7] and not over[:3].any()
    assert (m[t == 0] == 1).all() and len(set(m[~over].tolist())) >= 5  # ragged
    want = loop_before_the_kernel(sp.dense(), coeffs, norms, t, p0)
    got = kexpm.expm_action_pair_plain(sp, coeffs, norms, t, p0, jsfs=jsfs)
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    rest = torch.arange(23) != NAN_P0
    for g, w in zip(got, want):
        assert torch.equal(torch.isnan(g[rest]), torch.isnan(w[rest]))
        torch.testing.assert_close(g[rest].nan_to_num(), w[rest].nan_to_num(), rtol=rtol, atol=0)
    # t == 0 with a finite p0: p0 and 0 exactly; past the cap: NaN
    zero = (t == 0) & ~over & rest
    assert torch.equal(got[0][zero], p0[zero]) and not got[1][zero].any()
    assert got[0][over].isnan().all() and got[1][over].isnan().all()
    # NaN in p0 at t == 0: not p0 and 0; the projection all NaN, as the loop's
    bad = p0[NAN_P0].isnan()
    assert got[0][NAN_P0][bad].isnan().all() and got[1][NAN_P0][bad].isnan().all()
    assert got[2][NAN_P0].isnan().all()
    assert row_matmul_plain(want[1], jsfs)[NAN_P0].isnan().all()


@pytest.mark.parametrize("inst", INSTANCES, ids=[i[0] for i in INSTANCES])
def test_sparse_basis_is_the_union_of_the_bases_nonzeros(inst):
    """`SparseBasis`: per output state its sources in increasing order, one
    slot per nonzero of the union of the bases' patterns (196 at k2, 18 at
    k1), each basis's value there, pads pointing at the zero entry and slot;
    the generator formed once per lane equals sum_c cs_c B_c there."""
    sp, coeffs, norms, _, _, _, _ = _inputs(inst, 9, torch.float64)
    n, C = sp.n, sp.C
    kmat = getattr(SpectrumBasis(torch.device("cpu"), torch.float64), inst[0])
    k3 = kmat.view(n, C, n)  # (i, c, j): B_c[j, i]
    pattern = (k3 != 0).any(1)
    assert (sp.nnz, sp.L) == ((196, 5) if n == 44 else (18, 3))
    assert torch.equal(sp.dense(), kmat)
    live = sp.slot.long() < sp.nnz
    assert int(live.sum()) == int(pattern.sum()) == sp.nnz
    assert sorted(sp.slot[live].tolist()) == list(range(sp.nnz))
    assert (sp.src[~live] == n).all() and (sp.src[live] < n).all()
    for j in range(n):
        src = sp.src[j][live[j]].long()
        assert torch.equal(src, torch.nonzero(pattern[:, j]).flatten())
        for c in range(C):
            assert torch.equal(sp.vals[c, sp.slot[j][live[j]].long()], k3[src, c, j])
    cs = coeffs.nan_to_num() * 0.01
    g = kexpm.lane_generator(sp, cs)  # (B, n, L)
    dense = torch.einsum("bc,icj->bij", cs, k3)  # G^T: term' = term @ G^T
    jj = torch.arange(n)[:, None].expand(n, sp.L)
    want = torch.where(live, dense[:, sp.src.long().clamp(max=n - 1), jj], 0.0)
    torch.testing.assert_close(g, want, rtol=1e-14, atol=0)
    assert (g[:, ~live] == 0).all()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("inst", INSTANCES, ids=[i[0] for i in INSTANCES])
def test_folded_projection_equals_row_matmul(inst, dtype):
    """With ``jsfs`` the third output is ``row_matmul(N1 p0, jsfs)``, times a
    per-lane or a shared category mask."""
    sp, coeffs, norms, t, p0, jsfs, cm = _inputs(inst, 11, dtype, seed=1)
    ep, n1p = kexpm.expm_action_pair_plain(sp, coeffs, norms, t, p0)
    for mask in (None, cm, cm[0]):
        out = kexpm.expm_action_pair_plain(sp, coeffs, norms, t, p0, jsfs=jsfs, catmask=mask)
        want = row_matmul_plain(n1p, jsfs)
        want = want if mask is None else mask * want
        assert torch.equal(out[0].nan_to_num(), ep.nan_to_num())
        assert torch.equal(out[2].isnan(), want.isnan())
        assert torch.equal(out[2].nan_to_num(), want.nan_to_num())


def _spectrum_inputs(B=5, s=4, n_post=3, seed=3):
    """`jafs_spectrum`'s inputs after the basis: shared tables, the ancient
    sample entering before interval 1, no pulse."""
    rng = np.random.default_rng(seed)
    tens = lambda a: torch.tensor(a, dtype=torch.float64)  # noqa: E731
    lc = tens(rng.uniform(0.5, 2.0, (B, s + n_post + 1, 2)))
    mi = tens(rng.uniform(0.0, 0.5, (B, s, 2)))
    pu = torch.zeros((B, s, 2), dtype=torch.float64)
    T_pre, T_post = tens(rng.uniform(0.05, 0.2, (1, s))), tens(rng.uniform(0.1, 0.3, (1, n_post)))
    catmask = torch.ones((s, 7), dtype=torch.float64)
    sample_at = [True if t == 1 else None for t in range(s)]
    return lc, mi, pu, T_pre, T_post, catmask, sample_at, None, np.zeros((s, 2), dtype=bool)


def test_the_per_interval_spectrum_runs_each_interval_through_the_plain_version(monkeypatch):
    """On the CPU `jafs_spectrum` takes `jafs_spectrum_plain`, which runs each
    of its s + n_post intervals as one `expm_action_pair_plain` call: the
    44-state basis with the 44 x 7 projection before the split, the 8-state
    one with the 8 x 7 projection after; counting the calls leaves the
    spectrum as it was."""
    from misti_tpu_torch.engine import likelihood as lk

    basis = SpectrumBasis(torch.device("cpu"), torch.float64)
    inp = _spectrum_inputs()
    s, n_post = inp[3].shape[1], inp[4].shape[1]
    want = lk.jafs_spectrum(basis, *inp)
    seen, orig = [], kexpm.expm_action_pair_plain

    def rec(sp, *a, **kw):
        seen.append((sp.n, tuple(kw["jsfs"].shape)))
        return orig(sp, *a, **kw)

    monkeypatch.setattr(lk, "expm_action_pair_plain", rec)
    got = lk.jafs_spectrum(basis, *inp)
    assert torch.equal(got, want) and bool(torch.isfinite(got).all())
    assert seen == [(44, (44, 7))] * s + [(8, (8, 7))] * n_post


def test_meters_default_to_the_series_the_spectrum_kernel_runs():
    """The meters' theta, degree and sub-step cap default to kernels/expm.py's
    THETA, DEGREE and MAX_SUBSTEPS, the plain version's defaults and what the
    spectrum kernel's arguments carry."""
    import inspect

    from misti_tpu_torch.kernels import spectrum as ksp

    series = dict(theta=kexpm.THETA, degree=kexpm.DEGREE, max_substeps=kexpm.MAX_SUBSTEPS)
    for fn in (kea.expm_action_ops, kexpm.expm_action_pair_plain):
        params = inspect.signature(fn).parameters
        assert {k: params[k].default for k in series} == series, fn.__name__
    basis = SpectrumBasis(torch.device("cpu"), torch.float64)
    a = ksp.pack_spectrum(basis, *_spectrum_inputs())
    c = ksp.c_args(basis, a, torch.empty((a.B, 7), dtype=torch.float64))
    assert (c.theta, c.degree, c.cap) == (series["theta"], series["degree"],
                                          series["max_substeps"])
    sp, coeffs, norms, t, _, _, _ = _inputs(INSTANCES[0], 9, torch.float64)
    assert kea.expm_action_ops(sp, coeffs, norms, t, Q=7) == kea.expm_action_ops(
        sp, coeffs, norms, t, theta=c.theta, degree=c.degree, max_substeps=c.cap, Q=7)


def test_work_meter_counts_each_lanes_own_substeps():
    """Operations the function needs from the per-lane sub-step counts (not
    the batch's largest): per lane that runs the series the generator from
    the bases' nonzeros, per sub-step and term a matvec over the
    generator's nonzeros; no series where t == 0 or past the cap; bytes
    from the operands once, the basis as its nonzero tables (not the dense
    stacked basis)."""
    basis = SpectrumBasis(torch.device("cpu"), torch.float64)
    assert int(torch.count_nonzero(basis.k2)) == 264 and int(torch.count_nonzero(basis.k1)) == 18

    def lanes(norms, C):
        # sub-step counts 1, 3, 2; a lane with t == 0; a lane with a NaN rate
        coeffs = torch.ones((5, C), dtype=torch.float64)
        coeffs[4, 0] = float("nan")
        t = (torch.tensor([1.0, 3.0, 2.0, 0.5, 1.0]) - 0.5) * 2.0 / float(norms.sum())
        t[3] = 0.0
        m, over = kexpm.substep_counts(coeffs, norms, t)
        assert m.tolist() == [1.0, 3.0, 2.0, 1.0, 1.0] and over.tolist() == [0, 0, 0, 0, 1]
        return coeffs, norms, t

    per_step = 20 * (2 * 196 + 4 * 44) + 2 * 44  # the generator's union of nonzeros: 196
    assert kea.expm_action_ops(basis.sp2, *lanes(basis.norms2, 4), Q=7) == (
        6 * per_step + 3 * (4 + 2 * 264) + 5 * (2 * 44 * 7 + 7))
    assert kea.expm_action_ops(basis.sp1, *lanes(basis.norms1, 1)) == (
        6 * (20 * (2 * 18 + 4 * 8) + 16) + 3 * 37)
    dense = kexpm.sparse_basis(torch.ones(44, 176, dtype=torch.float64), 4)  # 2 n^2 per term
    one = torch.ones((1, 4), dtype=torch.float64)
    assert kea.expm_action_ops(dense, one, one[0], 0.25) == (
        20 * (2 * 44 * 44 + 4 * 44) + 88 + 4 + 2 * 7744)
    tables = 2 * 44 * 5 * 4  # src, slot: (44, 5) int32 each
    words = 4 * 196 + 3 * 4 + 4 + 3 + 3 * 44 + 44 * 7 + 3 * 7 + 2 * 3 * 44 + 3 * 7
    assert kea.expm_action_bytes(3, basis.sp2, itemsize=8, per_lane_t=True, Q=7,
                                 per_lane_catmask=True) == tables + words * 8
