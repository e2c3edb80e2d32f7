"""The spectrum's per-interval action (misti_tpu_torch/kernels/expm.py
`expm_action_pair` and its kernel, kernels/expm_action.py).

On the CPU: the plain version (each lane's generator formed once over the
bases' nonzeros, every Taylor term a matvec over them) against the loop it
was before the kernel (each Taylor term a dense `row_matmul` product with
the stacked basis and four torch ops), at both of the spectrum's instances
and in both dtypes, with per-lane interval lengths that hold zeros, ragged
sub-step counts, runaway lanes and a lane whose p0 holds a NaN at t == 0;
the basis's nonzero table and the once-formed generator; its folded JSFS
projection against `row_matmul(N1 p0, jsfs)`; the wrapper taking the plain
version for CPU tensors.  The CUDA kernel itself, built in float64 only
(the likelihood's dtype), runs only on a card: those tests skip here.
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


def test_wrapper_takes_the_plain_version_on_the_cpu():
    """CPU tensors: `expm_action_pair` is the plain version and launches
    nothing; the kernel's own wrapper refuses them."""
    sp, coeffs, norms, t, p0, jsfs, cm = _inputs(INSTANCES[0], 13, torch.float64, seed=2)
    before = kea.expm_action.launches
    got = kexpm.expm_action_pair(sp, coeffs, norms, t, p0, jsfs=jsfs, catmask=cm)
    want = kexpm.expm_action_pair_plain(sp, coeffs, norms, t, p0, jsfs=jsfs, catmask=cm)
    assert len(got) == 3 and all(torch.equal(a.nan_to_num(), b.nan_to_num())
                                 for a, b in zip(got, want))
    assert len(kexpm.expm_action_pair(sp, coeffs, norms, t, p0)) == 2
    assert kea.expm_action.launches == before
    with pytest.raises(ValueError):
        kea.expm_action(sp, coeffs, norms, t, p0)


def test_work_meter_counts_each_lanes_own_substeps():
    """Operations the function needs from the per-lane sub-step counts (not
    the batch's largest): per lane that runs the series the generator from
    the bases' nonzeros, per sub-step and term a matvec over the
    generator's nonzeros; no series where t == 0 or past the cap; bytes
    from the operands once, the basis as the kernel reads it (its nonzero
    tables, not the dense stacked basis)."""
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


# --- on the card ------------------------------------------------------------

SUB_WIDTHS = (1, 6, 42, 960)


def _same(a, b):
    """Bitwise equal values, NaN where NaN (-0 equals 0)."""
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num())


@pytest.mark.parametrize("inst", INSTANCES, ids=[i[0] for i in INSTANCES])
def test_kernel_matches_plain_on_card(cuda, inst):
    """One float64 launch against the plain version: rtol 1e-6 / atol 1e-9,
    equal NaN masks (the NaN p0 lane's too), and bitwise (the kernel keeps
    the plain version's order and roundings); a batch that fills no whole
    block (4851 lanes: not a multiple of 4 or 16 lanes a block); the first
    1 / 6 / 42 / 960 lanes alone bitwise as in the batch; the launch
    counter."""
    rtol, atol = 1e-6, 1e-9
    sp, coeffs, norms, t, p0, jsfs, cm = _inputs(inst, 4851, torch.float64, cuda)
    before = kea.expm_action.launches
    got = kexpm.expm_action_pair(sp, coeffs, norms, t, p0, jsfs=jsfs, catmask=cm)
    torch.cuda.synchronize()
    assert kea.expm_action.launches == before + 1
    want = kexpm.expm_action_pair_plain(sp, coeffs, norms, t, p0, jsfs=jsfs, catmask=cm)
    for g, w in zip(got, want):
        assert torch.equal(g.isnan(), w.isnan())
        torch.testing.assert_close(g.nan_to_num(), w.nan_to_num(), rtol=rtol, atol=atol)
        assert _same(g, w)
    for w in SUB_WIDTHS:
        part = kexpm.expm_action_pair(sp, coeffs[:w], norms, t[:w], p0[:w], jsfs=jsfs,
                                      catmask=cm[:w])
        for a, b in zip(part, got):
            assert _same(a, b[:w]), w


@pytest.mark.parametrize("inst", INSTANCES, ids=[i[0] for i in INSTANCES])
def test_kernel_skips_t_zero_lanes_on_card(cuda, inst):
    """Blocks whose lanes all have t == 0 (the first 64 lanes: 16 blocks at
    k2, 4 at k1), and a batch of nothing else: p0 and 0 where p0 is finite,
    NaN spread as the series spreads it where it is not, past the cap NaN;
    bitwise the plain version, which runs the series."""
    sp, coeffs, norms, t, p0, jsfs, cm = _inputs(inst, 300, torch.float64, cuda, seed=3)
    t[:64] = 0.0
    for B in (300, 64):
        args = (sp, coeffs[:B], norms, t[:B], p0[:B])
        got = kexpm.expm_action_pair(*args, jsfs=jsfs, catmask=cm[:B])
        want = kexpm.expm_action_pair_plain(*args, jsfs=jsfs, catmask=cm[:B])
        for g, w in zip(got, want):
            assert _same(g, w), B
        m, over = kexpm.substep_counts(coeffs[:B], norms, t[:B])
        zero = (t[:B] == 0) & ~over & p0[:B].isfinite().all(-1)
        assert torch.equal(got[0][zero], p0[:B][zero]) and not got[1][zero].any()
        assert got[1][NAN_P0].isnan().any() and got[2][NAN_P0].isnan().all()


def test_kernel_takes_strided_lanes_and_shared_t_on_card(cuda):
    """The spectrum's operands: one interval of a (B, s, C) rate table, one
    interval length for every lane, a shared category mask."""
    sp, coeffs, norms, t, p0, jsfs, cm = _inputs(INSTANCES[0], 300, torch.float64, cuda)
    table = torch.stack([coeffs * 0.5, coeffs, coeffs * 2.0], dim=1)  # (B, 3, C)
    got = kexpm.expm_action_pair(sp, table[:, 1], norms, t[1:2], p0, jsfs=jsfs,
                                 catmask=cm[0])
    want = kexpm.expm_action_pair(sp, coeffs.contiguous(), norms,
                                  t[1:2].expand(300).contiguous(), p0, jsfs=jsfs,
                                  catmask=cm[0].expand(300, -1).contiguous())
    for a, b in zip(got, want):
        assert _same(a, b)


def test_kernel_rejects_what_it_does_not_take(cuda):
    sp, coeffs, norms, t, p0, jsfs, cm = _inputs(INSTANCES[0], 8, torch.float64, cuda)
    with pytest.raises(TypeError):
        kea.expm_action(sp, coeffs, norms, t, p0.float())
    f32 = _inputs(INSTANCES[0], 8, torch.float32, cuda)
    with pytest.raises(TypeError):  # built in float64 only
        kexpm.expm_action_pair(*f32[:5])
    with pytest.raises(ValueError):
        kea.expm_action(sp, coeffs[:, :3], norms, t, p0)
    with pytest.raises(ValueError):
        kea.expm_action(sp, coeffs, norms, t, p0, catmask=cm)
    with pytest.raises(ValueError):
        kea.expm_action(sp, coeffs, norms, t, p0, degree=40)
