"""The likelihood's post-split fit (misti_tpu_torch/engine/likelihood.py
`post_split_fit`, its plain version `post_split_fit_plain` and its kernel,
kernels/post_fit.py).

On the CPU: the dispatcher takes the plain version, which is the code the
stage ran before the kernel, bit for bit (a copy of it below), in both
residual modes, with one table for every lane and one per lane, T == 0 rows
mid-table and at the end, and a NaN lane; with at most 6 post-split rows
the ECT Jacobi rounds are exact by induction, so the plain version equals
upstream's sequential recursion (`scipy.optimize.brentq` on the reference's
ECT with its raw-rate guard, the carry updated row by row); the work meter;
the kernel's wrapper refusing float32 and CPU operands.  The CUDA kernel
itself, built in float64 only, runs only on a card: those tests skip here.
"""

import math

import numpy as np
import pytest
import torch
from scipy.optimize import brentq

from misti_tpu_torch.engine.likelihood import (
    _POST_OUTERS,
    post_split_fit,
    post_split_fit_plain,
)
from misti_tpu_torch.kernels import correction as kc
from misti_tpu_torch.kernels import post_fit as kpf


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the post_fit kernel has no CPU form")
    return torch.device("cuda")


def parent_post_split_fit(nc, lh_post, T_post, *, cpfit: bool):
    """`post_split_fit` as it was before the kernel."""
    B, n_post = nc.shape[0], T_post.shape[1]
    if cpfit or n_post == 0:
        lc_post = []
        for t in range(n_post):
            T_t = T_post[:, t]
            zero = T_t == 0
            ed = torch.exp(nc[:, 1] - nc[:, 0])
            dpnc = -(
                -torch.expm1(-T_t * lh_post[:, t, 0])
                + ed * -torch.expm1(-T_t * lh_post[:, t, 1])
            ) / (1.0 + ed)
            lam = -torch.log1p(dpnc) / torch.where(zero, torch.ones_like(T_t), T_t)
            lam = torch.where(zero, torch.ones_like(lam), lam)
            lc_t = torch.stack([lam, lam], dim=-1)
            nc = nc - T_t[:, None] * lc_t
            lc_post.append(lc_t)
        lc_post = (torch.stack(lc_post, dim=1) if lc_post
                   else torch.zeros((B, 0, 2), dtype=nc.dtype, device=nc.device))
        return lc_post, nc
    zero = T_post == 0
    t_safe = torch.where(zero, torch.ones_like(T_post), T_post)
    lh_post = lh_post.expand(B, n_post, 2)
    lc_post = lh_post.mean(dim=-1, keepdim=True).expand(B, n_post, 2)
    for _ in range(6):
        dec = T_post[..., None] * lc_post
        csum = torch.cumsum(dec, dim=1)
        nc_t = nc[:, None, :] - torch.cat(
            [torch.zeros_like(csum[:, :1]), csum[:, :-1]], dim=1)
        w = torch.exp(nc_t - nc_t.max(dim=-1, keepdim=True).values)
        lam = kc.fit_single_pop(lh_post, t_safe, w)
        lam = torch.where(zero, torch.ones_like(lam), lam)
        lc_post = torch.stack([lam, lam], dim=-1)
    return lc_post, nc - (T_post[..., None] * lc_post).sum(1)


def post_inputs(B, n, L, *, seed=0, device="cpu", dtype=torch.float64):
    """(nc (B, 2), lh_post (L, n, 2), T_post (L, n)): carries over three
    nats with a genome far below the other (lane 2) and a NaN lane (4);
    rates over a decade; from n > 6 on, a T == 0 row mid-table (3) and two
    at the end, rates straddling 100 (row 5: the C1 branch rule) and both
    above it (row 6), x = lam T around 1/4 (row 4, the series switch); per
    lane (L = B), each lane's own T == 0 padding past its rows."""
    rng = np.random.default_rng(seed)
    T = rng.uniform(0.005, 0.6, (L, n))
    lh = rng.uniform(0.2, 3.0, (L, n, 2)) * 10.0 ** rng.uniform(-0.5, 0.5, (L, n, 1))
    if n > 6:
        T[:, 3] = 0.0
        T[:, -2:] = 0.0
        lh[:, 5] = [60.0, 180.0]
        lh[:, 6] = [150.0, 300.0]
        T[:, 5:7] = 0.01
        T[:, 4] = 0.25 / lh[:, 4].mean(-1)
    if L > 1:
        for b in range(L):
            if b % 3:
                T[b, n - 1 - b % 4:] = 0.0
    nc = np.stack([-rng.uniform(0.0, 3.0, B), -rng.uniform(0.0, 3.0, B)], -1)
    if B > 4:
        nc[2, 1] = -40.0
        nc[4] = np.nan
    return tuple(torch.tensor(a, dtype=dtype, device=device) for a in (nc, lh, T))


def _same(a, b):
    """Bitwise equal values, NaN where NaN."""
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num())


CASES = [(7, 12, 1), (9, 12, 9), (5, 3, 5), (3, 0, 1)]  # (B, n, L)


@pytest.mark.parametrize("cpfit", [False, True], ids=["ect", "cpfit"])
@pytest.mark.parametrize("case", CASES, ids=[f"B{b}_n{n}_L{l}" for b, n, l in CASES])
def test_cpu_dispatch_is_the_plain_version_and_the_parent_code(case, cpfit):
    """CPU tensors: `post_split_fit` is `post_split_fit_plain`, bitwise, and
    both are the stage's code before the kernel; it launches nothing."""
    B, n, L = case
    nc, lh, T = post_inputs(B, n, L, seed=B + n)
    before = kpf.post_fit.launches
    got = post_split_fit(nc, lh, T, cpfit=cpfit)
    plain = post_split_fit_plain(nc, lh, T, cpfit=cpfit)
    parent = parent_post_split_fit(nc, lh, T, cpfit=cpfit)
    assert kpf.post_fit.launches == before
    assert got[0].shape == (B, n, 2) and got[1].shape == (B, 2)
    for a, b, c in zip(got, plain, parent):
        assert _same(a, b) and _same(b, c)
    if n > 6:
        assert (got[0][:, [3, n - 2, n - 1]] == 1).all()  # T == 0 rows
        rows = T[4 if L > 1 else 0] != 0  # the NaN lane: NaN but where T == 0
        assert got[0][4][rows].isnan().all() and (got[0][4][~rows] == 1).all()
        assert got[1][4].isnan().all()
        assert got[0][~torch.isnan(nc).any(-1)].isfinite().all()


def _ect(lam, T):
    """The reference's ECT(lam, T) (CorrectLambda.py:67-77): the 1/expm1
    tail dropped for a raw rate above 100."""
    return 1.0 / lam if lam > 100.0 else 1.0 / lam - T / math.expm1(lam * T)


def _sequential_oracle(nc, lh, T):
    """Upstream's post-split recursion (MigrationInference.py:355-370) one
    row at a time: weights from the carry at the row's start, the root of
    ECT(lam, T) = sum_i w_i ECT(lh_i, T) by brentq on the branch of the
    raw-rate guard that holds x0 = sum_i w_i lh_i (where the reference's
    local solver starts), then the carry less T lam."""
    nc = list(nc)
    lc = []
    for (l0, l1), t in zip(lh, T):
        if t == 0:
            lc.append(1.0)
            continue
        m = max(nc)
        w = [math.exp(v - m) for v in nc]
        w = [v / sum(w) for v in w]
        target = w[0] * _ect(l0, t) + w[1] * _ect(l1, t)
        x0 = w[0] * l0 + w[1] * l1
        f = lambda lam: _ect(lam, t) - target  # noqa: E731
        low, high = (1e-3 * min(l0, l1), 100.0), (math.nextafter(100.0, math.inf), 1e8)
        branches = (high, low) if x0 > 100.0 else (low, high)
        a, b = next(br for br in branches if f(br[0]) >= 0 > f(br[1]))
        lam = brentq(f, a, b, xtol=1e-300, rtol=9e-16, maxiter=500)
        lc.append(lam)
        nc = [v - t * lam for v in nc]
    return np.array(lc), np.array(nc)


@pytest.mark.parametrize("n", [1, 4, 6])
def test_ect_matches_the_sequential_recursion(n):
    """With n <= 6 rows, round r of the Jacobi fit makes row r - 1 exact, so
    the plain ECT path equals upstream's sequential recursion: 1e-10
    relative on every rate and on the final carry.  Rates and lengths keep
    lam T >= 0.05, where the oracle's direct ECT loses at most ~1e-13 to
    cancellation; one row above 100 on both genomes (the guard's upper
    branch) and one T == 0 row."""
    rng = np.random.default_rng(40 + n)
    B = 5
    T = rng.uniform(0.1, 0.6, (B, n))
    lh = rng.uniform(0.5, 3.0, (B, n, 2))
    if n >= 4:
        lh[:, 1] = rng.uniform(150.0, 400.0, (B, 2))
        T[:, 2] = 0.0
    nc = np.stack([-rng.uniform(0.0, 2.0, B), -rng.uniform(0.0, 2.0, B)], -1)
    lc, nc_fin = post_split_fit_plain(torch.tensor(nc), torch.tensor(lh), torch.tensor(T),
                                      cpfit=False)
    for b in range(B):
        want_lc, want_nc = _sequential_oracle(nc[b], lh[b], T[b])
        np.testing.assert_allclose(lc[b, :, 0].numpy(), want_lc, rtol=1e-10, atol=0)
        assert torch.equal(lc[b, :, 0], lc[b, :, 1])
        np.testing.assert_allclose(nc_fin[b].numpy(), want_nc, rtol=1e-10, atol=0)


def test_expansion_meter_counts_the_steps_that_move_the_bound():
    """`fit_single_pop(..., moves=...)` returns the same bits and counts
    the expansion steps that moved hi: with one weight on lh = 1 the root
    is 1, hi starts there (x0) and doubles once; a lane whose x0 is far
    below its root doubles until g turns."""
    lh = torch.tensor([[1.0, 1.0], [0.5, 60.0]], dtype=torch.float64)
    T = torch.tensor([0.5, 0.02], dtype=torch.float64)
    w = torch.tensor([[1.0, 0.0], [1e-6, 1.0]], dtype=torch.float64)
    moves = []
    got = kc.fit_single_pop(lh, T, w, moves=moves)
    assert torch.equal(got, kc.fit_single_pop(lh, T, w))
    assert abs(float(got[0]) - 1.0) < 1e-14
    assert len(moves) == 1 and int(moves[0][0]) == 1
    hi = max(float(w[1] @ lh[1]) / float(w[1].sum()), 0.01)  # x0, doubled up to the root
    assert int(moves[0][1]) == math.ceil(math.log2(float(got[1]) / hi))


def test_work_meter():
    """Operations the function needs: none for a T == 0 row; cpfit a closed
    form per row; ECT per round and solved row the prefix, the bracket's
    set-up, 60 halvings and the expansion tests that its own solve needs
    (one more than the steps that moved hi).  Bytes: each operand read
    once, each output written once."""
    nc, lh, T = post_inputs(6, 12, 6, seed=3)
    live = int((T != 0).sum())
    assert kpf.post_fit_ops(nc, lh, T, cpfit=True) == live * kpf.CPFIT_ROW_OPS
    moves = []
    post_split_fit_plain(nc, lh, T, cpfit=False, moves=moves)
    assert len(moves) == _POST_OUTERS
    keep = T != 0
    tests = sum(int(torch.clamp(m + 1, max=40)[keep].sum()) for m in moves)
    per_solve = kpf.PREFIX_OPS + kpf.SETUP_OPS + 60 * (kpf.STEP_OPS + 2) + 2
    assert kpf.post_fit_ops(nc, lh, T, cpfit=False) == (
        live * _POST_OUTERS * per_solve + tests * kpf.STEP_OPS + 6 * 26)
    shared = post_inputs(6, 12, 1, seed=3)
    assert kpf.post_fit_ops(*shared, cpfit=True) == 6 * int((shared[2] != 0).sum()) * (
        kpf.CPFIT_ROW_OPS)
    assert kpf.post_fit_bytes(6, 1, 12) == (12 + 36 + 144 + 12) * 8


def test_kernel_wrapper_refuses_float32_and_cpu_operands():
    """The kernel is built in float64 only and has no CPU form: float32
    operands raise TypeError, float64 CPU operands ValueError, and neither
    counts a launch."""
    before = kpf.post_fit.launches
    nc, lh, T = post_inputs(5, 8, 1, dtype=torch.float32)
    with pytest.raises(TypeError):
        kpf.post_fit(nc, lh, T, cpfit=False)
    with pytest.raises(ValueError):
        kpf.post_fit(*post_inputs(5, 8, 1), cpfit=True)
    assert kpf.post_fit.launches == before


# --- on the card ------------------------------------------------------------

# the paths' widths: bench 4096 (shared tables, n = 35), sweep stage 1 4848
# (per lane, n = 33), single fit 6 (shared, n = 29), two-band 5656 (per lane)
CARD_WIDTHS = [(4096, 35, False), (4848, 33, True), (6, 29, False), (5656, 33, True)]
SUB_WIDTHS = (1, 6, 42, 960)


@pytest.mark.parametrize("cpfit", [False, True], ids=["ect", "cpfit"])
@pytest.mark.parametrize("width", CARD_WIDTHS, ids=[f"B{w[0]}" for w in CARD_WIDTHS])
def test_kernel_matches_plain_on_card(cuda, width, cpfit):
    """One launch against the plain version on the card: rtol 1e-6 / atol
    1e-9 and equal NaN masks; the first 1 / 6 / 42 / 960 lanes alone
    bitwise as in the batch; the dispatcher launches the kernel once."""
    B, n, per_lane = width
    nc, lh, T = post_inputs(B, n, B if per_lane else 1, seed=B, device=cuda)
    before = kpf.post_fit.launches
    got = post_split_fit(nc, lh, T, cpfit=cpfit)
    torch.cuda.synchronize()
    assert kpf.post_fit.launches == before + 1
    want = post_split_fit_plain(nc, lh, T, cpfit=cpfit)
    for g, w in zip(got, want):
        assert torch.equal(g.isnan(), w.isnan())
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-9, equal_nan=True)
    for k in (k for k in SUB_WIDTHS if k < B):
        part = kpf.post_fit(nc[:k], lh[:k] if per_lane else lh, T[:k] if per_lane else T,
                            cpfit=cpfit)
        assert all(_same(a, b[:k]) for a, b in zip(part, got))


def test_kernel_refuses_float32_on_card(cuda):
    nc, lh, T = post_inputs(5, 8, 1, device=cuda, dtype=torch.float32)
    before = kpf.post_fit.launches
    with pytest.raises(TypeError):
        kpf.post_fit(nc, lh, T, cpfit=False)
    assert kpf.post_fit.launches == before
