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
the kernel's wrapper refusing float32 and CPU operands.  The kernel's solve
with G threads (`fit_single_pop_group`: the parallel expansion and the
bisection tree) in torch ops gives `fit_single_pop`'s bits at every G, and
the JAX package's roots at its parity tolerance (that one test imports
jax); `threads_per_solve` at the paths' widths; `warp_branch_mix` on
sweep-like and bench-like tables.  The CUDA kernel itself, built in float64
only, runs only on a card: those tests skip here (on a card, run this file
with ``--noconftest -k 'card or refuses'``).
"""

import functools
import math

import numpy as np
import pytest
import torch
from scipy.optimize import brentq

from misti_tpu_torch.engine import likelihood as lk
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
    """Bitwise equal values (-0 is not +0), NaN where NaN."""
    nan = a.isnan()
    return (a.shape == b.shape and torch.equal(nan, b.isnan())
            and torch.equal(a.view(torch.int64)[~nan], b.view(torch.int64)[~nan]))


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


def test_work_meter(monkeypatch):
    """Operations the function needs: none for a T == 0 row; cpfit a closed
    form per row; ECT (`ect_work`, whose rates are the plain version's bit
    for bit) the prefix of every live row of every round, and for each
    solve whose prefix changed (every live row in round 1, never a first
    row after it) its weights, the bracket's set-up, the expansion tests
    its own solve needs (one more than the steps that moved hi) and its
    halvings up to the bracket's fixed point: that many halvings give the
    60 halvings' root bit for bit.  Bytes: each operand read once, each
    output written once."""
    nc, lh, T = post_inputs(6, 12, 6, seed=3)
    live = T != 0
    assert kpf.post_fit_ops(nc, lh, T, cpfit=True) == int(live.sum()) * kpf.CPFIT_ROW_OPS
    work = kpf.ect_work(nc, lh, T)
    assert _same(work["lc"], post_split_fit_plain(nc, lh, T, cpfit=False)[0])
    solved = torch.stack(work["solved"])
    assert solved.shape == (_POST_OUTERS, 6, 12) and torch.equal(solved[0], live)
    assert not solved[1:, :, 0].any() and solved[1].any() and not (solved & ~live).any()
    assert int(solved[1:].sum()) < int(solved[1:].numel()) // 2
    moves = []
    post_split_fit_plain(nc, lh, T, cpfit=False, moves=moves)
    tests = [torch.clamp(m + 1, max=40) for m in moves]
    assert len(tests) == _POST_OUTERS
    assert all(torch.equal(a, b) for a, b in zip(work["tests"], tests))
    want = int(live.sum()) * _POST_OUTERS * kpf.PREFIX_OPS + 6 * 26
    for s_, t_, h_ in zip(work["solved"], work["tests"], work["halvings"]):
        want += (int(s_.sum()) * (kpf.WEIGHT_OPS + kpf.SETUP_OPS + 2)
                 + int(t_[s_].sum()) * kpf.STEP_OPS + int(h_[s_].sum()) * kpf.HALVING_OPS)
    assert kpf.post_fit_ops(nc, lh, T, cpfit=False) == want
    shared = post_inputs(6, 12, 1, seed=3)
    assert kpf.post_fit_ops(*shared, cpfit=True) == 6 * int((shared[2] != 0).sum()) * (
        kpf.CPFIT_ROW_OPS)
    assert kpf.post_fit_bytes(6, 1, 12) == (12 + 36 + 144 + 12) * 8

    lh1, T1, w1 = _solve_cases()
    halvings = []
    root = kc.fit_single_pop(lh1, T1, w1, halvings=halvings)
    counts = halvings[0]
    assert int(counts.min()) >= 1 and int(counts.max()) <= 60 and int(counts.min()) < 60
    for k in sorted(set(counts.tolist())):
        monkeypatch.setattr(kc, "_BISECT_ITERS", k)
        at = counts == k
        assert _same(kc.fit_single_pop(lh1, T1, w1)[at], root[at]), k


def test_kernel_wrapper_refuses_float32_and_cpu_operands():
    """The kernel is built in float64 only and has no CPU form: float32
    operands raise TypeError, float64 CPU operands ValueError, and neither
    counts a launch; its one build job is csrc/post_fit.cu in float64."""
    assert [(j[0].name, j[1].name) for j in kpf.build_jobs(force=True)] == [
        ("post_fit_f64.so", "post_fit.cu")]
    before = kpf.post_fit.launches
    nc, lh, T = post_inputs(5, 8, 1, dtype=torch.float32)
    with pytest.raises(TypeError):
        kpf.post_fit(nc, lh, T, cpfit=False)
    with pytest.raises(ValueError):
        kpf.post_fit(*post_inputs(5, 8, 1), cpfit=True)
    assert kpf.post_fit.launches == before


# --- the kernel's solve with G threads, in torch ops -----------------------


def _solve_cases():
    """(lh (N, 2), T (N,), w (N, 2)) of single solves: rates straddling 100 on
    short intervals (the guard's upper branch), two roots, no root on either
    branch (a negative rate), x = lam T around 1/4, expansions that move hi
    (a weight on a rate far below the root), a NaN rate and a NaN weight."""
    rng = np.random.default_rng(17)
    parts = [
        (rng.uniform(60.0, 300.0, (64, 2)), rng.uniform(0.002, 0.1, 64),
         rng.uniform(0.1, 1.0, (64, 2))),
        (rng.uniform(30.0, 100.0, (64, 2)), rng.uniform(0.002, 0.02, 64),
         rng.uniform(0.1, 1.0, (64, 2))),
        (np.array([[1.558, -0.0207], [0.0027, -10.96], [1240.8, -6109.3]]),
         np.array([0.1798, 7.662, 0.5873]), np.array([[1.7e-7, 0.083], [0.0022, 0.89],
                                                      [0.51, 0.53]])),
        (rng.uniform(0.5, 3.0, (32, 2)), 0.25 / rng.uniform(0.6, 3.2, 32),
         rng.uniform(0.1, 1.0, (32, 2))),
        (np.array([[1.0, 1.0], [0.5, 60.0], [0.001, 90.0], [1e-9, 99.0], [np.nan, 2.0],
                   [1.0, 2.0]]), np.array([0.5, 0.02, 0.3, 1.0, 0.2, 0.3]),
         np.array([[1.0, 0.0], [1e-6, 1.0], [1e-12, 1.0], [1e-30, 1.0], [0.5, 0.5],
                   [np.nan, 1.0]])),
    ]
    return tuple(torch.tensor(np.concatenate(a), dtype=torch.float64) for a in zip(*parts))


@pytest.mark.parametrize("levels", [1, 2, 3, 4, 5])
def test_group_solve_gives_the_serial_solves_bits(levels, monkeypatch):
    """`fit_single_pop_group` at G = 2^levels, the kernel's parallel
    expansion and bisection tree in torch ops, equals `fit_single_pop`
    bitwise: on single solves (`_solve_cases`, some with hi moving) and
    through the ECT rounds of `post_split_fit_plain` on `post_inputs` (T == 0
    rows, rates straddling 100, x around 1/4, a NaN lane; shared and per-lane
    tables)."""
    G = 1 << levels
    lh, T, w = _solve_cases()
    moves = []
    want = kc.fit_single_pop(lh, T, w, moves=moves)
    assert int(moves[0].max()) >= 1 and bool(want.isnan().any())
    assert _same(kpf.fit_single_pop_group(lh, T, w, G), want)
    for case in [(7, 12, 1), (9, 12, 9), (9, 40, 9)]:
        args = post_inputs(*case, seed=sum(case))
        plain = post_split_fit_plain(*args, cpfit=False)
        monkeypatch.setattr(lk, "fit_single_pop",
                            functools.partial(kpf.fit_single_pop_group, group=G))
        got = post_split_fit_plain(*args, cpfit=False)
        monkeypatch.undo()
        assert all(_same(a, b) for a, b in zip(got, plain)), case


@pytest.mark.parametrize("group", kpf.GROUPS)
def test_parallel_expansion_is_the_serial_loop(group):
    """`expand_plain` with G threads ends where the serial loop of 40
    capped doublings ends, on a decreasing g whose root lies 0 to 2^45
    times above hi: caps finite, infinite and NaN, hi NaN, negative, zero
    and at the cap."""
    rng = np.random.default_rng(group)
    hi = rng.uniform(0.1, 10.0, 256)
    root = hi * 2.0 ** rng.uniform(-1.0, 45.0, 256)
    cap = np.where(rng.uniform(size=256) < 0.5, np.inf, hi * 2.0 ** rng.uniform(0, 50, 256))
    hi[:4], cap[4:6], hi[6] = [np.nan, -3.0, 0.0, 5.0], np.nan, cap[6]
    hi, root, cap = (torch.tensor(a, dtype=torch.float64) for a in (hi, root, cap))
    g = lambda lam: root - lam  # noqa: E731
    want = hi
    for _ in range(40):
        want = torch.where(g(want) >= 0, torch.minimum(want * 2.0, cap), want)
    got = kpf.expand_plain(g, hi, cap, group)
    assert _same(got, want)
    assert int((want > hi).sum()) > 100


@pytest.mark.parametrize("group", kpf.GROUPS)
def test_group_solve_matches_jax(group):
    """The group solve against the JAX package's `fit_single_pop` on
    tests/test_torch_correction_fused.py's parity inputs (rates below 100),
    at that test's JAX tolerance, rtol 1e-8."""
    jax = pytest.importorskip("jax")
    jax.config.update("jax_enable_x64", True)
    from misti_tpu.kernels import correction as jkc

    rng = np.random.default_rng(21)
    lh = rng.uniform(0.3, 5.0, (40, 2))
    T = rng.uniform(0.01, 0.5, 40)
    w = rng.uniform(0.05, 1.0, (40, 2))
    want = np.asarray(jax.jit(jax.vmap(jkc.fit_single_pop))(lh, T, w))
    got = kpf.fit_single_pop_group(*(torch.tensor(a) for a in (lh, T, w)), group).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-8)


def test_threads_per_solve_at_the_paths_widths():
    """G = 1 at the sweep's (4848 x 34), the bench's (4096 x 35) and a rank's
    (2424 x 34) widths; 32 at the single fit's 6-7 lanes and at a
    compaction stage's few dozen; in between at a sub-batch of 960; never
    past the resident threads (an H100's by default, else the card's) but
    at G = 1; and every layout holds its lanes' intervals in at most 8
    blocks of at most 18 warps (G = 1) or 32."""
    tps = kpf.threads_per_solve
    assert [tps(6, 30, 6 * 30 * 4), tps(6, 30, 6 * 30 * 4 - 1), tps(960, 34, 10 ** 7)] == [
        4, 2, 32]
    assert [tps(4848, 34), tps(4096, 35), tps(2424, 34)] == [1, 1, 1]
    assert [tps(6, 30), tps(7, 35), tps(40, 34), tps(960, 34), tps(6, 200)] == [32, 32, 32, 4,
                                                                                32]
    for B in (1, 6, 40, 300, 960, 2424, 4096):
        for n in (1, 12, 18, 19, 34, 144, 145, 256):
            G = tps(B, n)
            assert G == 1 or B * n * G <= kpf.RESIDENT_THREADS
            assert 2 * G > 32 or B * n * 2 * G > kpf.RESIDENT_THREADS
            lay = kpf.ect_layout(n, G)
            assert 1 <= lay["C"] <= kpf.MAX_CLUSTER and lay["warps"] <= kpf.MAX_WARPS[G]
            assert lay["C"] * lay["h"] >= n > (lay["C"] - 1) * lay["h"]
            assert lay["S"] * G * lay["K"] == 32
    assert kpf.ect_layout(30, 32)["C"] == 1 and kpf.ect_layout(34, 1)["C"] == 2
    for n, G in ((257, 1), (0, 1), (34, 3)):
        with pytest.raises(ValueError):
            kpf.ect_layout(n, G)


def _sweep_like(splits=8, rows=200, n=34, seed=5):
    """Per-lane post-split tables as the sweep builds them: lanes in runs of
    ``rows`` sharing a split (split-major), each split's n_k = n - k rows of
    PSMC-like lengths (growing 17% a row) and smooth rates, T == 0 padding
    past them, each lane its own pre-split carry."""
    rng = np.random.default_rng(seed)
    T = np.zeros((splits, n))
    lh = np.ones((splits, n, 2))
    for k in range(splits):
        T[k, :n - k] = 0.01 * 1.17 ** np.arange(k, n)
        lh[k] = 1.0 + 0.5 * np.sin(np.arange(n)[:, None] / 4.0 + [0.0, 1.0] + k / 3.0)
    idx = np.repeat(np.arange(splits), rows)
    nc = -rng.uniform(0.5, 2.5, (splits * rows, 2))
    return tuple(torch.tensor(a) for a in (nc, lh[idx], T[idx]))


def test_warp_branch_mix():
    """Lane-major warps mix the residual's two forms, and T == 0 rows with
    live ones, in fewer warps than the PR 9 mapping on sweep-like per-lane
    tables; neither the old nor the lane-major mapping mixes any on the
    bench's shared tables (every row on the series form, no T == 0 row)."""
    from misti_tpu_torch import build_likelihood
    from misti_tpu_torch.bench import bench_params, bench_spec

    # the plain fit of 1600 ECT lanes: one intra-op thread, as beside the
    # other test workers more threads take minutes where one takes seconds
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        args = _sweep_like()
        lc, _ = lk.post_split_fit_plain(*args, cpfit=False)
        old = kpf.warp_branch_mix(*args, layout="old", lc=lc)
        new = kpf.warp_branch_mix(*args, layout="lane", lc=lc)
        assert 0.2 < old["series_share"] < 0.8 and old["zero_rows"] == 200 * 28
        assert new["mixed_forms"] < old["mixed_forms"] and new["mixed_zero"] < old["mixed_zero"]
        assert new["mixed_forms"] <= 0.05 and new["mixed_zero"] <= 0.05

        seen = []

        def rec(*a, **kw):
            seen.append(a)
            raise StopIteration

        lik = build_likelihood(bench_spec("ect"), device="cpu")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(lk, "post_split_fit", rec)
            with pytest.raises(StopIteration):
                lik.llh_batch(bench_params(64, "cpu", torch.float64))
        nc, lh, T = seen[0]
        assert T.shape[0] == 1 and bool((T != 0).all())
        lc, _ = lk.post_split_fit_plain(nc, lh, T, cpfit=False)
        for layout in ("old", "lane"):
            for G in (1, 32) if layout == "lane" else (1,):
                mix = kpf.warp_branch_mix(nc, lh, T, layout=layout, group=G, lc=lc)
                assert mix["series_share"] == 1.0
                assert mix["mixed_forms"] == mix["mixed_zero"] == 0.0
    finally:
        torch.set_num_threads(threads)


# --- on the card ------------------------------------------------------------

# the paths' widths: bench 4096 (shared tables, n = 35), sweep stage 1 4848
# (per lane, n = 33), single fit 6 (shared, n = 29), two-band 5656 (per lane)
# and a batch past MAX_WARPS * MAX_CLUSTER intervals (two intervals a warp)
CARD_WIDTHS = [(4096, 35, False), (4848, 33, True), (6, 29, False), (5656, 33, True),
               (45, 200, True)]
SUB_WIDTHS = (1, 6, 42, 960)


@pytest.mark.parametrize("cpfit", [False, True], ids=["ect", "cpfit"])
@pytest.mark.parametrize("width", CARD_WIDTHS, ids=[f"B{w[0]}" for w in CARD_WIDTHS])
def test_kernel_matches_plain_on_card(cuda, width, cpfit):
    """One launch against the plain version on the card, at the G that
    `threads_per_solve` picks and at every other G the layout takes: rtol
    1e-6 / atol 1e-9 and equal NaN masks (cpfit bitwise); every G bitwise
    equal to G = 1; the first 1 / 6 / 42 / 960 lanes alone bitwise as in
    the batch; the dispatcher launches the kernel once."""
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
        assert not cpfit or _same(g, w)
    one = kpf.post_fit(nc, lh, T, cpfit=cpfit, group=1)
    for G in kpf.GROUPS:
        assert all(_same(a, b) for a, b in zip(kpf.post_fit(nc, lh, T, cpfit=cpfit, group=G),
                                               one)), f"G = {G}"
    assert all(_same(a, b) for a, b in zip(got, one))
    for k in (k for k in SUB_WIDTHS if k < B):
        part = kpf.post_fit(nc[:k], lh[:k] if per_lane else lh, T[:k] if per_lane else T,
                            cpfit=cpfit)
        assert all(_same(a, b[:k]) for a, b in zip(part, got))


def test_resident_threads_on_card(cuda):
    """G follows the card at hand: its SM count, and the threads an SM keeps
    resident of the G > 1 kernels by the card's occupancy query; the
    launch shape reports both."""
    sms, resident = kpf.sms_and_resident(torch.cuda.current_device())
    assert sms == torch.cuda.get_device_properties(cuda).multi_processor_count
    assert 0 < resident <= sms * 2048 and resident % 32 == 0
    shape = kpf.launch_shape(6, 30, cpfit=False)
    assert shape["sms"] == sms and shape["group"] == kpf.threads_per_solve(6, 30, resident)


def test_kernel_refuses_float32_on_card(cuda):
    nc, lh, T = post_inputs(5, 8, 1, device=cuda, dtype=torch.float32)
    before = kpf.post_fit.launches
    with pytest.raises(TypeError):
        kpf.post_fit(nc, lh, T, cpfit=False)
    assert kpf.post_fit.launches == before
