"""The Nelder-Mead simplex update as one hand kernel per iteration
(misti_tpu_torch/kernels/nm_step.py, csrc/nm_step.cu) against the plain
torch loop of engine/optimize.py `nelder_mead`.

On the CPU: every CPU tensor takes the plain loop (no `nm.hand_steps`, no
launch); `takes` gives the kernel every CUDA state and raises for one in
dtypes no instance has (float64 or float32 simplexes with float64 values,
the likelihood's, are the ones it has); the library is built without FMA
contraction, and with every other library of the port at a first use; the
one-step states below hit every branch of scipy's decision tree, ties at
+inf and NaN values, frozen lanes and lanes reaching ``maxiter``.

On the card (skipped here: the kernel has no CPU form): one step from those
states, bitwise the plain loop's in the trial points, the result and the
state, in float64 and float32, n = 1..4 (register instances) and 5, 6 (the
generic one), with and without aux counters, at 1 to 5656 lanes; whole
lockstep fits of an analytic objective with +inf walls, bitwise, with
`nm.hand_steps` equal to the iterations; a 2-stage resume bitwise the
uninterrupted run; larger n through the generic instance; float32 values
on the card raise.
"""

import itertools
from types import SimpleNamespace

import pytest
import torch

from misti_tpu_torch import spans
from misti_tpu_torch.engine import optimize as opt
from misti_tpu_torch.kernels import correction_fused as cf
from misti_tpu_torch.kernels import nm_step as knm

F32, F64 = torch.float32, torch.float64
MAXITER = 50
# n of the register instances, then of the generic one
NS = [1, 2, 3, 4, 5, 6]
LEVELS = [-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0, float("inf"), float("nan")]


def _step_case(B, n, sdt, naux, seed=0):
    """A resumable state and one objective call's values that hit every
    branch: vertex values and trial values drawn from a few levels (ties,
    +inf, NaN) and a quarter above them (the contractions), collapsed
    simplexes with tied values (converged: frozen), and a fifth of the lanes
    already at ``MAXITER`` (frozen).  Returns (NMState, fall, auxall)."""
    g = torch.Generator().manual_seed(seed)
    V, P = n + 1, n + 5
    levels = torch.tensor(LEVELS, dtype=F64)
    sim = (torch.randint(-16, 17, (B, V, n), generator=g) / 8.0).to(sdt)
    sim[::13] = sim[::13, :1]
    fsim = levels[torch.randint(0, len(LEVELS), (B, V), generator=g)]
    fsim[::13] = 0.25
    it = torch.where(torch.rand(B, generator=g) < 0.2, MAXITER, MAXITER - 1).to(torch.int64)
    nfev = torch.randint(0, 100, (B,), generator=g)
    aux = torch.randint(0, 5, (B, naux), generator=g).to(sdt)
    fall = levels[torch.randint(0, len(LEVELS), (B, P), generator=g)]
    fall = torch.where(torch.rand(B, P, generator=g) < 0.3, fall + 0.25, fall)
    auxall = torch.randint(0, 3, (B, P, naux), generator=g).to(sdt)
    return opt.NMState(sim=sim, fsim=fsim, it=it, nfev=nfev, aux_sum=aux), fall, auxall


def _branches(state, fall):
    """Per branch of the decision tree, the live lanes that take it (the
    plain loop's formulas on the ordered state)."""
    sim, fsim = opt._order(state.sim, state.fsim)
    live = ~opt._converged(sim, fsim, 1e-4, 1e-4) & (state.it < MAXITER)
    fxr, fxe, fxc, fxcc = fall[:, 0], fall[:, 1], fall[:, 2], fall[:, 3]
    f0, f_2, f_1 = fsim[:, 0], fsim[:, -2], fsim[:, -1]
    inside = (fxr >= f0) & (fxr >= f_2)
    take = {
        "expand": (fxr < f0) & (fxe < fxr),
        "reflect": ((fxr < f0) & ~(fxe < fxr)) | ((fxr >= f0) & (fxr < f_2)),
        "contract": inside & (fxr < f_1) & (fxc <= fxr),
        "contract_inside": inside & (fxr >= f_1) & (fxcc < f_1),
        "shrink": inside & (((fxr < f_1) & ~(fxc <= fxr)) | ((fxr >= f_1) & ~(fxcc < f_1))),
    }
    take = {k: v & live for k, v in take.items()}
    take["frozen"] = ~live
    take["nan_value"] = live & (fsim.isnan().any(1) | fall[:, :4].isnan().any(1))
    take["inf_tie"] = live & ((fsim == float("inf")).sum(1) >= 2)
    return take


def _bits(x):
    if x.dtype in (torch.bool, torch.int64):
        return x
    return x.contiguous().view({4: torch.int32, 8: torch.int64}[x.element_size()])


def _same(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def _run(fun, x0, hand, monkeypatch, **kw):
    """(result, state, the points of every objective call, counters) of a
    recorded `nelder_mead`; ``hand=False`` forces the plain loop."""
    if not hand:
        monkeypatch.setattr(knm, "takes", lambda *a: False)
    seen = []

    def obj(points):
        seen.append(points.clone())
        return fun(points)

    try:
        with spans.recording() as records:
            with spans.span("request"):
                res, state = opt.nelder_mead(obj, x0, with_state=True, **kw)
    finally:
        monkeypatch.undo()
    counters = {k: v.item() if torch.is_tensor(v) else v
                for k, v in records[-1].get("counters", {}).items()}
    return res, state, seen, counters


def _assert_same_run(got, want):
    (rg, sg, pg, cg), (rw, sw, pw, cw) = got, want
    for k in rw._fields:
        assert _same(getattr(rg, k), getattr(rw, k)), f"result {k}"
    for k in sw._fields:
        assert _same(getattr(sg, k), getattr(sw, k)), f"state {k}"
    assert len(pg) == len(pw)
    for i, (a, b) in enumerate(zip(pg, pw)):
        assert _same(a, b), f"trial points of call {i}"
    assert {k: v for k, v in cg.items() if k != "nm.hand_steps"} == cw


def _walls(naux, centre):
    """sum (x - c)^2 + |prod x| / 10 in float64, +inf where a coordinate is
    below 0; aux: (1, whether the point hit the wall)."""

    def f(p):
        q = p.double()
        v = ((q - centre.to(p.device)) ** 2).sum(-1) + 0.1 * q.prod(-1).abs()
        wall = (p < 0).any(-1)
        v = torch.where(wall, torch.full_like(v, float("inf")), v)
        if not naux:
            return v
        return v, torch.stack([torch.ones_like(wall), wall], -1).to(p.dtype)

    return f


# --- on the CPU ---------------------------------------------------------------

@pytest.mark.parametrize("n,dtype", [(1, F64), (2, F64), (4, F32), (5, F64)])
def test_cpu_tensors_take_the_plain_loop(n, dtype):
    before = knm.nm_step.launches
    x0 = torch.full((3, n), 0.5, dtype=dtype)
    with spans.recording() as records:
        with spans.span("request"):
            res = opt.nelder_mead(_walls(2, torch.full((n,), 0.3, dtype=F64)), x0,
                                  naux=2, maxiter=40)
    counters = records[-1]["counters"]
    assert counters.get("nm.hand_steps", 0) == 0
    assert knm.nm_step.launches == before
    assert int(counters["nm.lanes_evaluated"]) == 3 * int(res.nit.max() - 1)


def _on_card(shape, dtype):
    """A tensor as `takes` reads it, on a CUDA device."""
    return SimpleNamespace(shape=torch.Size(shape), dtype=dtype, device=torch.device("cuda", 0))


@pytest.mark.parametrize("n", [1, knm.MAX_N, knm.MAX_N + 1])
@pytest.mark.parametrize("sdt,fdt", [(F64, F64), (F32, F64), (F32, F32), (F64, F32),
                                     (torch.float16, F64)])
def test_takes_cuda_states_of_up_to_max_n_parameters(n, sdt, fdt):
    """Every n on the card, up to MAX_N in registers and above it through
    the generic instance; dtypes with no instance raise there."""
    B, i64 = 4, torch.int64
    state = (_on_card((B, n + 1, n), sdt), _on_card((B, n + 1), fdt), _on_card((B,), i64),
             _on_card((B,), i64), _on_card((B, 2), sdt))
    if sdt in (F32, F64) and fdt == F64:
        assert knm.takes(*state)
    else:
        with pytest.raises(TypeError, match="no instance"):
            knm.takes(*state)
    cpu = [torch.zeros(t.shape, dtype=t.dtype) for t in state]
    assert not knm.takes(*cpu)


@pytest.mark.parametrize("aux_dtype", [F64, F32])
def test_takes_raises_for_aux_sums_in_another_dtype_on_card(aux_dtype):
    B, n, i64 = 4, 2, torch.int64
    state = (_on_card((B, n + 1, n), F32), _on_card((B, n + 1), F64), _on_card((B,), i64),
             _on_card((B,), i64), _on_card((B, 2), aux_dtype))
    if aux_dtype == F32:
        assert knm.takes(*state)
    else:
        with pytest.raises(TypeError, match="no instance"):
            knm.takes(*state)
    assert knm.takes(*state[:4], _on_card((B, 0), aux_dtype))  # no aux sums: any dtype


def test_library_builds_without_fma_contraction():
    (_, src, flags), = knm.build_jobs(force=True)
    assert "--fmad=false" in flags and src.name == "nm_step.cu"


def test_a_first_build_starts_every_library_of_the_port():
    jobs = cf.port_jobs(force=True)
    names = sorted(out.name for out, *_ in jobs)
    assert names == sorted(["correction_sweep_f64_cpfit.so", "correction_sweep_f64_ect.so",
                            "spectrum_f64.so", "post_fit_f64.so", "nm_step.so",
                            "row_matmul_f64.so"])


@pytest.mark.parametrize("n", NS)
def test_step_cases_hit_every_branch(n):
    state, fall, _ = _step_case(5656, n, F64, 0)
    for name, mask in _branches(state, fall).items():
        assert int(mask.sum()) > 0, name


# --- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the nm_step kernel has no CPU form")
    return torch.device("cuda")


@pytest.mark.parametrize("B", [1, 7, 5656])
@pytest.mark.parametrize("naux", [0, 2])
@pytest.mark.parametrize("sdt", [F64, F32])
@pytest.mark.parametrize("n", NS)
def test_one_step_is_the_plain_loops_on_card(cuda, monkeypatch, n, sdt, naux, B):
    state, fall, auxall = _step_case(B, n, sdt, naux, seed=n)
    state = opt.NMState(*(t.to(cuda) for t in state))
    fall, auxall = fall.to(cuda), auxall.to(cuda)
    fun = (lambda p: (fall, auxall)) if naux else (lambda p: fall)
    x0 = torch.zeros(B, n, dtype=sdt, device=cuda)
    kw = dict(state0=state, maxiter=MAXITER, naux=naux)
    before = knm.nm_step.launches
    got = _run(fun, x0, True, monkeypatch, **kw)
    assert knm.nm_step.launches - before == 1 + got[3].get("nm.hand_steps", 0)
    want = _run(fun, x0, False, monkeypatch, **kw)
    _assert_same_run(got, want)


@pytest.mark.parametrize("naux", [0, 2])
@pytest.mark.parametrize("sdt", [F64, F32])
@pytest.mark.parametrize("n", NS)
def test_whole_fits_are_the_plain_loops_on_card(cuda, monkeypatch, n, sdt, naux):
    g = torch.Generator().manual_seed(10 * n + naux)
    B = 64
    centre = torch.rand(B, 1, n, generator=g, dtype=F64) * 2 - 0.3
    x0 = (torch.rand(B, n, generator=g) * 2).to(sdt)
    x0[:5] = 0  # starts on the wall
    fun = _walls(naux, centre.to(cuda))
    x0 = x0.to(cuda)
    kw = dict(naux=naux, maxiter=300, xatol=1e-5, fatol=1e-5)
    got = _run(fun, x0, True, monkeypatch, **kw)
    want = _run(fun, x0, False, monkeypatch, **kw)
    _assert_same_run(got, want)
    assert got[3]["nm.hand_steps"] == len(got[2]) - 1 == int(got[0].nit.max()) - 1
    assert want[3].get("nm.hand_steps", 0) == 0

    # two stages, resumed from the first's state, equal the uninterrupted run
    _, s1, _, _ = _run(fun, x0, True, monkeypatch, **dict(kw, maxiter=7))
    staged = _run(fun, x0, True, monkeypatch, **dict(kw, state0=s1))
    for k in got[0]._fields:
        assert _same(getattr(staged[0], k), getattr(got[0], k)), k
    for k in got[1]._fields:
        assert _same(getattr(staged[1], k), getattr(got[1], k)), k


@pytest.mark.parametrize("n", [8, 13])
def test_n_above_max_takes_the_generic_instance_on_card(cuda, monkeypatch, n):
    g = torch.Generator().manual_seed(n)
    centre = (torch.rand(1, n, generator=g, dtype=F64) * 2 - 0.3).to(cuda)
    x0 = (torch.rand(24, n, generator=g, dtype=F64) * 2).to(cuda)
    fun = _walls(2, centre)
    before = knm.nm_step.launches
    got = _run(fun, x0, True, monkeypatch, naux=2, maxiter=120)
    assert knm.nm_step.launches - before == 1 + got[3]["nm.hand_steps"] > 1
    _assert_same_run(got, _run(fun, x0, False, monkeypatch, naux=2, maxiter=120))


def test_values_with_no_instance_raise_on_card(cuda):
    x0 = torch.full((3, 2), 0.5, dtype=F32, device=cuda)
    with pytest.raises(TypeError, match="no instance"):  # float32 values
        opt.nelder_mead(lambda p: (p.double() ** 2).sum(-1).float(), x0, maxiter=5)


def test_no_lanes_launch_nothing_on_card(cuda):
    before = knm.nm_step.launches
    res = opt.nelder_mead(_walls(0, torch.zeros(2, dtype=F64)),
                          torch.zeros(0, 2, dtype=F64, device=cuda), maxiter=5)
    assert knm.nm_step.launches == before and res.x.shape == (0, 2)


def test_lockstep_lane_equals_its_standalone_fit_on_card(cuda, monkeypatch):
    g = torch.Generator().manual_seed(3)
    B, n = 9, 2
    centre = (torch.rand(B, 1, n, generator=g, dtype=F64) * 2).to(cuda)
    x0 = (torch.rand(B, n, generator=g, dtype=F64) * 2).to(cuda)
    res, *_ = _run(_walls(0, centre), x0, True, monkeypatch, maxiter=200)
    for b in itertools.islice(range(B), 0, B, 4):
        one, *_ = _run(_walls(0, centre[b:b + 1]), x0[b:b + 1], True, monkeypatch,
                       maxiter=200)
        for k in res._fields:
            assert _same(getattr(one, k), getattr(res, k)[b:b + 1]), k
