"""The JSFS spectrum in one launch (misti_tpu_torch/kernels/spectrum.py,
csrc/spectrum.cu) and the packing of its inputs (`pack_spectrum`, in the
same module).

On the CPU: `jafs_spectrum` takes its plain loop, `jafs_spectrum_plain`;
the packing of every input into the kernel's arguments (lane strides, the
sample's row and lanes, the rebase at the split, the pulse sites), read
back by a plain twin that sees only the packed arguments
(`unpack_spectrum`), gives the plain loop's spectrum bit for bit on sweeps
and single fits; the kernel's arguments carry the per-interval path's
series settings; the pulse tables rebuild the dense pulse operators; what
the kernel does not take is refused; a library is rebuilt when the header
it shares changes.

On the card (skipped here: the kernel has no CPU form): the kernel against
the per-interval path on the card (`jafs_spectrum_plain` on CUDA tensors) on
the sweep's first-iteration inputs of both benchmark configurations (per-lane
tables, T == 0 padding rows), single fits' shared tables, an ancient sample
with a rebase at the split and pulses: rtol 1e-12, and bit for bit in the
sums of the interval terms and the carried state where no pulse enters;
lanes past the sub-step cap give NaN and llh = -inf; a lane's spectrum is
bitwise the same at every width; float32 and CPU tensors are refused.
"""

import inspect
import json
import os

import numpy as np
import pytest
import torch

from misti_tpu_torch import build_likelihood, build_spec, probe
from misti_tpu_torch.engine import likelihood as lk
from misti_tpu_torch.engine import sweep_fused as sf
from misti_tpu_torch.engine.bootstrap import make_bootstrap_data
from misti_tpu_torch.io import jsfs as io_jsfs
from misti_tpu_torch.io import psmc as io_psmc
from misti_tpu_torch.kernels import expm as kexpm
from misti_tpu_torch.kernels import spectrum as ksp
from misti_tpu_torch.kernels.correction_fused import stale
from misti_tpu_torch.model import statespace as ss

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
F64 = torch.float64


def _fixture_case(name):
    """(build_spec arguments, keywords) of a likelihood.npz case."""
    with open(os.path.join(FIX, "likelihood_meta.json")) as f:
        i = json.load(f).index(name)
    fx = np.load(os.path.join(FIX, "likelihood.npz"))
    g = lambda k: fx[f"c{i}_{k}"]  # noqa: E731
    flags = g("flags")
    args = [list(g("times")), [list(v) for v in g("lambdas")], list(g("sfs8")),
            float(g("splitT")), [list(v) for v in g("mi")], [list(v) for v in g("pu")]]
    kw = dict(correct=not bool(flags[1]), cpfit=bool(flags[2]), smooth=bool(flags[3]),
              unfolded=bool(flags[0]), sample_date=int(flags[4]))
    return args, kw


def _captured(mod, run):
    """The arguments of the first `jafs_spectrum` call ``run()`` makes
    through ``mod``."""
    seen, orig = [], mod.jafs_spectrum

    def rec(*a):
        seen.append(a)
        return orig(*a)

    mod.jafs_spectrum = rec
    try:
        run()
    finally:
        mod.jafs_spectrum = orig
    return seen[0]


# single fits: (fixture case, pulse template or None, lanes); shared tables
FITS = {
    "fit_band": ("correct_cpfit0_mig1", None, 6),
    "fit_sdate": ("correct_sdate", None, 7),
    "fit_pulse": ("correct_pulse", [[2, 4, 0.15, 1]], 6),
    "fit_trueeps_pulse": ("migpulse_trueEPS_unfolded", None, 5),
}
# sweeps on case correct_cpfit0_mig1's 23 intervals: (flags, mi, pu, splits)
SWEEPS = {
    "sweep_bands_smooth": (dict(cpfit=True, smooth=True, unfolded=True),
                           [[1, 6, "ST", 0.3, 1], [2, 6, "ST", 0.3, 1]], [], [8, 8.5, 10, 11.25]),
    "sweep_pulse_sdate": (dict(cpfit=False, smooth=False, unfolded=False, sample_date=3),
                          [[1, 6, "ST", 0.2, 1]], [[2, 5, 0.1, 1]], [8, 9.5, 11]),
    # the sample enters at split 8's split (a rebase) and before interval 8
    # of the later splits
    "sweep_sample_at_split": (dict(cpfit=True, smooth=False, unfolded=True, sample_date=8),
                              [[1, 8, 12, 0.25, 1]], [[2, 9, 0.15, 0]], [8, 10, 11]),
}
PULSED = ("fit_pulse", "fit_trueeps_pulse", "sweep_pulse_sdate", "sweep_sample_at_split")


def _fit_inputs(name, device):
    case, pulse, B = FITS[name]
    args, kw = _fixture_case(case)
    if pulse is not None:
        args[5] = pulse
    lik = build_likelihood(build_spec(*args, **kw), device=device)
    n = lik.spec.n_params
    params = np.linspace(0.05, 0.7, B)[:, None] * np.linspace(1.0, 0.5, max(n, 1))[:n]
    return _captured(lk, lambda: lik.llh_batch(params))


def _sweep_inputs(name, device):
    flags, mi, pu, splits = SWEEPS[name]
    args, _ = _fixture_case("correct_cpfit0_mig1")
    fs = sf.build_fused_sweep(args[0], args[1], splits, mi, pu, device=device, **flags)
    rng = np.random.default_rng(7)
    st = np.repeat(np.arange(len(splits)), 3)
    params = rng.uniform(0.02, 0.8, (st.size, fs.n_params))
    data = np.asarray(args[2])[:7] * 1e4 * rng.uniform(0.9, 1.1, (st.size, 7)) + 100.0
    return _captured(sf, lambda: fs.llh(st, params, data))


def _inputs(name, device="cpu"):
    return (_fit_inputs if name in FITS else _sweep_inputs)(name, device)


def unpack_spectrum(a) -> tuple:
    """The plain twin's reading of packed arguments ``a`` (a
    kernels/spectrum.py `SpectrumArgs`): `jafs_spectrum_plain`'s inputs (lc,
    mi, pu, T_pre, T_post, catmask, sample_at, rebase, pulse_site), read
    from ``a`` alone, as the kernel reads it: views at its strides (lane
    stride 0: every lane the same row), the sample at its row, the pulse
    sites from the device table."""
    def view(x, ld, rs, rows, cols):
        return torch.as_strided(x, (a.B, rows, cols), (ld, rs, 1), x.storage_offset())

    def lanes(mask, ld):
        return True if mask is None else torch.as_strided(mask, (a.B,), (ld,),
                                                          mask.storage_offset())

    s, n_post = a.s, a.n_post
    sample_at = [None] * s
    if a.sample_row >= 0:
        sample_at[a.sample_row] = lanes(a.sample, a.sample_ld)
    sites = (np.zeros((s, 2), dtype=bool) if a.pulse_site is None
             else a.pulse_site.cpu().numpy().astype(bool))
    return (view(a.lc, a.lc_ld, a.lc_rs, s + n_post + 1, 2), view(a.mi, a.mi_ld, a.mi_rs, s, 2),
            view(a.pu, a.pu_ld, a.pu_rs, s, 2), view(a.t_pre, a.tp_ld, 1, s, 1)[..., 0],
            view(a.t_post, a.tq_ld, 1, n_post, 1)[..., 0],
            view(a.catmask, a.cm_ld, a.cm_rs, s, 7), sample_at,
            lanes(a.rebase_mask, a.rebase_ld) if a.rebase else None, sites)


def _same(a, b):
    """Bitwise equal values, NaN where NaN (-0 equals 0)."""
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num())


# --- on the CPU --------------------------------------------------------------

@pytest.mark.parametrize("name", [*FITS, *SWEEPS])
def test_jafs_spectrum_takes_the_plain_loop_on_the_cpu(name):
    basis, *inp = _inputs(name)
    before = ksp.spectrum_kernel.launches
    got = lk.jafs_spectrum(basis, *inp)
    assert got.shape == (inp[0].shape[0], 7) and bool(torch.isfinite(got).all())
    assert _same(got, lk.jafs_spectrum_plain(basis, *inp))
    assert ksp.spectrum_kernel.launches == before


@pytest.mark.parametrize("name", [*FITS, *SWEEPS])
def test_packed_arguments_give_the_plain_spectrum(name):
    """What the kernel reads, read back by a plain twin that sees only the
    packed arguments, gives the plain loop's spectrum bit for bit; shared
    tables are read with lane stride 0, per-lane tables with their own."""
    basis, lc, mi, pu, T_pre, T_post, catmask, sample_at, rebase, pulse_site = _inputs(name)
    inp = (lc, mi, pu, T_pre, T_post, catmask, sample_at, rebase, pulse_site)
    a = ksp.pack_spectrum(basis, *inp)
    twin = unpack_spectrum(a)
    assert _same(lk.jafs_spectrum_plain(basis, *twin), lk.jafs_spectrum_plain(basis, *inp))
    B, s = lc.shape[0], T_pre.shape[1]
    assert (a.B, a.s, a.n_post) == (B, s, T_post.shape[1])
    assert (a.lc_ld, a.lc_rs) == lc.stride()[:2]
    rows = [t for t in range(s) if sample_at[t] is not None]
    assert a.sample_row == (rows[0] if rows else -1)
    assert (a.pulse_site is not None) == (name in PULSED)
    if name in FITS:  # one spec's tables for every lane
        assert a.tp_ld == a.tq_ld == a.cm_ld == 0 and a.cm_rs == 7
        assert a.sample is None and a.rebase_mask is None
    else:  # each lane's own split's tables
        assert (a.tp_ld, a.tq_ld, a.cm_ld, a.cm_rs) == (s, T_post.shape[1], 7 * s, 7)
        assert a.sample is None or (a.sample.shape == (B,) and a.sample_ld == s)
    if name == "sweep_sample_at_split":
        assert a.rebase and a.rebase_mask.shape == (B,) and a.sample_row == 8
        assert 0 < int(a.rebase_mask.sum()) < B


def test_plain_parts_are_the_sums_of_the_terms():
    """``parts`` of the plain loop: the pre- and post-split terms' sums and
    the 8-state p0 before the last interval, whose term completes the
    spectrum in the plain order."""
    basis, *inp = _inputs("sweep_bands_smooth")
    parts = {}
    jafs = lk.jafs_spectrum_plain(basis, *inp, parts=parts)
    assert _same(jafs, lk.jafs_spectrum_plain(basis, *inp))
    lc, s, n_post = inp[0], inp[3].shape[1], inp[4].shape[1]
    occ = torch.linalg.solve_ex(ss.one_pop_matrix(lc[:, s + n_post, 0], basis.b1),
                                -parts["p8"])[0]
    last = occ @ basis.jsfs1
    assert _same(jafs, parts["pre"] + (parts["post"] + last))


def test_pack_refuses_what_the_kernel_does_not_take():
    basis, lc, mi, pu, T_pre, T_post, catmask, sample_at, rebase, sites = _inputs("fit_band")
    args = [lc, mi, pu, T_pre, T_post, catmask, sample_at, rebase, sites]
    two_rows = [True, None, True] + [None] * (T_pre.shape[1] - 3)
    for i, bad in ((6, two_rows),  # the sample enters once
                   (0, lc.transpose(1, 2).contiguous().transpose(1, 2)),  # last axis strided
                   (5, catmask[None].expand(3, -1, -1)),  # neither 1 nor B lanes
                   (1, mi[:, :2])):  # fewer rows than s
        with pytest.raises(ValueError):
            ksp.pack_spectrum(basis, *args[:i], bad, *args[i + 1:])
    B = lc.shape[0]
    with pytest.raises(ValueError):  # a mask that is not bool
        ksp.pack_spectrum(basis, *args[:7], torch.ones(B), sites)


def test_kernel_refuses_cpu_tensors():
    basis, *inp = _inputs("fit_band")
    with pytest.raises(ValueError):
        ksp.spectrum_kernel(basis, ksp.pack_spectrum(basis, *inp))


def test_kernel_arguments_carry_the_per_interval_series_settings():
    """The kernel's arguments carry the sub-step norm, Taylor degree and
    sub-step cap that the per-interval path uses by default, and the
    per-call arguments are the packed call's."""
    basis, *inp = _inputs("sweep_bands_smooth")
    a = ksp.pack_spectrum(basis, *inp)
    out = torch.empty((a.B, 7), dtype=F64)
    c = ksp.c_args(basis, a, out)
    plain = inspect.signature(kexpm.expm_action_pair_plain).parameters
    wanted = {k: plain[k].default for k in ("theta", "degree", "max_substeps")}
    assert wanted == dict(theta=kexpm.THETA, degree=kexpm.DEGREE,
                          max_substeps=kexpm.MAX_SUBSTEPS) == dict(theta=2.0, degree=20,
                                                                   max_substeps=1024)
    assert (c.theta, c.degree, c.cap) == (wanted["theta"], wanted["degree"],
                                          wanted["max_substeps"])
    assert (c.B, c.s, c.n_post, c.out) == (a.B, a.s, a.n_post, out.data_ptr())
    assert (c.lc, c.lc_ld, c.tp_ld, c.cm_ld) == (a.lc.data_ptr(), a.lc_ld, a.tp_ld, a.cm_ld)


def test_pulse_tables_rebuild_the_dense_operators():
    """P(r)[d, src] = count * r^a * (1 - r)^(k_src - a) over the tables'
    nonzeros, at r = 0 (the identity), inside (0, 1) and at 1."""
    b2 = ss.two_pop_basis()
    idx, coef = ksp.pulse_nonzeros(b2.pulse_coeff, b2.pulse_k)
    assert idx.shape == (2, 44, 9, 3) and coef.shape == (2, 44, 9)
    rates = torch.tensor([0.0, 0.3, 0.7, 1.0], dtype=F64)
    for pop in (0, 1):
        want = ss.pulse_operator(rates, pop, b2).numpy()
        for r, w in zip(rates.tolist(), want):
            got = np.zeros((44, 45))
            for d in range(44):
                for (src, a, e), c in zip(idx[pop, d], coef[pop, d]):
                    got[d, src] += c * r**a * (1 - r) ** e
            np.testing.assert_allclose(got[:, :44], w, rtol=0, atol=1e-15)
            assert not got[:, 44].any()  # the pads read the buffer's zero


def test_a_library_is_stale_when_its_shared_header_changes(tmp_path):
    src, hdr, out = tmp_path / "k.cu", tmp_path / "s.cuh", tmp_path / "k.so"
    for f in (src, hdr, out):
        f.write_text("")
    os.utime(src, (100, 100))
    os.utime(hdr, (100, 100))
    os.utime(out, (200, 200))
    job = (out, src, ())
    assert stale([job]) == []
    os.utime(hdr, (300, 300))
    assert stale([job]) == [job]


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the spectrum kernel has no CPU form")
    return torch.device("cuda")


def _first_lanes(inp, w):
    """The spectrum's inputs of the first ``w`` lanes."""
    B = inp[0].shape[0]

    def cut(x):
        return x[:w] if torch.is_tensor(x) and x.dim() >= 1 and x.shape[0] == B else x

    lc, mi, pu, T_pre, T_post, catmask, sample_at, rebase, sites = inp
    return (*(cut(x) for x in (lc, mi, pu, T_pre, T_post, catmask)),
            [cut(v) for v in sample_at], cut(rebase), sites)


def _pair3_sweep(device):
    mx = os.path.join(FIX, "matrix")
    inp = io_psmc.read_psmc(os.path.join(mx, "pair3_1.psmc"), os.path.join(mx, "pair3_2.psmc"),
                            0, -1)
    data = make_bootstrap_data(io_jsfs.read_jafs(os.path.join(mx, "pair3.jsfs")),
                               probe.REPLICATES, seed=0)
    fs = sf.build_fused_sweep(inp.times, inp.lambdas, probe.SPLITS,
                              [[1, 4, "ST", 1, 1], [2, 4, "ST", 1, 1]], unfolded=True,
                              smooth=False, cpfit=True, device=device)
    return data, fs


def _north_star_inputs(device, which):
    """The spectrum's inputs in the sweep's first Nelder-Mead iteration over
    every cell of a benchmark configuration's 808 cells."""
    if which == "hanfre_ect":
        _, data, fs = probe.north_star(device, F64, cpfit=False)
    else:
        data, fs = _pair3_sweep(device)
    st, params, d7 = probe.first_iteration_lanes(fs, data)
    return _captured(sf, lambda: fs.llh(st, params, d7))


def _check_against_the_per_interval_path(basis, inp, pulsed):
    """The kernel against `jafs_spectrum_plain` on the card: rtol 1e-12 with
    equal NaN masks; the parts bit for bit where no pulse enters."""
    B = inp[0].shape[0]
    before = ksp.spectrum_kernel.launches
    parts = torch.empty((B, 3, 8), dtype=F64, device=inp[0].device)
    got = ksp.spectrum_kernel(basis, ksp.pack_spectrum(basis, *inp), parts=parts)
    assert ksp.spectrum_kernel.launches == before + 1
    pp = {}
    want = lk.jafs_spectrum_plain(basis, *inp, parts=pp)
    assert torch.equal(got.isnan(), want.isnan())
    torch.testing.assert_close(got.nan_to_num(), want.nan_to_num(), rtol=1e-12, atol=0)
    assert _same(lk.jafs_spectrum(basis, *inp), got)
    if not pulsed:
        for row, key in ((0, "pre"), (1, "post")):
            if pp[key] is not None:
                assert _same(parts[:, row, :7], pp[key]), key
        assert _same(parts[:, 2], pp["p8"])
    return got


@pytest.mark.parametrize("which", ["hanfre_ect", "pair3_2band_cpfit"])
def test_kernel_matches_the_per_interval_path_on_the_sweeps_on_card(cuda, which):
    """The first iteration's lanes (per-lane tables, T == 0 padding rows);
    the first 1 / 6 / 42 / 960 lanes alone bitwise as in the whole batch."""
    basis, *inp = _north_star_inputs(cuda, which)
    B = inp[0].shape[0]
    assert B >= 4848 and bool((inp[3] == 0).any())
    got = _check_against_the_per_interval_path(basis, inp, pulsed=False)
    for w in (1, 6, 42, 960):
        assert _same(lk.jafs_spectrum(basis, *_first_lanes(inp, w)), got[:w]), w


@pytest.mark.parametrize("name", [*FITS, *SWEEPS])
def test_kernel_matches_the_per_interval_path_on_card(cuda, name):
    """Single fits' shared tables (6-7 lanes), the sample before an interval
    and at the split, pulses."""
    basis, *inp = _inputs(name, cuda)
    got = _check_against_the_per_interval_path(basis, inp, pulsed=name in PULSED)
    assert bool(torch.isfinite(got).all())


def test_lanes_past_the_cap_give_nan_and_minus_inf_on_card(cuda):
    basis, lc, *rest = _inputs("fit_band", cuda)
    lc = lc.clone()
    lc[:2, 3, 0] = 1e12  # ||M t|| far past theta * 1024
    got = lk.jafs_spectrum(basis, lc, *rest)
    assert bool(got[:2].isnan().all()) and bool(torch.isfinite(got[2:]).all())
    data = torch.full((lc.shape[0], 7), 100.0, dtype=F64, device=cuda)
    llh, _, pos = lk.multinomial_llh(got, data, lk.multinomial_const(data, True), True)
    assert not bool(pos[:2].any()) and bool(pos[2:].all())


def test_kernel_refuses_float32_and_cpu_on_card(cuda):
    basis, lc, *rest = _inputs("fit_band", cuda)
    with pytest.raises(TypeError):
        ksp.spectrum_kernel(basis, ksp.pack_spectrum(basis, lc.float(), *rest))
    cpu = _inputs("fit_band")
    with pytest.raises(ValueError):
        ksp.spectrum_kernel(cpu[0], ksp.pack_spectrum(*cpu))
