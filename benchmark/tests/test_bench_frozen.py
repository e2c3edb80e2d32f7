"""The frozen reference, readers and work meters give the port's numbers
of today on small fixed inputs on the CPU.  Only this file imports the
port."""

import numpy as np
import pytest
import torch

from benchmark.harness import layout
from benchmark.harness.traffic import bootstrap_set, resamples, rng_of
from benchmark.reference import likelihood as ref_lik
from benchmark.reference import optimize as ref_opt
from benchmark.reference.fit import flags, templates
from benchmark.reference.readers import read_jafs_rows, read_psmc
from benchmark.reference.spec import build_spec
from benchmark.roofline import correction as w_corr
from benchmark.roofline import expm_action as w_expm
from benchmark.roofline import post_fit as w_post
from benchmark.roofline.first_call import lanes

CONFIGS = ["hanfre_ect", "pair3_2band_cpfit"]


@pytest.fixture(scope="module", params=CONFIGS)
def config(request):
    return layout.config(layout.benchmark(), request.param)


def _port_inputs(config):
    from misti_tpu_torch.io import jsfs, psmc

    d = psmc.read_psmc(config["paths"]["psmc1"], config["paths"]["psmc2"])
    return d, jsfs.read_jafs(config["paths"]["jsfs"])


def test_readers_read_what_the_port_reads(config):
    d, j = _port_inputs(config)
    times, lambdas, scale = read_psmc(config["paths"]["psmc1"], config["paths"]["psmc2"])
    assert times == d.times and lambdas == d.lambdas and scale == d.scale_time
    assert read_jafs_rows(config["paths"]["jsfs"]) == j.jafs


def test_the_likelihood_is_the_ports_on_the_cpu(config):
    from misti_tpu_torch.engine.likelihood import build_likelihood
    from misti_tpu_torch.engine.spec import build_spec as port_spec

    d, _ = _port_inputs(config)
    rows = np.asarray(read_jafs_rows(config["paths"]["jsfs"]))
    data = bootstrap_set(rows, 2, rng_of(5, "test"))
    mi, pu = templates(config, 23.0)
    ours = build_spec(d.times, d.lambdas, [0.0, *data[1]], 23.0, mi, pu, **flags(config))
    theirs = port_spec(d.times, d.lambdas, [0.0, *data[1]], 23.0, mi, pu, **flags(config))
    assert ours.llh_const == theirs.llh_const and np.array_equal(ours.lh, theirs.lh)
    n = ours.n_params
    params = torch.tensor([[0.7] * n, [2.5] * n, [1e-4] * n, [-1.0] * n], dtype=torch.float64)
    dd = torch.as_tensor(np.resize(data, (4, 7)))
    got = ref_lik.build_llh(ours)(params, dd, ref_lik.multinomial_const(dd, True))
    want = build_likelihood(theirs, device="cpu").llh_data(params, dd)
    assert torch.equal(got, want) and bool(torch.isinf(got[3]))


def test_nelder_mead_is_the_ports():
    from misti_tpu_torch.engine.optimize import nelder_mead

    def f(points):
        return ((points - torch.tensor([0.3, 2.0], dtype=torch.float64)) ** 2).sum(-1) + \
            0.1 * torch.sin(5 * points[..., 0])

    x0 = torch.tensor([[1.0, 1.0], [0.0, 3.0]], dtype=torch.float64)
    a, b = ref_opt.nelder_mead(f, x0), nelder_mead(f, x0)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_the_first_call_rebuild_is_the_ports_input(config):
    from misti_tpu_torch.engine.sweep_fused import build_fused_sweep

    d, _ = _port_inputs(config)
    splits = [float(s) for s in range(config["splits"][0], config["splits"][1] + 1)]
    fs = build_fused_sweep(d.times, d.lambdas, splits, config["mi"], config["pu"],
                           device="cpu", **flags(config))
    inp, opts, _, _ = lanes(config)
    P = inp.shape[2] // len(splits)
    points = ref_opt._initial_simplex(torch.as_tensor(fs.init_params[None]))[0]
    st = torch.arange(len(splits)).repeat_interleave(P)
    want = fs.kernel_input(st, points.repeat(len(splits), 1))
    assert torch.equal(inp, want) and opts == fs.kernel_opts


def test_the_work_meters_are_the_ports():
    from misti_tpu_torch.engine.likelihood import SpectrumBasis
    from misti_tpu_torch.kernels import correction_fused as cf
    from misti_tpu_torch.kernels import expm_action as ea
    from misti_tpu_torch.kernels import post_fit as pf

    config = layout.config(layout.benchmark(), "hanfre_ect")
    inp, opts, coeffs, T = lanes(config)
    work = w_corr.sweep_work(inp, **opts)
    assert work == cf.sweep_work(inp, **opts)
    s, B = inp.shape[1], inp.shape[2]
    assert w_corr.sweep_ops(work, s, B, **opts) == cf.sweep_ops(work, s, B, **opts)
    basis = SpectrumBasis(torch.device("cpu"), torch.float64)
    for t in (0, 12, s - 1):
        assert w_expm.expm_action_ops(basis.sp2, coeffs[:, t], basis.norms2, T[:, t], Q=7) == \
            ea.expm_action_ops(basis.sp2, coeffs[:, t], basis.norms2, T[:, t], Q=7)
    assert w_expm.expm_action_bytes(B, basis.sp2, itemsize=8, per_lane_t=True, Q=7) == \
        ea.expm_action_bytes(B, basis.sp2, itemsize=8, per_lane_t=True, Q=7)
    g = torch.Generator().manual_seed(3)
    nc = -torch.rand((6, 2), generator=g, dtype=torch.float64)
    lh = 0.5 + torch.rand((1, 9, 2), generator=g, dtype=torch.float64)
    Tp = torch.rand((1, 9), generator=g, dtype=torch.float64)
    Tp[0, 4] = 0.0
    for cpfit in (False, True):
        assert w_post.post_fit_ops(nc, lh, Tp, cpfit=cpfit) == \
            pf.post_fit_ops(nc, lh, Tp, cpfit=cpfit)
    assert w_post.post_fit_bytes(6, 1, 9) == pf.post_fit_bytes(6, 1, 9)


def test_a_resample_follows_the_bootstrap_rule():
    rows = np.asarray(read_jafs_rows(layout.config(
        layout.benchmark(), "hanfre_ect")["paths"]["jsfs"]))
    a = bootstrap_set(rows, 3, rng_of(9, "x"))
    b = bootstrap_set(rows, 3, rng_of(9, "x"))
    assert np.array_equal(a, b) and np.array_equal(a[0], rows[:, 1:].sum(0))
    # upstream's loop (BootstrapJAFS) over each resample's stream of chunk indices
    genome, k = rows[:, 0].sum(), rows.shape[0]
    for seed in (1, 2, 2**31 + 3):
        got = resamples(rows, 50, rng_of(seed, "rule"))
        idx = rng_of(seed, "rule").integers(0, k, size=(50, 2 * k))
        for i in range(50):
            sfs, j = np.zeros(8), 0
            while sfs[0] < genome:
                sfs += rows[idx[i, j]]
                j += 1
            assert np.array_equal(got[i], sfs[1:])
