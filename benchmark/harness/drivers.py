"""The system under test, as the benchmark drives it: the port's entries.

A driver reads the configuration's input files with the port's readers,
serves one request at a time (`serve`), and keeps what each request
returned for the judge.  Nothing here imports the port before a driver is
built, so the harness's own tests run without it.
"""

from __future__ import annotations

import contextlib
import io
import time

import numpy as np

from benchmark.reference.fit import flags, templates
from benchmark.reference.optimize import _initial_simplex


def _quiet():
    """The port's progress lines (Nelder-Mead summaries, sweep stages) go
    to a buffer: the run's own output is its result."""
    stack = contextlib.ExitStack()
    stack.enter_context(contextlib.redirect_stdout(io.StringIO()))
    stack.enter_context(contextlib.redirect_stderr(io.StringIO()))
    return stack


class _Driver:
    def __init__(self, config: dict, mix: dict, device: str, dtype):
        import torch

        from misti_tpu_torch.io import psmc as io_psmc

        self.config, self.mix, self.dtype = config, mix, dtype
        self.device = torch.device(device)
        paths = config["paths"]
        self.input = io_psmc.read_psmc(paths["psmc1"], paths["psmc2"])
        self.splits = [float(v) for v in
                       np.arange(config["splits"][0], config["splits"][1] + 1)]
        self.flags = flags(config)
        self.done = []  # what each request returned, in order

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class Sweep(_Driver):
    """One request: one ``misti_tpu_torch.engine.bootstrap.sweep`` over the
    configuration's split times and a (replicates + 1, 7) spectra array, as
    the sweep CLI calls it (the per-split tables built inside)."""

    def serve(self, spectra: np.ndarray, keep: bool = True) -> dict:
        from misti_tpu_torch.engine.bootstrap import sweep

        t0 = time.perf_counter()
        with _quiet():
            res = sweep(self.input.times, self.input.lambdas, spectra, self.splits,
                        self.config["mi"], self.config.get("pu", []), tol=self.mix["tol"],
                        device=self.device, dtype=self.dtype,
                        sample_date=self.input.sample_date_discr,
                        stage_caps=tuple(self.mix["stage_caps"]), maxiter=self.mix["maxiter"],
                        **self.flags)
        self.sync()
        t1 = time.perf_counter()
        rec = dict(name="sweep", t0=t0, t1=t1, calls=int(res.calls), cells=int(res.llh.size),
                   nfev=int(res.nfev.sum()), unconverged=int((~res.converged).sum()),
                   finite=bool(np.isfinite(res.llh).all()))
        if keep:
            self.done.append(dict(spectra=spectra, llh=res.llh, params=res.params,
                                  nfev=res.nfev, converged=res.converged))
        return rec

    def first_call(self, spectra: np.ndarray) -> dict:
        """The first objective call of a sweep of ``spectra``, rebuilt by the
        benchmark: every cell's initial simplex at the configuration's start
        (W cells x (n + 1) points), on the port's fused likelihood."""
        import torch

        from misti_tpu_torch.engine.sweep_fused import build_fused_sweep

        fs = build_fused_sweep(self.input.times, self.input.lambdas, self.splits,
                               self.config["mi"], self.config.get("pu", []),
                               sample_date=self.input.sample_date_discr, device=self.device,
                               dtype=self.dtype, **self.flags)
        S, R = len(self.splits), spectra.shape[0]
        x0 = torch.as_tensor(np.tile(fs.init_params, (S * R, 1)), dtype=torch.float64)
        points = _initial_simplex(x0)  # (W, n + 1, n)
        P, n = points.shape[1], points.shape[2]
        st = torch.arange(S).repeat_interleave(R).repeat_interleave(P).to(self.device)
        params = points.reshape(-1, n).to(self.device, self.dtype)
        data = torch.as_tensor(np.tile(spectra, (S, 1)), dtype=torch.float64)
        data = data.repeat_interleave(P, 0).to(self.device)
        return dict(fs=fs, st=st, params=params, rows=R, call=lambda: fs.llh(st, params, data))


class Fit(_Driver):
    """One request: a single fit, as ``cli/misti.py`` makes it (lines
    136-155) without its file reads and prints: ``build_spec``,
    ``build_likelihood`` and ``solve`` at a split time and a bootstrap row."""

    def __init__(self, config, mix, device, dtype, spectra: np.ndarray):
        super().__init__(config, mix, device, dtype)
        self.spectra = spectra

    def _spec(self, split: float, row: int):
        from misti_tpu_torch.engine.spec import build_spec

        mi, pu = templates(self.config, split)
        return build_spec(self.input.times, self.input.lambdas, [0.0, *self.spectra[row]],
                          split, mi, pu, sample_date=self.input.sample_date_discr,
                          thrh=(self.input.theta, self.input.rho), **self.flags)

    def serve(self, req, keep: bool = True) -> dict:
        from misti_tpu_torch.engine.likelihood import build_likelihood
        from misti_tpu_torch.engine.optimize import solve

        split, row = req
        t0 = time.perf_counter()
        spec = self._spec(split, row)
        t1 = time.perf_counter()
        lik = build_likelihood(spec, device=self.device, dtype=self.dtype)
        t2 = time.perf_counter()
        with _quiet():
            sol = solve(lik, self.mix["tol"])
        self.sync()
        t3 = time.perf_counter()
        rec = dict(name="fit", t0=t0, t1=t3, spec_s=t1 - t0, build_s=t2 - t1, solve_s=t3 - t2,
                   nit=sol.nit, nfev=sol.nfev, finite=bool(np.isfinite(sol.llh)))
        if keep:
            self.done.append(dict(split=split, row=row, x=np.asarray(sol.x, float),
                                  llh=float(sol.llh), nfev=sol.nfev))
        return rec
