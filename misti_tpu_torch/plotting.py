"""Result plotting: the 5-panel EPS/lineage-location figure.

Equivalent of the reference plot helpers (migrationIO.py:767-829): a main
log-x panel with the corrected and PSMC EPS step trajectories, three panels
with the per-genome lineage-location probabilities P(both in 1),
P(both in 2), P(split), and a no-coalescence panel -- driven from a parsed
.mi file (MigData).  The reference's broken `--fpsmc` overlay path
(MiSTIPlot.py:104 calls ReadPSMC with a stale signature) is implemented
here with the working reader, its evident intent.
"""

from __future__ import annotations

from typing import Optional

from .io.data import MigData


def _pyplot():
    """matplotlib's pyplot on the Agg backend, imported at the first figure:
    the package imports and runs without matplotlib (the GPU machine has
    none), only plotting needs it."""
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError("matplotlib is not available") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


class MiPlot:
    """Figure state holder (reference MiPlot static class)."""

    def __init__(self, hide_probs: bool = False):
        plt = _pyplot()
        self.hide_probs = hide_probs
        if not hide_probs:
            self.fig, (self.ax, self.pr11, self.pr22, self.pr12, self.nc) = (
                plt.subplots(
                    5, 1,
                    gridspec_kw=dict(hspace=0.5, height_ratios=[3, 1, 1, 1, 1]),
                )
            )
            for a in (self.ax, self.pr11, self.pr22, self.pr12, self.nc):
                a.semilogx()
        else:
            self.fig, self.ax = plt.subplots(1, 1)
            self.ax.semilogx()

    def add_title(self, title: str):
        self.ax.set_title(title)

    def add_step(self, times, values, label=""):
        self.ax.step(list(times) + [2 * times[-1]], [values[0]] + list(values),
                     alpha=0.7, label=label)

    def add_probs(self, pr11, pr22, pr12, times):
        if self.hide_probs:
            return
        nc = [
            [pr11[k][i] + pr22[k][i] + pr12[k][i] for i in range(len(pr11[k]))]
            for k in (0, 1)
        ]
        norm = lambda pr, k: [
            u / (v if v > 0 else 1) for u, v in zip(pr[k], nc[k])
        ]
        panels = [(self.pr11, pr11), (self.pr22, pr22), (self.pr12, pr12)]
        for ax, pr in panels:
            for k in (0, 1):
                vals = norm(pr, k)
                ax.step(list(times) + [2 * times[-1]], [vals[0]] + vals,
                        alpha=0.7, label=str(k + 1))
            ax.legend(loc="upper right", prop=dict(size=6))
        for k in (0, 1):
            self.nc.step(list(times) + [2 * times[-1]], [nc[k][0]] + nc[k],
                         alpha=0.7, label=str(k + 1))
        self.nc.legend(loc="upper right", prop=dict(size=6))

    def save(self, fout: str, limits: Optional[dict] = None):
        limits = limits or {}
        if "maxY" in limits:
            self.ax.set_ylim(top=limits["maxY"])
        if "minY" in limits:
            self.ax.set_ylim(bottom=limits["minY"])
        if "maxX" in limits:
            self.ax.set_xlim(right=limits["maxX"])
        if "minX" in limits:
            self.ax.set_xlim(left=limits["minX"])
        self.ax.legend()
        self.fig.savefig(fout)
        _pyplot().close(self.fig)


def plot_migration(data: MigData, fout: str, limits: Optional[dict] = None,
                   hide_probs: bool = False, psmc_overlay=None, title=None):
    """Render a parsed .mi result (reference ReadMigration doPlot path)."""
    p = MiPlot(hide_probs=hide_probs)
    llh_title = "-" if data.llh is None else str(round(data.llh, 1))
    p.add_title(title or f"llh = {llh_title}")
    inv = lambda xs: [1.0 / v for v in xs]
    sd = data.sample_date or 0
    p.add_step(data.times, inv(data.lambda1), "misti1")
    p.add_step(data.times[sd:], inv(data.lambda2)[sd:], "misti2")
    if data.lambdah1:
        p.add_step(data.times, inv(data.lambdah1), "psmc1")
        p.add_step(data.times[sd:], inv(data.lambdah2)[sd:], "psmc2")
    if psmc_overlay is not None:
        # working --fpsmc overlay: InputData from io.psmc.read_psmc
        times_abs = [0.0]
        for dt in psmc_overlay.times:
            times_abs.append(times_abs[-1] + dt)
        eps1 = [1.0 / l[0] for l in psmc_overlay.lambdas]
        eps2 = [1.0 / l[1] for l in psmc_overlay.lambdas]
        x = [v * psmc_overlay.scale_time for v in times_abs]
        p.add_step(x, eps1, "psmc1_raw")
        p.add_step(x, eps2, "psmc2_raw")
    if data.pr11 and len(data.pr11[0]) > 0:
        p.add_probs(data.pr11, data.pr22, data.pr12, data.times)
    if data.split_t is not None and data.times:
        p.ax.axvline(data.times[data.split_t], color="k", alpha=0.1)
    if data.mig_start is not None and data.mig_end is not None:
        p.ax.axvspan(data.times[data.mig_start], data.times[data.mig_end],
                     color="k", alpha=0.05)
    p.save(fout, limits)
