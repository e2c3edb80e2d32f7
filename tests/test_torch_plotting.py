"""The port's plots (misti_tpu_torch.plotting, misti_tpu_torch.cli.mistiplot),
mirroring tests/test_plotting.py: the 5-panel figure's structure, the
``--hideProbs`` single panel, the working ``--fpsmc`` overlay, and the CLI
end to end; that every figure holds the same lines, labels, scales and
limits as the JAX package's (misti_tpu.plotting, misti_tpu.cli.mistiplot)
for the same input; and that the package imports, and says why it cannot
plot, without matplotlib (the GPU machine has none).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from misti_tpu_torch import plotting
from misti_tpu_torch.io import mi_format
from misti_tpu_torch.io import psmc as io_psmc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures")
MI = os.path.join(FIX, "ref_fit.mi")


@pytest.fixture
def spy(monkeypatch):
    """Render through `plot_migration` and keep the figure's axes."""
    pytest.importorskip("matplotlib")
    seen = {}
    orig_save = plotting.MiPlot.save

    def spy_save(self, fout, limits=None):
        seen["axes"], seen["main"] = self.fig.axes, self.ax
        return orig_save(self, fout, limits)

    monkeypatch.setattr(plotting.MiPlot, "save", spy_save)
    return seen


def test_plot_migration_panels(tmp_path, spy):
    out = tmp_path / "fig.pdf"
    plotting.plot_migration(mi_format.read_migration(MI), str(out))
    assert out.exists() and out.stat().st_size > 1000
    # main EPS + P(both in 1) + P(both in 2) + P(split) + no-coalescence
    assert len(spy["axes"]) == 5
    labels = [ln.get_label() for ln in spy["main"].get_lines()]
    assert "misti1" in labels and "misti2" in labels
    for ax in spy["axes"][1:]:
        assert len(ax.get_lines()) == 2  # one step line per genome
    assert all(ax.get_xscale() == "log" for ax in spy["axes"])


def test_plot_migration_hide_probs(tmp_path, spy):
    out = tmp_path / "fig.pdf"
    plotting.plot_migration(mi_format.read_migration(MI), str(out), hide_probs=True)
    assert out.exists() and len(spy["axes"]) == 1


def test_fpsmc_overlay_adds_raw_trajectories(tmp_path, spy):
    overlay = io_psmc.read_psmc(os.path.join(FIX, "synth1.psmc"),
                                os.path.join(FIX, "synth2.psmc"), 0, -1)
    plotting.plot_migration(mi_format.read_migration(MI), str(tmp_path / "fig.pdf"),
                            psmc_overlay=overlay)
    labels = [ln.get_label() for ln in spy["main"].get_lines()]
    assert "psmc1_raw" in labels and "psmc2_raw" in labels


def test_mistiplot_cli_end_to_end(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    from misti_tpu_torch.cli import mistiplot

    out = tmp_path / "cli_fig.pdf"
    rc = mistiplot.main([MI, "--funits", "/nonexistent", "-o", str(out), "--maxY", "5",
                         "--fpsmc", os.path.join(FIX, "synth1.psmc"),
                         os.path.join(FIX, "synth2.psmc")])
    assert rc == 0
    assert out.exists() and out.stat().st_size > 1000
    assert "Output file" in capsys.readouterr().out


def _describe(fig):
    """Everything a figure draws: per axis its title, scales, limits, legend
    labels, and each line's label, alpha and data; each patch's vertices."""
    return [dict(title=ax.get_title(), xscale=ax.get_xscale(), yscale=ax.get_yscale(),
                 xlim=ax.get_xlim(), ylim=ax.get_ylim(),
                 legend=None if ax.get_legend() is None
                 else [t.get_text() for t in ax.get_legend().get_texts()],
                 lines=[(ln.get_label(), ln.get_alpha(), np.asarray(ln.get_xdata(), float),
                         np.asarray(ln.get_ydata(), float)) for ln in ax.get_lines()],
                 patches=[np.asarray(pa.get_xy(), float) for pa in ax.patches])
            for ax in fig.axes]


def _render(monkeypatch, plot_mod, draw):
    """Run ``draw()`` and describe the figure that ``plot_mod.MiPlot.save``
    saved, after its limits and legend were set."""
    seen = []
    orig_save = plot_mod.MiPlot.save

    def spy_save(self, fout, limits=None):
        orig_save(self, fout, limits)
        seen.append(_describe(self.fig))

    monkeypatch.setattr(plot_mod.MiPlot, "save", spy_save)
    draw()
    assert len(seen) == 1
    return seen[0]


def _assert_same_figure(port, ref):
    assert len(port) == len(ref)
    for pa, ra in zip(port, ref):
        for key in ("title", "xscale", "yscale", "xlim", "ylim", "legend"):
            assert pa[key] == ra[key], key
        assert [ln[:2] for ln in pa["lines"]] == [ln[:2] for ln in ra["lines"]]
        for pl, rl in zip(pa["lines"], ra["lines"]):
            np.testing.assert_array_equal(pl[2], rl[2], err_msg=f"{pl[0]} x")
            np.testing.assert_array_equal(pl[3], rl[3], err_msg=f"{pl[0]} y")
        assert len(pa["patches"]) == len(ra["patches"])
        for pp, rp in zip(pa["patches"], ra["patches"]):
            np.testing.assert_array_equal(pp, rp)


# (.mi fixture, overlay spectra or None, sample date of the overlay,
#  hide_probs, limits)
FIGURES = {
    "plain": ("ref_fit.mi", None, 0, False, None),
    "pulse_limits": ("ref_fit_pu.mi", None, 0, False,
                     dict(maxY=3.0, minY=0.1, maxX=1e5, minX=10.0)),
    "sdate_overlay": ("ref_fit_sdate.mi", ("sweep1.psmc", "sweep2.psmc"), 2000.0, False,
                      None),
}


@pytest.mark.parametrize("case", list(FIGURES))
def test_plot_migration_matches_jax(tmp_path, monkeypatch, case):
    """The port's figure draws the JAX package's lines, point for point: the
    EPS steps (1/lambda), the normalised pr11/pr22/pr12 and no-coalescence
    steps, the raw PSMC overlay in scaled time, the split marker, the
    titles, scales and limits."""
    pytest.importorskip("matplotlib")
    from misti_tpu import plotting as jax_plotting
    from misti_tpu.io import mi_format as jax_mi_format
    from misti_tpu.io import psmc as jax_psmc

    fmi, overlay, sdate, hide, limits = FIGURES[case]
    figs = []
    for plot_mod, mi_mod, psmc_mod in ((plotting, mi_format, io_psmc),
                                       (jax_plotting, jax_mi_format, jax_psmc)):
        ov = None if overlay is None else psmc_mod.read_psmc(
            os.path.join(FIX, overlay[0]), os.path.join(FIX, overlay[1]), sdate, -1)
        data = mi_mod.read_migration(os.path.join(FIX, fmi))
        figs.append(_render(monkeypatch, plot_mod, lambda: plot_mod.plot_migration(
            data, str(tmp_path / "fig.pdf"), limits=limits, hide_probs=hide,
            psmc_overlay=ov)))
    _assert_same_figure(*figs)
    assert any(ln[0] == "misti1" for ln in figs[0][0]["lines"])


# the CLI's own units file: time scaled by 2 * genTime * N0 in the overlay
UNITS = "mutRate=1.4e-8\nbinsize=100\nN0=12000\ngenTime=25\n"
CLI_ARGS = {
    "default_units": ["ref_fit.mi", "--funits", "/nonexistent", "--maxY", "5",
                      "--fpsmc", "synth1.psmc", "synth2.psmc"],
    "units_sdate_hide": ["ref_fit_sdate.mi", "--funits", "{units}", "--sdate", "3000",
                         "-hp", "--minX", "100", "--fpsmc", "sweep1.psmc", "sweep2.psmc",
                         "-rd", "0"],
}


@pytest.mark.parametrize("case", list(CLI_ARGS))
def test_mistiplot_cli_matches_jax(tmp_path, monkeypatch, capsys, case):
    """``mistiplot`` end to end through both packages on the same argv
    (units file, sample date, round, limits): the same figure and stdout."""
    pytest.importorskip("matplotlib")
    from misti_tpu import plotting as jax_plotting
    from misti_tpu.cli import mistiplot as jax_mistiplot
    from misti_tpu.io.units import Units as JaxUnits
    from misti_tpu_torch.cli import mistiplot
    from misti_tpu_torch.io.units import Units

    (tmp_path / "units.txt").write_text(UNITS)
    argv = [a.format(units=str(tmp_path / "units.txt")) for a in CLI_ARGS[case]]
    argv += ["-wd", FIX, "-o", str(tmp_path / "fig.pdf")]
    figs, outs = [], []
    try:
        for cli, plot_mod in ((mistiplot, plotting), (jax_mistiplot, jax_plotting)):
            figs.append(_render(monkeypatch, plot_mod, lambda: cli.main(argv)))
            outs.append(capsys.readouterr().out)
    finally:
        Units.reset()
        JaxUnits.reset()
    _assert_same_figure(*figs)
    assert outs[0] == outs[1]
    assert any(ln[0] == "psmc1_raw" for ln in figs[0][0]["lines"])


_NO_MPL = r"""
import sys
sys.modules["matplotlib"] = None  # import matplotlib now raises ImportError
import misti_tpu_torch
from misti_tpu_torch import plotting
from misti_tpu_torch.cli import mistiplot, tools
try:
    plotting.MiPlot()
except RuntimeError as e:
    print("REFUSED", e)
"""


def test_the_package_imports_without_matplotlib():
    out = subprocess.run([sys.executable, "-c", _NO_MPL], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert "REFUSED matplotlib is not available" in out.stdout
