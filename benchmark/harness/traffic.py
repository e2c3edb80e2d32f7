"""The one traffic generator: requests from a mix's parameters and a seed.

A mix (``traffic/<name>.json``) is data.  ``kind`` says what a request is:

* ``sweep``: one bootstrap x split-time sweep, upstream's test.bs workflow
  as one ``misti_tpu_torch.engine.bootstrap.sweep`` call: ``replicates``
  fresh bootstrap resamples of the configuration's JSFS chunks plus the
  summed spectrum (row 0), fitted at every split time of the
  configuration.  Sweeps follow one another (one closed-loop client).
* ``fit``: one single fit, upstream's ``MiSTI.py ... -bs row st``: a split
  time and a row of one bootstrap set of ``replicates`` resamples (row 0
  the summed spectrum).  The rows are drawn uniformly from the seed; the
  split times come in turns of all of them, each turn in an order drawn
  from the seed, so that every seed fits them in the same proportions.

Each request is drawn when it is asked for, from a stream of its own
(`rng_of` of the seed and the request's place), so that the window never
runs out of requests and never serves one twice, however fast the program
gets.  A sweep's draw takes a few milliseconds, well under 1% of a sweep.
"""

from __future__ import annotations

import numpy as np


def rng_of(seed: int, stream: str) -> np.random.Generator:
    """A generator per (seed, purpose); any whole seed, however large."""
    key = [seed & (2**64 - 1), seed < 0] + [ord(c) for c in stream]
    return np.random.default_rng(np.random.SeedSequence(key))


def resamples(rows: np.ndarray, n: int, rng: np.random.Generator) -> np.ndarray:
    """(n, 7) bootstrap spectra: for each, chunk rows drawn with replacement
    until their total length reaches the genome's (upstream's
    BootstrapJAFS, migrationIO.py:506-524, as utils/generateJSFS_bs.py
    uses it).  Each takes its chunks in order from its own row of
    ``2 * chunks`` draws, and one at a time after them in the (never
    observed) case that they fall short."""
    totals = rows[:, 0]
    genome, k = totals.sum(), rows.shape[0]
    idx = rng.integers(0, k, size=(n, 2 * k))
    cum = np.cumsum(totals[idx], axis=1)
    hit = (cum >= genome).argmax(axis=1)
    taken = np.arange(2 * k)[None, :] <= hit[:, None]
    counts = np.bincount((idx + (np.arange(n) * k)[:, None])[taken], minlength=n * k)
    out = counts.reshape(n, k) @ rows[:, 1:]  # whole counts: every sum exact
    for i in np.flatnonzero(cum[:, -1] < genome):
        sfs = rows[idx[i], :].sum(0)
        while sfs[0] < genome:
            sfs += rows[rng.integers(0, k)]
        out[i] = sfs[1:]
    return out


def bootstrap_set(rows: np.ndarray, replicates: int, rng: np.random.Generator) -> np.ndarray:
    """(replicates + 1, 7): row 0 the summed spectrum, then the resamples
    (the generateJSFS_bs.py convention)."""
    return np.concatenate([rows[None, :, 1:].sum(1), resamples(rows, replicates, rng)])


class Requests:
    """A mix's requests for one seed: ``warm(i)`` the set-up's, ``profile()``
    the traced run's, ``window(i)`` the window's, each drawn on demand.  A
    sweep is a (replicates + 1, 7) spectra array; a fit a (split, row index)
    pair into ``spectra``, the fits' one bootstrap set."""

    def __init__(self, mix: dict, config: dict, rows: np.ndarray, seed: int):
        if mix["kind"] not in ("sweep", "fit"):
            raise ValueError(f"unknown traffic kind {mix['kind']!r}")
        self.kind, self.replicates, self.seed, self.rows = (
            mix["kind"], mix["replicates"], seed, rows)
        if self.kind == "fit":
            self.spectra = bootstrap_set(rows, self.replicates, self._rng("spectra"))
            self.splits = np.arange(config["splits"][0], config["splits"][1] + 1, dtype=float)

    def _rng(self, stream: str) -> np.random.Generator:
        return rng_of(self.seed, f"{self.kind}:{stream}")

    def _draw(self, stream: str, split_of):
        if self.kind == "sweep":
            return bootstrap_set(self.rows, self.replicates, self._rng(stream))
        rng = self._rng(stream)
        return float(split_of(rng)), int(rng.integers(0, self.spectra.shape[0]))

    def warm(self, i: int):
        return self._draw(f"warm:{i}", lambda rng: self.splits[i % self.splits.size])

    def profile(self):
        return self._draw("profile", lambda rng: rng.choice(self.splits))

    def window(self, i: int):
        """The window's request ``i``: a fit's split time is place ``i % S``
        of turn ``i // S``, each turn the S split times in an order of its
        own, so that any window holds them in the same proportions."""
        if self.kind == "sweep":
            return self._draw(str(i), None)
        S = self.splits.size
        order = self._rng(f"turn:{i // S}").permutation(self.splits)
        return self._draw(str(i), lambda rng: order[i % S])
