"""The traffic generator draws each request on demand from the seed and its
place, and the judge's sample holds the stragglers."""

import numpy as np

from benchmark.harness import layout
from benchmark.harness.judge import sample
from benchmark.harness.traffic import Requests, rng_of
from benchmark.reference.readers import read_jafs_rows

SEED = 2**31 + 987_654


def _requests(cell, seed=SEED):
    bench = layout.benchmark()
    entry = layout.cell(bench, cell)
    config = layout.config(bench, entry["config"])
    rows = np.asarray(read_jafs_rows(config["paths"]["jsfs"]), float)
    return Requests(layout.traffic(entry["traffic"]), config, rows, seed)


def test_a_sweeps_requests_depend_on_the_seed_and_place_alone():
    a, b = _requests("hanfre_ect.sweep"), _requests("hanfre_ect.sweep")
    late = b.window(40)  # drawn first, as a fast program would reach it
    drawn = [a.window(i) for i in range(41)]
    assert np.array_equal(drawn[40], late) and drawn[0].shape == (101, 7)
    assert len({x.tobytes() for x in drawn + [a.warm(0), a.profile()]}) == 43
    assert not np.array_equal(_requests("hanfre_ect.sweep", SEED + 1).window(0), drawn[0])
    assert (drawn[0][0] == drawn[5][0]).all()  # row 0: the summed spectrum


def test_fits_come_in_turns_of_every_split_time():
    r = _requests("hanfre_ect.fit")
    reqs = [r.window(i) for i in range(24)]
    for turn in range(3):
        assert sorted(st for st, _ in reqs[8 * turn:8 * turn + 8]) == list(range(20, 28))
    assert all(0 <= row <= 100 for _, row in reqs)
    assert reqs == [_requests("hanfre_ect.fit").window(i) for i in range(24)]
    assert r.spectra.shape == (101, 7)


def test_the_sample_holds_the_stragglers():
    nfev = [5, 9, 1, 7, 3, 9, 2, 4]
    got = sample(4, 2, lambda i: nfev[i], 2, 3, rng_of(1, "judge"))
    assert {1, 5, 3} <= set(got) and 3 <= len(got) <= 5 and got == sorted(got)
