"""ms/msHOT command-string model parser (reference ReadMS, migrationIO.py:659-765).

Parses -n/-en/-eN/-em/-es/-ej arguments into an InputData with migration-band
and pulse lists whose times are mapped to merged-grid interval indices.
Factor-of-2 conventions preserved: band rate = 2 x ms rate, interval length
= 2 x ms time difference.
"""

from __future__ import annotations

from .data import InputData
from .units import print_err


def read_ms(argument_string: str) -> InputData:
    print_err(
        "WARNING: read_ms() mirrors the reference ReadMS and inherits its "
        "assumptions on the ms command line"
    )
    args = argument_string.split(" ")
    pops = [{0.0: 1.0}, {0.0: 1.0}]
    migr: list = [{}, {}]
    puls: dict = {}
    split_t = 0.0
    pop_move = None
    i = 0
    while i < len(args):
        a = args[i]
        if a == "-n":
            pop = int(args[i + 1])
            if pop not in (1, 2):
                raise ValueError("Population id should be 1 or 2.")
            pops[pop - 1][0.0] = float(args[i + 2])
            i += 3
        elif a == "-en":
            time = float(args[i + 1])
            pop = int(args[i + 2])
            if pop not in (1, 2):
                raise ValueError("Population id should be 1 or 2.")
            pops[pop - 1][time] = float(args[i + 3])
            i += 4
        elif a == "-eN":
            time = float(args[i + 1])
            size = float(args[i + 2])
            pops[0][time] = size
            pops[1][time] = size
            i += 3
        elif a == "-em":
            time = float(args[i + 1])
            direct = int(args[i + 2])
            rate = float(args[i + 4])
            migr[direct - 1][time] = [rate, direct]
            i += 5
        elif a == "-es":
            time = float(args[i + 1])
            pop = int(args[i + 2])
            rate = 1 - float(args[i + 3])
            puls[time] = [rate, pop]
            i += 4
        elif a == "-ej":
            if int(args[i + 2]) <= 2:
                split_t = float(args[i + 1])
                pop_move = int(args[i + 2]) - 1
            i += 4
        else:
            i += 1
    if pop_move is None:
        raise ValueError("Populations should be merged. (-ej [time] 2 1)")

    times = set()
    for k in (0, 1):
        times.update(pops[k].keys())
        times.update(migr[k].keys())
    times.update(puls.keys())
    times.add(split_t)
    times = sorted(times)
    times_d = {t: i for i, t in enumerate(times)}
    split_ind = times_d[split_t]

    pop_sizes = [[0.0, 0.0] for _ in times]
    for k in (0, 1):
        for t, val in pops[k].items():
            pop_sizes[times_d[t]][k] = val
        cur = 0.0
        for row in pop_sizes:
            if row[k] == 0:
                row[k] = cur
            else:
                cur = row[k]
    pop_dest = (pop_move + 1) % 2
    for i in range(split_ind, len(pop_sizes)):
        pop_sizes[i][pop_move] = pop_sizes[i][pop_dest]

    mis = []
    for k in (0, 1):
        for t, val in migr[k].items():
            mis.append([val[1], times_d[t], split_ind, 2 * val[0], 0])
    mis.sort(key=lambda el: (el[0], el[1]))
    for i in range(len(mis) - 1):
        if mis[i][0] == mis[i + 1][0]:
            mis[i][2] = mis[i + 1][1]

    pus = [[val[1], times_d[t], val[0], 0] for t, val in puls.items()]

    dt = [2 * (u - v) for u, v in zip(times[1:], times[:-1])]
    lk = [[1.0 / u[0], 1.0 / u[1]] for u in pop_sizes]
    return InputData(
        times=dt, lambdas=lk, scale_time=1.0, theta=1.0,
        divergence_time=split_ind, mi=mis, pu=pus,
    )
