"""Frozen copy of ``misti_tpu_torch/model/statespace.py`` at commit 4de6f0d, for the
benchmark's reference: a later change to the port does not move it.
It imports nothing of the port.

Coalescent CTMC state spaces as constant basis tensors.

The reference implementation (TwoPopulations.py, OnePopulation.py in MiSTI)
re-enumerates the ancestral-configuration state space and rebuilds the dense
rate matrix with pure-Python loops on *every* likelihood evaluation.  Here the
state spaces are enumerated exactly once at import time and the model is
expressed through constant tensors, exploiting the fact that the CTMC
generator is *linear* in the four rates (cf. reference
TwoPopulations.py:336-359, the rate rules in ``UpdateMatrixCol``)::

    M(l1, l2, m1, m2) = l1*C0 + l2*C1 + m1*G0 + m2*G1        (44x44)
    M1(l)             = l*C                                   (8x8)
    M3(l0, l1, m0, m1)                                        (3x3)

so a likelihood evaluation only does fused scalar*matrix multiplies and
batched matmuls -- no Python-level state bookkeeping.  The basis
enumeration is numpy; the rate-matrix assemblers at the bottom are torch,
batch-first: rates (B,) -> matrices (B, n, n).

State space (two populations, two diploid samples => 2+2 lineages):
each ancestral lineage is a triple (d0, d1, pop) where d0/d1 count its
descendants in genome 1/genome 2 and pop is its current population.  A state
is a multiset of lineages with sum(d0) == 2 and sum(d1) == 2.  The
fully-coalesced single-lineage state (2,2) is absorbing and dropped, leaving
9 four-lineage + 20 three-lineage + 15 two-lineage = 44 states.  The index
layout reproduces the reference layout (TwoPopulations.py:99-128) because
downstream operators (collapse ranges, ancient-sample targets, the initial
condition P0[2] = 1) are defined in terms of these indices:

    0..8    four lineages: index = i + 3*j with i = sum of pops of the two
            (0,1) lineages, j = sum of pops of the two (1,0) lineages
    9..14   pair (2,0) + two (0,1): 9 + 3*pop_pair + pop_a + pop_b
    15..22  pair (1,1) + (1,0) + (0,1): 15 + 4*pop_pair + 2*pop_10 + pop_01
    23..28  pair (0,2) + two (1,0): 23 + 3*pop_pair + pop_a + pop_b
    29..32  (2,1) + (0,1): 29 + 2*p0 + p1
    33..36  (1,2) + (1,0): 33 + 2*p0 + p1
    37..40  (2,0) + (0,2): 37 + 2*p0 + p1
    41..43  (1,1) + (1,1): 41 + p0 + p1

One population (post-split, reference OnePopulation.py:64-107): lineages are
(d0, d1) pairs, 8 states in the fixed order
    0: {(1,0),(1,0),(0,1),(0,1)}   1: {(2,0),(0,1),(0,1)}
    2: {(1,1),(1,0),(0,1)}         3: {(0,2),(1,0),(1,0)}
    4: {(2,1),(0,1)}               5: {(1,2),(1,0)}
    6: {(2,0),(0,2)}               7: {(1,1),(1,1)}

JSFS categories (7 of them, matching reference StateToJAF and the canonical
column order 0100,1100,0001,0101,1101,0011,0111 of the MiSTI JSFS format):
a lineage (d0,d1) contributes one mutation opportunity to category
    (1,0)->0  (2,0)->1  (0,1)->2  (1,1)->3  (2,1)->4  (0,2)->5  (1,2)->6
"""

from __future__ import annotations

import dataclasses
import itertools
from functools import lru_cache

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Lineage / state utilities (pure Python, runs once at import)
# ---------------------------------------------------------------------------

# JSFS category of a lineage by its descendant signature (d0, d1).
_JAF_CATEGORY = {
    (1, 0): 0,
    (2, 0): 1,
    (0, 1): 2,
    (1, 1): 3,
    (2, 1): 4,
    (0, 2): 5,
    (1, 2): 6,
}

ABSORBING = -1  # marker for the fully coalesced (2,2) lineage state


def _canon2(state):
    """Canonical form of a two-population state: sorted tuple of triples.

    Sort mirrors the reference ``CheckState`` ordering: primary key
    d0+d1 descending, then d0 descending, then pop ascending.
    """
    return tuple(
        sorted(state, key=lambda l: (-(l[0] + l[1]), -l[0], l[2]))
    )


def _index2(state):
    """Index of a canonical two-population state (reference layout)."""
    n = len(state)
    if n == 4:
        i = sum(l[2] for l in state if l[0] == 0)
        j = sum(l[2] for l in state if l[0] == 1)
        return i + 3 * j
    if n == 3:
        pair = state[0]
        rest = state[1:]
        if pair[:2] == (2, 0):
            return 9 + 3 * pair[2] + rest[0][2] + rest[1][2]
        if pair[:2] == (1, 1):
            p10 = next(l for l in rest if l[:2] == (1, 0))
            p01 = next(l for l in rest if l[:2] == (0, 1))
            return 15 + 4 * pair[2] + 2 * p10[2] + p01[2]
        if pair[:2] == (0, 2):
            return 23 + 3 * pair[2] + rest[0][2] + rest[1][2]
    if n == 2:
        a, b = state
        if a[:2] == (2, 1) and b[:2] == (0, 1):
            return 29 + 2 * a[2] + b[2]
        if a[:2] == (1, 2) and b[:2] == (1, 0):
            return 33 + 2 * a[2] + b[2]
        if a[:2] == (2, 0) and b[:2] == (0, 2):
            return 37 + 2 * a[2] + b[2]
        if a[:2] == (1, 1) and b[:2] == (1, 1):
            return 41 + a[2] + b[2]
    if n == 1 and state[0][:2] == (2, 2):
        return ABSORBING
    raise ValueError(f"unindexable state {state}")


def _enumerate_two_pop():
    """Enumerate the 44 two-population states in index order."""
    # partitions of descendants: each lineage takes (d0, d1) != (0, 0);
    # multisets of signatures summing to (2, 2).
    sig_partitions = set()
    sigs = [(d0, d1) for d0 in range(3) for d1 in range(3) if (d0, d1) != (0, 0)]

    def rec(remaining0, remaining1, chosen, start):
        if remaining0 == 0 and remaining1 == 0:
            if len(chosen) >= 2:  # drop the absorbing single-lineage state
                sig_partitions.add(tuple(sorted(chosen)))
            return
        for k in range(start, len(sigs)):
            d0, d1 = sigs[k]
            if d0 <= remaining0 and d1 <= remaining1:
                rec(remaining0 - d0, remaining1 - d1, chosen + [(d0, d1)], k)

    rec(2, 2, [], 0)

    states = {}
    for part in sig_partitions:
        for pops in itertools.product((0, 1), repeat=len(part)):
            st = _canon2([(*sig, p) for sig, p in zip(part, pops)])
            states[st] = _index2(st)
    assert len(set(states.values())) == len(states) == 44, sorted(states.values())
    ordered = [None] * 44
    for st, ind in states.items():
        ordered[ind] = st
    return ordered


def _canon1(state):
    return tuple(sorted(state, key=lambda l: (-(l[0] + l[1]), -l[0], -l[1])))


_ONE_POP_STATES = [
    ((1, 0), (1, 0), (0, 1), (0, 1)),
    ((2, 0), (0, 1), (0, 1)),
    ((1, 1), (1, 0), (0, 1)),
    ((0, 2), (1, 0), (1, 0)),
    ((2, 1), (0, 1)),
    ((1, 2), (1, 0)),
    ((2, 0), (0, 2)),
    ((1, 1), (1, 1)),
]


def _index1(state):
    st = _canon1(state)
    if len(st) == 1 and st[0] == (2, 2):
        return ABSORBING
    return {_canon1(s): i for i, s in enumerate(_ONE_POP_STATES)}[st]


# ---------------------------------------------------------------------------
# Basis tensor construction
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TwoPopBasis:
    """Constant tensors for the 44-state two-population CTMC.

    The generator uses the reference's column convention (M[to, from]);
    columns leak probability through the dropped absorbing state, so
    ``exp(M t)`` maps not-yet-fully-coalesced probability mass.
    """

    n: int  # 44
    coal: np.ndarray  # (2, 44, 44): coefficient of lambda_pop
    migr: np.ndarray  # (2, 44, 44): coefficient of mu_pop
    jsfs: np.ndarray  # (44, 7): per-state JSFS category multiplicities
    collapse: np.ndarray  # (8, 44): two-pop -> one-pop projection at split
    ancient: np.ndarray  # (44, 44): ancient-sample re-basing operator
    pulse_coeff: np.ndarray  # (2, 5, 44, 44): [pop][a][dst][src] counts
    pulse_k: np.ndarray  # (2, 44): lineages in `pop` per state
    stationary_mask: np.ndarray  # (44,) bool: cross-pop 2-lineage states


@dataclasses.dataclass(frozen=True)
class OnePopBasis:
    n: int  # 8
    coal: np.ndarray  # (8, 8): coefficient of lambda
    jsfs: np.ndarray  # (8, 7)


def _build_two_pop() -> TwoPopBasis:
    states = _enumerate_two_pop()
    n = 44
    coal = np.zeros((2, n, n))
    migr = np.zeros((2, n, n))
    jsfs = np.zeros((n, 7))
    stationary = np.zeros(n, dtype=bool)

    for src, st in enumerate(states):
        for cat in (_JAF_CATEGORY[l[:2]] for l in st):
            jsfs[src, cat] += 1.0
        if len(st) == 2 and st[0][2] != st[1][2]:
            stationary[src] = True
        lineages = list(st)
        for i, li in enumerate(lineages):
            # migration: lineage i flips population at rate mu[pop_i]
            moved = lineages[:i] + [(li[0], li[1], 1 - li[2])] + lineages[i + 1 :]
            dst = _index2(_canon2(moved))
            migr[li[2], dst, src] += 1.0
            migr[li[2], src, src] -= 1.0
            # coalescence of pairs in the same population at rate lambda[pop]
            for j in range(i + 1, len(lineages)):
                lj = lineages[j]
                if lj[2] != li[2]:
                    continue
                merged = [l for k, l in enumerate(lineages) if k not in (i, j)]
                merged.append((li[0] + lj[0], li[1] + lj[1], li[2]))
                dst = _index2(_canon2(merged))
                if dst != ABSORBING:
                    coal[li[2], dst, src] += 1.0
                coal[li[2], src, src] -= 1.0  # leak even into the absorbing state

    # collapse at the split: forget population labels (reference
    # MigrationInference.py:518-528 index ranges)
    collapse = np.zeros((8, n))
    for src, st in enumerate(states):
        dst = _index1([l[:2] for l in st])
        collapse[dst, src] = 1.0
    ranges = [(0, 9), (9, 15), (15, 23), (23, 29), (29, 33), (33, 37), (37, 41), (41, 44)]
    for r, (a, b) in enumerate(ranges):
        expect = np.zeros(n)
        expect[a:b] = 1.0
        assert np.array_equal(collapse[r], expect), (r, collapse[r])

    # ancient-sample re-basing (reference TwoPopulations.py:246-262): at the
    # sampling date of the (older) genome 2, genome-1 ancestry collapses onto
    # the states where genome 2's two fresh lineages sit in population 1.
    ancient = np.zeros((n, n))
    for src, st in enumerate(states):
        if sum(1 for l in st if l[:2] == (1, 0) and l[2] == 0) == 2:
            ancient[2, src] += 1.0
        if sum(1 for l in st if l[:2] == (2, 0) and l[2] == 0) == 1:
            ancient[11, src] += 1.0

    # pulse migration operator (reference TwoPopulations.py:361-377): every
    # lineage currently in the source population migrates independently with
    # probability r.  P(r)[dst, src] = sum_a pulse_coeff[a,dst,src] *
    # r^a * (1-r)^(k_src - a), with k_src = #lineages of src in the pulse pop.
    pulse_coeff = np.zeros((2, 5, n, n))
    pulse_k = np.zeros((2, n), dtype=np.int64)
    for pop in (0, 1):
        for src, st in enumerate(states):
            in_pop = [i for i, l in enumerate(st) if l[2] == pop]
            pulse_k[pop, src] = len(in_pop)
            for r in range(len(in_pop) + 1):
                for subset in itertools.combinations(in_pop, r):
                    moved = [
                        (l[0], l[1], 1 - l[2]) if i in subset else l
                        for i, l in enumerate(st)
                    ]
                    dst = _index2(_canon2(moved))
                    pulse_coeff[pop, r, dst, src] += 1.0

    return TwoPopBasis(
        n=n,
        coal=coal,
        migr=migr,
        jsfs=jsfs,
        collapse=collapse,
        ancient=ancient,
        pulse_coeff=pulse_coeff,
        pulse_k=pulse_k,
        stationary_mask=stationary,
    )


def _build_one_pop() -> OnePopBasis:
    n = 8
    coal = np.zeros((n, n))
    jsfs = np.zeros((n, 7))
    for src, st in enumerate(_ONE_POP_STATES):
        for cat in (_JAF_CATEGORY[l] for l in st):
            jsfs[src, cat] += 1.0
        lineages = list(st)
        for i, li in enumerate(lineages):
            for j in range(i + 1, len(lineages)):
                lj = lineages[j]
                merged = [l for k, l in enumerate(lineages) if k not in (i, j)]
                merged.append((li[0] + lj[0], li[1] + lj[1]))
                dst = _index1(merged)
                if dst != ABSORBING:
                    coal[dst, src] += 1.0
                coal[src, src] -= 1.0
    return OnePopBasis(n=n, coal=coal, jsfs=jsfs)


@lru_cache(maxsize=None)
def two_pop_basis() -> TwoPopBasis:
    return _build_two_pop()


@lru_cache(maxsize=None)
def one_pop_basis() -> OnePopBasis:
    return _build_one_pop()


# ---------------------------------------------------------------------------
# Rate-matrix assembly (torch, batch-first)
# ---------------------------------------------------------------------------


def _basis_tensor(arr, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(arr, dtype=like.dtype, device=like.device)


def one_pop_matrix(l, basis: OnePopBasis | None = None):
    """M1 = l*C for rates (B,) -> (B, 8, 8)."""
    b = basis or one_pop_basis()
    l = torch.as_tensor(l)
    return l[..., None, None] * _basis_tensor(b.coal, l)


def pulse_operator(rate, pop: int, basis: TwoPopBasis | None = None):
    """Dense pulse-migration operators P(rate) for source population ``pop``
    and rates (B,) -> (B, 44, 44).  P(0) == identity."""
    b = basis or two_pop_basis()
    rate = torch.as_tensor(rate)
    coeff = _basis_tensor(b.pulse_coeff[pop], rate)  # (5, 44, 44)
    k = torch.as_tensor(b.pulse_k[pop], device=rate.device)  # (44,)
    a = torch.arange(5, device=rate.device)
    # w[..., a, src] = rate^a * (1-rate)^(k_src - a), zero where a > k_src
    pow_r = rate[..., None] ** a.to(rate.dtype)  # (..., 5)
    rem = k[None, :] - a[:, None]  # (5, 44)
    pow_q = torch.where(
        rem >= 0,
        (1.0 - rate)[..., None, None] ** rem.clamp(min=0).to(rate.dtype),
        torch.zeros((), dtype=rate.dtype, device=rate.device),
    )  # (..., 5, 44)
    w = pow_r[..., None] * pow_q
    return torch.einsum("ads,...as->...ds", coeff, w)
