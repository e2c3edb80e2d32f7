"""The likelihood's post-split fit: CUDA kernel wrapper.

``post_fit(nc, lh_post, T_post, cpfit=...)`` launches csrc/post_fit.cu:
every lane's post-split rates and final carry in one launch, in either
residual mode (the ECT Jacobi rounds of root solves, lane-major: a warp per
interval of consecutive lanes, a thread-block cluster per lane group, G
threads per solve; the cpfit closed form, a block per 32 lanes).  It is
built in float64 only, the likelihood's dtype (config.LLH_DTYPE).  Its
plain version is engine/likelihood.py `post_split_fit_plain`;
`post_split_fit` there takes this kernel for CUDA tensors and the plain
version for CPU ones.

* ``post_fit.launches`` counts kernel launches.
* `threads_per_solve` picks G from the batch's shape, `ect_layout` the
  blocks and clusters.
* `post_fit_ops` / `post_fit_bytes` meter the work a call needs on its
  inputs (`ect_work`: the solves whose prefix changed, each one's own
  expansion tests and halvings), for the kernel's bound.
* `warp_branch_mix` says how often a warp's solves take both forms of the
  residual, or mix T == 0 rows with live ones, under a thread mapping.
* `fit_single_pop_group` (with `expand_plain` and `tree_bisect_plain`) is
  the kernel's solve with G threads in torch ops, for the tests: the same
  bits as `fit_single_pop` at every G.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path

import torch

from .correction_fused import BUILD_DIR, compile_libs, stale

_CSRC = Path(__file__).resolve().parent / "csrc" / "post_fit.cu"
_LIB_PATH = BUILD_DIR / "post_fit_f64.so"
_LIBS: dict = {}
_LIB_LOCK = threading.Lock()
_F64 = torch.float64
MAX_ECT_INTERVALS = 256  # a lane's intervals fill at most one cluster
# intervals (warps) of an ECT block: at G = 1 two blocks of 18 an SM, else 32
MAX_WARPS = {1: 18, 2: 32, 4: 32, 8: 32, 16: 32, 32: 32}
MAX_CLUSTER = 8  # blocks of a cluster (the portable limit)
GROUPS = (1, 2, 4, 8, 16, 32)  # threads per solve (G), one kernel each
CPFIT_LANES, CPFIT_THREADS = 32, 128  # lanes and threads of a cpfit block
SMS = 132  # an H100 SXM's, where no card is at hand
RESIDENT_THREADS = SMS * 1024  # its resident threads of the G > 1 kernels, likewise
_ATTR_INTS = 4
_EXPAND_ITERS, _BISECT_ITERS = 40, 60  # kernels/correction.py's


def threads_per_solve(B: int, n: int, resident: int = RESIDENT_THREADS) -> int:
    """G, the threads of one ECT root solve: the largest power of two up to
    32 with B n G threads within ``resident``, the threads that the card
    keeps resident of the G > 1 kernels (`sms_and_resident`); 1 where B n
    alone fills them (the sweep's 4848 and the bench's 4096 lanes)."""
    g = 1
    while g < 32 and B * n * g * 2 <= resident:
        g *= 2
    return g


def ect_layout(n: int, group: int) -> dict:
    """The ECT kernel's layout for n intervals and G = ``group`` threads a
    solve: K intervals a warp (2 at G = 1 past 18 * MAX_CLUSTER intervals),
    clusters of C blocks of h intervals (``warps`` = ceil(h / K) warps each,
    at most MAX_WARPS[G]), S lanes a block."""
    if group not in GROUPS or not 0 < n <= MAX_ECT_INTERVALS:
        raise ValueError(f"the ECT kernel takes G in {GROUPS} threads a solve and 0 < n <= "
                         f"{MAX_ECT_INTERVALS} intervals, not G = {group}, n = {n}")
    K = 1 if n <= MAX_WARPS[group] * MAX_CLUSTER else 2
    C = -(-n // (MAX_WARPS[group] * K))
    h = -(-n // C)
    return dict(group=group, K=K, C=C, h=h, warps=-(-h // K), S=32 // (group * K))


def build_jobs(force: bool = False) -> list:
    """The nvcc job of this kernel's library (float64) for
    `correction_fused.compile_libs`; without ``force`` only if stale."""
    jobs = [(_LIB_PATH, _CSRC, torch.float64, False, ())]
    return jobs if force else stale(jobs)


@functools.lru_cache(maxsize=256)
def _ect_shape(B: int, n: int, group: int | None, resident: int) -> tuple:
    """(G, K, C, h) of an ECT launch."""
    lay = ect_layout(n, threads_per_solve(B, n, resident) if group is None else group)
    return lay["group"], lay["K"], lay["C"], lay["h"]


def _load():
    with _LIB_LOCK:
        if "fn" not in _LIBS:
            compile_libs(build_jobs())
            lib = ctypes.CDLL(str(_LIB_PATH))
            fn = lib.misti_post_fit
            P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            fn.argtypes = [P, L, L, P, L, L, L, P, L, L, P, I, I, I, I, I, I, I, I, P]
            fn.restype = I
            lib.misti_post_fit_attrs.argtypes = [P]
            lib.misti_post_fit_attrs.restype = I
            lib.misti_post_fit_occupancy.argtypes = [I, I, I, P]
            lib.misti_post_fit_occupancy.restype = I
            _LIBS["lib"] = lib
            _LIBS["fn"] = fn
        return _LIBS["fn"]


def _occupancy(G: int, threads: int, cluster: int) -> list:
    """registers, local bytes, resident blocks per SM and resident clusters
    of the ECT kernel of G threads a solve (G = 0: cpfit) at ``threads`` a
    block in clusters of ``cluster``, on the current device."""
    buf = (ctypes.c_int * _ATTR_INTS)()
    _load()
    err = _LIBS["lib"].misti_post_fit_occupancy(G, threads, cluster, ctypes.addressof(buf))
    if err != 0:
        raise RuntimeError(f"misti_post_fit_occupancy failed: CUDA error {err}")
    return list(buf)


@functools.lru_cache(maxsize=8)
def sms_and_resident(dev: int) -> tuple:
    """(SMs, resident threads of the G > 1 ECT kernels) of card ``dev``: the
    SM count times the fewest threads an SM keeps of any G > 1 kernel at
    its largest block (occupancy from the card's own query)."""
    with torch.cuda.device(dev):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        per_sm = min(_occupancy(g, 32 * MAX_WARPS[g], 1)[2] * 32 * MAX_WARPS[g]
                     for g in GROUPS[1:])
    return sms, sms * per_sm


def kernel_attrs() -> list:
    """Per kernel variant (ECT at each G, at its largest block of
    MAX_WARPS[G] warps in a cluster of 2; cpfit at its 128 threads):
    registers per thread, local (spill) bytes per thread, resident blocks
    per SM and resident clusters on the card.  Needs a card."""
    variants = [dict(kernel="ect", group=g, threads=32 * MAX_WARPS[g], cluster=2)
                for g in GROUPS]
    variants.append(dict(kernel="cpfit", group=None, threads=CPFIT_THREADS, cluster=None))
    buf = (ctypes.c_int * (_ATTR_INTS * len(variants)))()
    _load()
    err = _LIBS["lib"].misti_post_fit_attrs(ctypes.addressof(buf))
    if err != 0:
        raise RuntimeError(f"misti_post_fit_attrs failed: CUDA error {err}")
    keys = ("registers", "local_bytes", "blocks_per_sm", "clusters_resident")
    return [dict(v, **{k: buf[_ATTR_INTS * i + m] for m, k in enumerate(keys)})
            for i, v in enumerate(variants)]


def launch_shape(B: int, n: int, *, cpfit: bool) -> dict:
    """How `post_fit` launches B lanes of n intervals on the current card:
    G and the layout (ECT), blocks, threads a block, clusters, the resident
    blocks per SM and clusters and the waves of blocks (of clusters where
    C > 1) on the card's SMs."""
    sms, resident = sms_and_resident(torch.cuda.current_device())
    if cpfit or n == 0:
        rec = dict(kernel="cpfit", blocks=-(-B // CPFIT_LANES), threads=CPFIT_THREADS, C=1)
        G = 0
    else:
        G = _ect_shape(B, n, None, resident)[0]
        rec = dict(kernel="ect", **ect_layout(n, G))
        rec.update(blocks=-(-B // rec["S"]) * rec["C"], threads=32 * rec["warps"])
    regs, local, per_sm, clusters = _occupancy(G, rec["threads"], rec["C"])
    rec.update(registers=regs, local_bytes=local, blocks_per_sm=per_sm, sms=sms,
               resident_threads=resident)
    if rec["C"] > 1:
        rec["clusters_resident"] = clusters
        rec["waves"] = rec["blocks"] / rec["C"] / max(clusters, 1)
    else:
        rec["waves"] = rec["blocks"] / (sms * max(per_sm, 1))
    return rec


def post_fit(nc: torch.Tensor, lh_post: torch.Tensor, T_post: torch.Tensor, *, cpfit: bool,
             group: int | None = None):
    """(lc_post (B, n, 2), nc_fin (B, 2)) on the card; raises on anything the
    kernel does not take.

    ``nc`` (B, 2), ``lh_post`` (L, n, 2) and ``T_post`` (L, n) with L = 1
    (one table for every lane) or B, float64, any strides.  Both outputs
    are views of one (B, 2n + 2) buffer.  ``group`` forces the ECT solve's
    threads G (tests; by default `threads_per_solve`): every G gives the
    same bits."""
    dev = nc.get_device()
    for x in (nc, lh_post, T_post):
        if x.dtype is not _F64 or x.get_device() != dev:
            raise TypeError("post_fit takes float64 operands (the likelihood's dtype) on nc's "
                            f"device, not {x.dtype} on {x.device}")
    if not nc.is_cuda:
        raise ValueError(f"post_fit runs on a CUDA device, not {nc.device}")
    B, (L, n) = nc.shape[0], T_post.shape
    if (nc.dim() != 2 or nc.shape[1] != 2 or lh_post.shape != (L, n, 2) or L not in (1, B)
            or (not cpfit and n > MAX_ECT_INTERVALS)):
        raise ValueError(f"expected nc (B, 2), lh_post (L, n, 2), T_post (L, n) with L in "
                         f"(1, B) and n <= {MAX_ECT_INTERVALS} for ECT; got "
                         f"{tuple(nc.shape)}, {tuple(lh_post.shape)}, {tuple(T_post.shape)}")
    out = nc.new_empty((B, 2 * n + 2))
    if B:
        shared = L == 1
        fn = _LIBS.get("fn") or _load()  # no lock once loaded
        shape = (_ect_shape(B, n, group, sms_and_resident(dev)[1]) if not cpfit and n
                 else (1, 1, 1, 1))
        err = fn(nc.data_ptr(), nc.stride(0), nc.stride(1), lh_post.data_ptr(),
                 0 if shared else lh_post.stride(0), lh_post.stride(1), lh_post.stride(2),
                 T_post.data_ptr(), 0 if shared else T_post.stride(0), T_post.stride(1),
                 out.data_ptr(), B, n, int(cpfit), *shape, dev,
                 torch._C._cuda_getCurrentRawStream(dev))
        if err != 0:
            raise RuntimeError(f"post_fit kernel launch failed: CUDA error {err}")
        post_fit.launches += 1
    return out[:, :2 * n].unflatten(1, (n, 2)), out[:, 2 * n:]


post_fit.launches = 0

# FP64 operations of the work the function needs (see `post_fit_ops`)
EXP_OPS = 20  # exp, expm1, log1p: a range reduction and a polynomial
DEV_OPS = 11  # one residual evaluation at its cheaper form
PREFIX_OPS = 2  # a row's T lc and its add to the prefix
WEIGHT_OPS = 2 + 1 + 2 + 2 * EXP_OPS + 1 + 2  # the carries, max, exp(c - max), sum, w / sum
SETUP_OPS = 5 * DEV_OPS + 3 + 3 + 2 + 3 + 2  # te_dev, x0, lower, the 3 tests, hi
STEP_OPS = DEV_OPS + 3  # a residual evaluation, its test and the new bound
HALVING_OPS = STEP_OPS + 2  # and the midpoint
CPFIT_ROW_OPS = 1 + EXP_OPS + 2 * (1 + EXP_OPS) + 4 + EXP_OPS + 1 + 3  # ed, masses, dpnc, lam, nc


def ect_work(nc, lh_post, T_post) -> dict:
    """The work of the ECT rounds on these inputs (`post_fit`'s arguments),
    counted on the plain version's solves (`fit_single_pop`) with each
    round's prefix of T lc summed left to right, as the kernel sums it.
    Per round, (B, n) each: ``solved``, the rows with T != 0 whose prefix
    differs bitwise from the last round's (all of them in the first round;
    a prefix the last round had gives its weights and so its rate again);
    ``tests``, the expansion tests a solve makes (one more than the steps
    that move hi, at most 40); ``halvings``, those up to the first that
    leaves the bracket's bits as they were (60 without one).  And ``lc``
    (B, n, 2), the rates."""
    from ..engine.likelihood import _POST_OUTERS
    from .correction import fit_single_pop

    B, n = nc.shape[0], T_post.shape[1]
    T = T_post.expand(B, n)
    live = T != 0
    t_safe = torch.where(live, T, torch.ones_like(T))
    lh = lh_post.expand(B, n, 2)
    lc = lh.mean(-1)
    work, last = {"solved": [], "tests": [], "halvings": []}, None
    for _ in range(_POST_OUTERS):
        dec = T * lc
        pre = [torch.zeros_like(dec[:, 0])]
        for t in range(1, n):
            pre.append(dec[:, 0] if t == 1 else pre[-1] + dec[:, t - 1])
        pre = torch.stack(pre, 1)
        bits = pre.view(torch.int64)
        work["solved"].append(live if last is None else live & (bits != last))
        last = bits
        c = nc[:, None, :] - pre[..., None]
        w = torch.exp(c - c.max(-1, keepdim=True).values)
        moves, halvings = [], []
        lam = fit_single_pop(lh, t_safe, w, moves=moves, halvings=halvings)
        work["tests"].append(torch.clamp(moves[0] + 1, max=_EXPAND_ITERS))
        work["halvings"].append(halvings[0])
        lc = torch.where(live, lam, torch.ones_like(lam))
    work["lc"] = torch.stack([lc, lc], -1)
    return work


def post_fit_ops(nc, lh_post, T_post, *, cpfit: bool) -> float:
    """FP64 operations one call needs on these inputs (`post_fit`'s
    arguments), counting each of the function's steps on the rows with
    T != 0 (a T == 0 row needs none: its rate is 1 and the carry stays).

    cpfit: per row CPFIT_ROW_OPS (the ratio exp(nc1 - nc0), the two
    expm1 masses, the deviation, -log1p over T, the carry).  ECT
    (`ect_work`): per (lane, round, interval) PREFIX_OPS; per solve whose
    prefix changed WEIGHT_OPS (the two carries, their max, the two weights,
    their normalisation), SETUP_OPS (five residual evaluations: the
    target's two, the upper branch's limit, the lower branch's two ends;
    x0, the lower bound, the tests, the bracket), STEP_OPS for each
    expansion test it needs, HALVING_OPS for each halving up to the
    bracket's fixed point, and the midpoint; per lane the final carry
    (2 n + 2).

    Costs: an add, a product, a division and a comparison each 1; exp,
    expm1 and log1p EXP_OPS; a residual evaluation DEV_OPS, the cheaper of
    the function's two forms (x = lam T, then the Bernoulli series in
    Horner form: x^2, four multiply-adds and a product; the direct form
    1/x - 1/expm1(x) - 1/2 costs 1 + EXP_OPS + 4), so that the bound stays
    a floor."""
    B, n = nc.shape[0], T_post.shape[1]
    live = (T_post != 0).expand(B, n)
    if cpfit or n == 0:
        return float(live.sum()) * CPFIT_ROW_OPS
    work = ect_work(nc, lh_post, T_post)
    ops = float(live.sum()) * len(work["solved"]) * PREFIX_OPS + B * (2 * n + 2)
    for solved, tests, halvings in zip(work["solved"], work["tests"], work["halvings"]):
        ops += (float(solved.sum()) * (WEIGHT_OPS + SETUP_OPS + 2)
                + float(tests[solved].sum()) * STEP_OPS
                + float(halvings[solved].sum()) * HALVING_OPS)
    return ops


def post_fit_bytes(B: int, L: int, n: int, *, itemsize: int = 8) -> int:
    """Bytes a call must move: each input read once (nc, the L tables),
    each output written once (lc_post, nc_fin)."""
    return (2 * B + 3 * L * n + 2 * B * n + 2 * B) * itemsize


# --- thread mappings and the kernel's solve in torch ops (for tests and records)


def _warp_ids(B: int, n: int, layout: str, group: int = 1) -> torch.Tensor:
    """(B, n) index of the warp that solves each (lane, interval): "old" is
    the PR 9 kernel's (intervals fastest, 256 // n whole lanes a block of
    ceil(256 // n * n / 32) warps), "lane" the lane-major kernel's at G =
    ``group`` (`ect_layout`)."""
    lane = torch.arange(B)[:, None]
    t = torch.arange(n)[None, :]
    if layout == "old":
        lpb = 256 // n
        tid = (lane % lpb) * n + t
        return (lane // lpb) * -(-lpb * n // 32) + tid // 32
    if layout != "lane":
        raise ValueError(f"layout is 'old' or 'lane', not {layout!r}")
    lay = ect_layout(n, group)
    rank, tl = t // lay["h"], t % lay["h"]
    return ((lane // lay["S"]) * lay["C"] + rank) * lay["warps"] + tl // lay["K"]


def warp_branch_mix(nc, lh_post, T_post, layout: str = "lane", group: int = 1, *,
                    lc=None) -> dict:
    """How the ECT kernel's warps split on these inputs (`post_fit`'s
    arguments), from the plain version's roots: a live row (T != 0) solves
    in the series form of the residual when its root's x = lam T < 1/4, else
    in the direct form.  Of the warps that hold a live row, the share that
    hold both forms (``mixed_forms``) and the share that hold T == 0 rows
    beside live ones (``mixed_zero``), under the thread mapping ``layout``
    (`_warp_ids`); with the rows' counts.  ``lc``, the plain version's
    rates on these inputs, saves computing them."""
    from ..engine.likelihood import post_split_fit_plain

    B, n = nc.shape[0], T_post.shape[1]
    if lc is None:
        lc, _ = post_split_fit_plain(nc, lh_post, T_post, cpfit=False)
    lc, T = lc.cpu(), T_post.cpu().expand(B, n)
    live = T != 0
    series = live & (lc[..., 0] * T < 0.25)
    wid = _warp_ids(B, n, layout, group).expand(B, n).reshape(-1)
    nw = int(wid.max()) + 1 if wid.numel() else 0

    def held(mask):
        return torch.bincount(wid[mask.reshape(-1)], minlength=nw) > 0

    has_live = held(live)
    warps = int(has_live.sum())
    share = lambda m: float(m.sum()) / warps if warps else 0.0  # noqa: E731
    return {"layout": layout, "group": group if layout == "lane" else None, "warps": warps,
            "mixed_forms": share(held(series) & held(live & ~series)),
            "mixed_zero": share(held(~live) & has_live), "rows": B * n,
            "zero_rows": int((~live).sum()), "series_share": float(series.sum()) / max(
                int(live.sum()), 1)}


def expand_plain(g, hi, cap, group: int):
    """The kernel's bracket expansion with G = ``group`` threads, in torch
    ops: a round's thread j tests h_(i0 + j) = min(hi 2^j, cap), which is hi
    doubled j times with the cap (doubling is exact), and the expansion stops
    at the first step i < 40 with g(h_i) < 0 or h_(i+1) == h_i, else ends at
    h_40: the serial loop of `fit_single_pop`."""
    done = torch.zeros_like(hi, dtype=torch.bool)
    i0 = 0
    while not bool(done.all()):
        m = min(group, _EXPAND_ITERS - i0)  # the round's steps
        hs = [hi if j == 0 else torch.minimum(hi * 2.0 ** j, cap) for j in range(m)]
        hn = [torch.minimum(hi * 2.0 ** (j + 1), cap) for j in range(m)]
        new, stopped = hn[m - 1], torch.zeros_like(done)
        for j in reversed(range(m)):
            stop = ~(g(hs[j]) >= 0) | (hn[j] == hs[j])
            new = torch.where(stop, hs[j], new)
            stopped = stopped | stop
        hi = torch.where(done, hi, new)
        done = done | stopped | (i0 + group >= _EXPAND_ITERS)
        i0 += group
    return hi


def tree_bisect_plain(g, lo, hi, levels: int):
    """The kernel's 60 halvings with G = 2^``levels`` threads, in torch ops:
    60 / levels steps, each evaluating g at the midpoints of the bracket's
    next ``levels`` levels (node j of the tree in heap order, reached from
    (lo, hi) by the bits of j below its leading one with the serial loop's
    own midpoints) and walking down them by the signs.  ``levels`` = 0 is
    the serial loop.  As in the kernel, the steps stop once one leaves every
    bracket's bits as they were: a fixed point."""

    def fixed(lo0, hi0):
        return torch.equal(lo.view(torch.int64), lo0.view(torch.int64)) and torch.equal(
            hi.view(torch.int64), hi0.view(torch.int64))

    if levels == 0:
        for _ in range(_BISECT_ITERS):
            lo0, hi0 = lo, hi
            mid = 0.5 * (lo + hi)
            rise = g(mid) >= 0
            lo, hi = torch.where(rise, mid, lo), torch.where(rise, hi, mid)
            if fixed(lo0, hi0):
                break
        return lo, hi
    G = 1 << levels
    for _ in range(_BISECT_ITERS // levels):
        lo0, hi0 = lo, hi
        rises = []
        for j in range(1, G):
            a, b = lo, hi
            for d in reversed(range(j.bit_length() - 1)):
                m = 0.5 * (a + b)
                a, b = (m, b) if (j >> d) & 1 else (a, m)
            rises.append(g(0.5 * (a + b)) >= 0)
        rises = torch.stack(rises)
        node = torch.ones_like(lo, dtype=torch.long)
        for _ in range(levels):
            mid = 0.5 * (lo + hi)
            rise = rises.gather(0, (node - 1)[None])[0]
            lo, hi = torch.where(rise, mid, lo), torch.where(rise, hi, mid)
            node = 2 * node + rise.long()
        if fixed(lo0, hi0):
            break
    return lo, hi


def fit_single_pop_group(lh, T, weights, group: int = 1, *, moves=None):
    """`kernels/correction.py` `fit_single_pop` as the kernel runs it with
    G = ``group`` threads a solve (`expand_plain`, `tree_bisect_plain`, the
    fixed-point stop included): the same set-up in the same torch ops, so
    the same bits at every G.
    ``moves`` is taken and ignored (`post_split_fit_plain` passes it)."""
    from .correction import _ect_dev

    if group not in GROUPS:
        raise ValueError(f"threads per solve must be one of {GROUPS}, not {group}")
    w = weights / weights.sum(-1, keepdim=True)
    lh0, lh1 = lh[..., 0], lh[..., 1]
    w0, w1 = w[..., 0], w[..., 1]

    def dev_low(lam):
        return _ect_dev(lam * T)

    def dev_up(lam):
        return 1.0 / (lam * T) - 0.5

    def dev(lam):
        return torch.where(lam > 100.0, dev_up(lam), dev_low(lam))

    te_dev = w0 * dev(lh0) + w1 * dev(lh1)
    x0 = w0 * lh0 + w1 * lh1
    lower = 0.01 * torch.minimum(lh0, lh1)
    hundred = torch.full_like(x0, 100.0)
    lo_up = torch.maximum(lower, hundred)
    root_up = dev_up(lo_up) - te_dev >= 0
    root_low = ((lower < 100.0) & (dev_low(lower) - te_dev >= 0)
                & (dev_low(hundred) - te_dev < 0))
    up = root_up & ((x0 > 100.0) | ~root_low)

    def g(lam):
        return torch.where(up, dev_up(lam), dev_low(lam)) - te_dev

    lo = torch.where(up, lo_up, lower)
    hi = torch.maximum(x0, lower * 2.0)
    cap = torch.where(up, torch.full_like(x0, float("inf")), torch.maximum(hundred, lower))
    hi = torch.where(up, torch.maximum(hi, lo_up), torch.minimum(hi, cap))
    hi = expand_plain(g, hi, cap, group)
    lo, hi = tree_bisect_plain(g, lo, hi, group.bit_length() - 1)
    return 0.5 * (lo + hi)
