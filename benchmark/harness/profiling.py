"""Device timing on the card: the profiler's trace of one request, and
kernel times by name with a spin-kernel fallback.

The kernel timing follows the repository's ``chip_smoke.py``
(`profiled_ms`, `events_ms`, `host_us`): on the H100 hosts the port has
run on, torch.profiler missed from 1 in 10 to 8 in 10 kernels, so a time
taken by kernel name is used only where the profiler saw every launch it
should have, and otherwise CUDA events time the calls queued behind a spin
kernel, which makes the device run them back to back.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

# the runtime and driver calls that start work on the device
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
            "cudaLaunchCooperativeKernel", "cudaGraphLaunch")


def _ns(e, what):
    f = getattr(e, f"{what}_ns", None)
    return f() if f is not None else getattr(e, f"{what}_us")() * 1000


class Trace:
    """The profiler's record of one stretch of work on one card.

    ``device`` holds (start ns, end ns, name) of every operation that ran on
    the card (kernels, copies, fills), ``host`` (start ns, end ns, name) of
    the host's operations and runtime calls, ``launches`` the runtime calls
    that launched a kernel, ``kernels`` the kernels the profiler saw, and
    ``wall_s`` the stretch's length on the host clock, from before the work
    was queued to after the card finished it."""

    def __init__(self, events, wall_s: float):
        from torch.autograd import DeviceType

        self.device, self.host = [], []
        self.launches = self.kernels = 0
        for e in events:
            start = _ns(e, "start")
            span = (start, start + _ns(e, "duration"), e.name())
            if e.device_type() == DeviceType.CUDA:
                self.device.append(span)
                if not e.name().startswith(("Memcpy", "Memset")):
                    self.kernels += 1
            else:
                self.host.append(span)
                if e.name() in LAUNCHES:
                    self.launches += 1
        self.device.sort()
        self.host.sort()
        self.wall_s = wall_s

    @property
    def complete(self) -> bool:
        """Whether the profiler saw a kernel for every launch."""
        return self.launches > 0 and self.kernels >= self.launches

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the card (the union of
        their intervals)."""
        busy, end = 0, None
        for s, e, _ in self.device:
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy / 1e9

    def device_ops(self, top: int = 10) -> list:
        """The device operations that took the most time: [[name, s], ...]."""
        tot = defaultdict(int)
        for s, e, name in self.device:
            tot[name] += e - s
        return [[k, v / 1e9] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """The card's idle time between the stretch's first host operation
        and its last device operation, by the innermost host operation
        running in the middle of each gap: [[name, s], ...]."""
        if not self.device or not self.host:
            return []
        starts = [h[0] for h in self.host]
        tot = defaultdict(int)
        t, stop = self.host[0][0], self.device[-1][1]
        for s, e, _ in self.device + [(stop, stop, "")]:
            if s > t:
                mid = (s + t) // 2
                name = "(Python between operations)"
                i = bisect.bisect_right(starts, mid) - 1
                for j in range(i, max(i - 64, -1), -1):  # the innermost: the latest start
                    if self.host[j][1] >= mid:
                        name = self.host[j][2]
                        break
                tot[name] += s - t
            t = max(t, e)
        return [[k, v / 1e9] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def profile(fn):
    """(fn's result, its `Trace`)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, Trace(prof.profiler.kineto_results.events(), wall)


def host_us(fn, reps: int) -> float:
    """Host time per call of ``fn`` with no synchronise: the median of 5
    rounds of ``reps`` enqueues, after one warm-up."""
    import statistics

    import torch

    fn()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(5):
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        rounds.append((time.perf_counter() - t) / reps * 1e6)
        torch.cuda.synchronize()
    return statistics.median(rounds)


def events_ms(fn, reps: int, enqueue_us: float) -> float:
    """Device ms per call of ``fn``: CUDA events around ``reps`` calls queued
    behind a spin kernel, so that the card runs them back to back."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e6 + 4e3 * enqueue_us * reps))  # ~1 ms plus twice the enqueue time
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, reps: int, launches: int) -> tuple:
    """(device ms per call of ``fn``, which launches exactly ``launches``
    kernels, how it was measured).  By the profiler's kernel records where
    it saw all ``launches * reps`` of them, else by `events_ms`."""
    fn()
    _, trace = profile(lambda: [fn() for _ in range(reps)])
    ops = [(s, e) for s, e, name in trace.device if not name.startswith(("Memcpy", "Memset"))]
    if len(ops) == launches * reps:
        return sum(e - s for s, e in ops) / 1e6 / reps, "profiler"
    return events_ms(fn, reps, host_us(fn, reps)), (
        f"events (the profiler saw {len(ops)} of {launches * reps} kernels)")


def idle_pct(trace: Trace, wall_s: float):
    """The share of ``wall_s`` in which the card ran nothing, %: 1 - the busy
    time of ``trace`` over ``wall_s``, where ``trace`` is the profiled run of
    a request and ``wall_s`` the same request's wall unprofiled (the
    profiler slows the host, not the card).  None, not measured, where the
    profiler saw fewer kernels than the host launched."""
    if not trace.complete:
        return None
    return {"value": 100 * (1 - trace.busy_s() / wall_s), "source": "profiler",
            "wall_s": wall_s, "profiled_wall_s": trace.wall_s}


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
