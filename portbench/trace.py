"""Reading a torch.profiler trace of a short steady stretch: the device's busy
time as the union of its own events' intervals, the longest idle gaps with
the host operation that was running in each, and the time of each kernel.

What the readers under `portbench/metrics/` take is the `Profiled` record
this module builds, plus what the traffic driver adds to the trace dict.
"""
from __future__ import annotations

import bisect
import dataclasses
import re
import time
from collections import defaultdict

__all__ = ["Profiled", "profile", "idle_share"]

_NAME = 100  # characters of a name kept in a breakdown


@dataclasses.dataclass
class Profiled:
    window_s: float  # host clock over the stretch, synchronised at both ends
    busy_s: float  # union of the device events' intervals
    units: int  # solves or cadences in the stretch
    kernels: dict  # device event name -> [calls, seconds]
    idle_by_host: dict  # host operation -> seconds the device idled under it

    def kernel_time(self, pattern: str) -> tuple[int, float]:
        """(calls, seconds) summed over the kernels whose names match."""
        calls, secs = 0, 0.0
        for name, (n, s) in self.kernels.items():
            if re.search(pattern, name):
                calls, secs = calls + n, secs + s
        return calls, secs

    def breakdown(self) -> dict:
        top = lambda d: [[k[:_NAME], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top({k: v[1] for k, v in self.kernels.items()}),
                "idle_gaps": top(self.idle_by_host)}


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(cpu, starts, p):
    """Name of the latest-starting host event that contains time p."""
    i = bisect.bisect_right(starts, p) - 1
    for j in range(i, max(i - 4000, -1), -1):
        a, b, name = cpu[j]
        if b >= p:
            return name
    return "host code outside torch operations"


def profile(step, units: int, sync) -> Profiled:
    """Run `step()` (which ends synchronised) under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    sync()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        sync()
        window_s = time.perf_counter() - t0
    dev, cpu = [], []
    kernels = defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CPU:
            cpu.append((a, b, e.name))
        elif b > a and not getattr(e, "is_user_annotation", False):
            dev.append((a, b))
            k = kernels[e.name]
            k[0] += 1
            k[1] += (b - a) / 1e6
    merged = _merge(dev)
    busy_s = sum(b - a for a, b in merged) / 1e6
    cpu.sort()
    starts = [c[0] for c in cpu]
    idle = defaultdict(float)
    if cpu and merged:
        lo, hi = cpu[0][0], max(c[1] for c in cpu)
        edges = [lo] + [x for iv in merged for x in iv] + [hi]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                idle[_innermost(cpu, starts, (a + b) / 2)] += (b - a) / 1e6
    return Profiled(window_s, busy_s, units, dict(kernels), dict(idle))


def idle_share(trace: dict):
    """Per cent of the traced stretch in which no device event ran."""
    p = trace.get("profiled")
    if p is None or p.busy_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
