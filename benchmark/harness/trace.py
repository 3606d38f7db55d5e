"""The device trace, reduced: busy time as the union of device intervals,
the idle gaps by what the host was doing, and device time by kernel.

Input is the Chrome trace ``torch.profiler`` exports: complete events
(``"ph": "X"``) with ``ts`` and ``dur`` in microseconds. Device operations
are the categories ``kernel``, ``gpu_memcpy`` and ``gpu_memset``; host
operations are the CUDA runtime and driver calls and the CPU ops.

Busy time is the length of the union of the device intervals, so
operations that overlap (two streams, a copy beside a kernel) count once;
a sum of durations would count them twice.
"""

from __future__ import annotations

import dataclasses
import heapq
import json
from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
NO_HOST_OP = "no host operation"

Interval = Tuple[float, float]   # (start, end) in microseconds


@dataclasses.dataclass
class Op:
    name: str
    start: float   # us
    end: float     # us


@dataclasses.dataclass
class Trace:
    device: List[Op]
    runtime: List[Op]
    cpu: List[Op]

    # -- device ------------------------------------------------------------
    def busy_s(self) -> float:
        return union_length([(o.start, o.end) for o in self.device]) * 1e-6

    def span(self) -> Interval:
        """First and last instant of any event: the traced window in the
        trace's own clock."""
        ops = self.device + self.runtime + self.cpu
        if not ops:
            return (0.0, 0.0)
        return (min(o.start for o in ops), max(o.end for o in ops))

    def kernel_s(self, pattern: str) -> float:
        """Device seconds of the operations whose name holds ``pattern``."""
        return sum(o.end - o.start for o in self.device
                   if pattern in o.name) * 1e-6

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = defaultdict(float)
        for o in self.device:
            by[o.name] += (o.end - o.start) * 1e-6
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]

    # -- idle --------------------------------------------------------------
    def idle_gaps(self, n: int = 10) -> List[List]:
        """Seconds of device idleness inside the traced window, by the host
        operation under way: a CUDA runtime or driver call where one
        overlaps the gap, else the innermost CPU op covering it, else
        ``no host operation``."""
        if not self.device:
            return []
        lo, hi = self.span()
        gaps = complement([(o.start, o.end) for o in self.device], lo, hi)
        by: Dict[str, float] = defaultdict(float)
        mids = [(0.5 * (g0 + g1),) * 2 for g0, g1 in gaps]
        inner = [min(((e - s, name) for s, e, name in hits), default=None)
                 for hits in sweep(self.cpu, mids)]
        for (g0, g1), hits, cpu_op in zip(gaps, sweep(self.runtime, gaps),
                                           inner):
            covered = 0.0
            for s, e, name in hits:
                ov = min(e, g1) - max(s, g0)
                if ov > 0:
                    by[name] += ov * 1e-6
                    covered += ov
            rest = (g1 - g0) - covered
            if rest > 0:
                by[cpu_op[1] if cpu_op else NO_HOST_OP] += rest * 1e-6
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]


def sweep(ops: Sequence[Op], queries: Sequence[Interval]
          ) -> List[List[Tuple[float, float, str]]]:
    """For each of ``queries`` (sorted, not overlapping), the ops that
    overlap it (touching counts), in one pass over both."""
    events = sorted((o.start, o.end, o.name) for o in ops)
    active: List[Tuple[float, float, float, str]] = []   # heap by end
    out, i = [], 0
    for q0, q1 in queries:
        while i < len(events) and events[i][0] <= q1:
            s, e, name = events[i]
            heapq.heappush(active, (e, s, e, name))
            i += 1
        while active and active[0][0] < q0:
            heapq.heappop(active)
        out.append([(s, e, name) for _, s, e, name in active])
    return out


def union(intervals: Iterable[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def union_length(intervals: Iterable[Interval]) -> float:
    return sum(e - s for s, e in union(intervals))


def complement(intervals: Iterable[Interval], lo: float,
               hi: float) -> List[Interval]:
    """The parts of [lo, hi] that no interval covers."""
    gaps, t = [], lo
    for s, e in union(intervals):
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
    if t < hi:
        gaps.append((t, hi))
    return [(s, e) for s, e in gaps if e > s]


def from_events(events: Iterable[dict]) -> Trace:
    dev, rt, cpu = [], [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "")
        op = Op(str(ev.get("name", "")), float(ev["ts"]),
                float(ev["ts"]) + float(ev["dur"]))
        if cat in DEVICE_CATS:
            dev.append(op)
        elif cat in RUNTIME_CATS:
            rt.append(op)
        elif cat == "cpu_op":
            cpu.append(op)
    return Trace(dev, rt, cpu)


def load(path: str) -> Trace:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return from_events(events)
