"""What a profiled slice of a run's window says: the device's activity
intervals by name, busy time, and the longest idle gaps by what the host
was doing.

The interval arithmetic is ``profile_rollout.py``'s (the port's
profiler): busy time is the union of the device activities' intervals;
the device-side extents of the program's ranges (the profiler's user
annotations, such as those around a graph replay) are not activities."""

from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Optional, Sequence, Tuple

Span = Tuple[float, float]


def union_s(spans: Sequence[Span]) -> float:
    """Length of the union of the intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def merged(spans: Sequence[Span]) -> List[Span]:
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Slice:
    """The events of one profiled slice, in seconds on the profiler's
    clock: device activities (name, start, end) and host events (name,
    start, end). ``ranges`` names the program's ranges, whose device-side
    extents are left out of the activities."""

    def __init__(self, prof, ranges: Sequence[str]):
        import torch

        self.kernels: List[Tuple[float, float, str]] = []
        self.host: List[Tuple[float, float, str]] = []
        for e in prof.profiler.kineto_results.events():
            span = (e.start_ns() / 1e9, e.end_ns() / 1e9)
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if not (e.name() in ranges or e.is_user_annotation()):
                    self.kernels.append((span[0], span[1], e.name()))
            elif e.end_ns() > e.start_ns():
                self.host.append((span[0], span[1], e.name()))
        self.kernels.sort()
        self._starts = [k[0] for k in self.kernels]

    def busy_s(self) -> float:
        return union_s([(s, e) for s, e, _ in self.kernels])

    def device_s(self, name_part: str) -> Optional[float]:
        """Device seconds of the activities whose name holds name_part;
        None where there is none."""
        spans = [(s, e) for s, e, n in self.kernels if name_part in n]
        return union_s(spans) if spans else None

    def top_ops(self, n: int = 10) -> List[List]:
        """The n activities with the most device seconds, by name (cut to
        its first 160 characters)."""
        by: Dict[str, float] = collections.defaultdict(float)
        for s, e, name in self.kernels:
            by[name[:160]] += e - s
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The device's idle gaps between its first and last activity,
        summed by the innermost host event that spans each gap's middle
        (of nested events, the latest to start; "no host event" where
        none of the 256 latest to start before it does)."""
        busy = merged([(s, e) for s, e, _ in self.kernels])
        host = sorted(self.host)
        starts = [h[0] for h in host]
        by: Dict[str, float] = collections.defaultdict(float)
        for (_, e0), (s1, _) in zip(busy, busy[1:]):
            mid = 0.5 * (e0 + s1)
            i = bisect.bisect_right(starts, mid)
            name = "no host event"
            for h in reversed(host[max(0, i - 256):i]):
                if h[1] >= mid:
                    name = h[2]
                    break
            by[name] += s1 - e0
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]
