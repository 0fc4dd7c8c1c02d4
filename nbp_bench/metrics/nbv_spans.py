"""What the next-best-view cell's device-trace readers share: the device
seconds of the kernels launched inside the program's spans of a profiled
rollout.

A kernel (a device activity of the CUPTI trace) belongs to the span in
which the host launched it: its correlation id is that of the runtime
call that launched it (``cudaLaunchKernel``, a memcpy or memset), and the
call's host start lies inside one of the span's profiler ranges. The
device seconds are the union of those kernels' intervals. A profile with
no such ranges or no linked launches gives None."""

from __future__ import annotations

import bisect
from typing import Iterable, List, Optional

from nbp_bench.trace import merged, union_s


def device_s_in_spans(layer, names: Iterable[str]) -> Optional[float]:
    events = layer.get("events")
    if not events:
        return None
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    names = set(names)
    spans, launched = [], {}
    for e in events:
        if e.device_type() == cuda:
            continue
        if e.name() in names and e.end_ns() > e.start_ns():
            spans.append((e.start_ns(), e.end_ns()))
        elif e.name().startswith("cu"):
            for c in (e.correlation_id(), e.linked_correlation_id()):
                if c:
                    launched[c] = e.start_ns()
    if not spans or not launched:
        return None
    ranges = merged(spans)
    starts = [s for s, _ in ranges]

    def inside(t: int) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= ranges[i][1]

    kernels: List = []
    for e in events:
        if e.device_type() != cuda or e.is_user_annotation() \
                or e.name() in names:
            continue
        t = launched.get(e.correlation_id(),
                         launched.get(e.linked_correlation_id()))
        if t is not None and inside(t):
            kernels.append((e.start_ns() / 1e9, e.end_ns() / 1e9))
    return union_s(kernels) if kernels else None
