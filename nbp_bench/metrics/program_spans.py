"""What the program's own run records (``nextbestpath_tpu_torch/utils/
timing.py``) say, for the readers of its spans and counters.

``median``: a quantity's median over the process's records of the cell's
kind and size from before its first profiled record. Once CUPTI has
recorded, it stays attached to the process, and every later run pays for
it on the host (on the H100 a graph launch of the walk 0.1-0.2 ms before,
0.9-1.4 ms after; a training pass 3.6-3.8 s before, 4.3-5.1 s after), so
in a ``--trace 1`` run only the window's first rollout or pass is read,
and it may fall in the slow phase of a process's start (``PERF.md``
§7); in a run without a profiler, all of them. ``idle_in``: the
device's idle seconds in the profiled slice, each idle gap charged to
the innermost of the program's spans (its profiler ranges, on any
thread) that covers the gap's middle; the profiler's cost for each
eager operation inflates them, so they compare only between traced
runs. A program without run records gives None."""

from __future__ import annotations

import statistics
from typing import Callable, Dict, List, Optional

from nbp_bench.trace import merged


def _records() -> List:
    try:
        from nextbestpath_tpu_torch.utils import timing
    except ImportError:
        return []
    records = getattr(timing, "records", None)
    return records() if records is not None else []


def _size(r) -> int:
    """A rollout record's scene-poses, a pass record's rows."""
    if r.kind == "rollout":
        return r.units["batch_poses"] * r.units["scenes"]
    return r.units["rows"]


def _of_cell(layer) -> List:
    """The records of the cell's kind and size from before the first
    profiled record."""
    if layer.get("rollouts"):
        kind, size = "rollout", layer["rollouts"][0]["poses"]
    elif layer.get("passes"):
        kind, size = "pass", layer["passes"][0]["samples"]
    else:
        return []
    out = []
    for r in _records():
        if r.profiled:
            break
        if r.kind == kind and _size(r) == size:
            out.append(r)
    return out


def median(layer, value: Callable, needs: str) -> Optional[float]:
    """The median of value(record) over the cell's records (``_of_cell``)
    that hold the span or counter ``needs``; None where none does."""
    values = [value(r) for r in _of_cell(layer)
              if needs in r.spans or needs in r.counts]
    return statistics.median(values) if values else None


def idle_by_span(layer) -> Optional[Dict[str, float]]:
    """Idle seconds of the profiled slice by the innermost program span
    over each gap's middle ("no span" where none is), between the first
    program span's start and the last one's end; None without a slice or
    without program spans in it."""
    sl = layer.get("slice")
    names = set()
    for r in _records():
        names.update(r.spans)
    if sl is None or not names:
        return None
    spans = sorted(((s, e, n) for s, e, n in sl.host if n in names),
                   key=lambda x: (x[0], -x[1]))
    if not spans:
        return None
    lo, hi = spans[0][0], max(e for _, e, _ in spans)
    gaps, t = [], lo
    for s, e in merged([(max(s, lo), min(e, hi)) for s, e, _ in sl.kernels
                        if e > lo and s < hi]):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    # A sweep over the gaps' middles: the stack holds the spans begun, the
    # latest on top; ended ones come off the top until the top covers the
    # middle, and it is then the latest begun of those that cover it.
    by: Dict[str, float] = {}
    stack: List = []
    i = 0
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        while i < len(spans) and spans[i][0] <= mid:
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "no span"
        by[name] = by.get(name, 0.0) + (g1 - g0)
    return by


def idle_in(layer, name: str) -> Optional[float]:
    """The share (%) of the profiled slice's seconds in which the device
    idles inside the span ``name``."""
    by = idle_by_span(layer)
    if by is None or not layer.get("slice_s"):
        return None
    return 100.0 * by.get(name, 0.0) / layer["slice_s"]
