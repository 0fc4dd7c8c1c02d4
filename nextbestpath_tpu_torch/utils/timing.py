"""The port's spans, counters and per-run records.

``span(name)`` times a block of host code and ``count(name, n)`` adds to
a counter; both go to the current run record, opened by ``run(kind,
**units)`` around one call of a measured path (``ScanRandomWalk.run``,
``train_epoch_ds``). A record holds, by name, each span's count, host
seconds and self seconds (its seconds less those of the spans it
encloses), each counter, the run's units (batch poses and scenes, or
micro steps, AdamW steps and rows) and whether a profiler recorded at
any time during it. The last ``MAX_RECORDS`` records are kept in memory,
oldest first, in ``records()``. Outside a run, spans and counters record
nothing.

A span costs two host clock reads and a dict update: no device sync, no
host read of a device value, no CUDA event. Only while a
``torch.profiler`` records does it also open a profiler range of the same
name (``record_function``), which puts it in the CUPTI trace beside the
device's activities on the profiler's clock; otherwise no profiler op is
dispatched. Spans nest on the thread that opens them: the program opens
them on one thread.
"""

from __future__ import annotations

import collections
from time import perf_counter
from typing import Deque, Dict, List, Optional

import torch.autograd.profiler as _profiler

MAX_RECORDS = 1024


class Record:
    """One run of a measured path: ``spans`` name -> [count, host s,
    self s], ``counts`` name -> int."""

    __slots__ = ("kind", "units", "spans", "counts", "profiled")

    def __init__(self, kind: str, units: Dict[str, int]):
        self.kind = kind
        self.units = dict(units)
        self.spans: Dict[str, List] = {}
        self.counts: Dict[str, int] = {}
        self.profiled = _profiler._is_profiler_enabled

    def host_s(self, name: str) -> float:
        return self.spans[name][1] if name in self.spans else 0.0

    def self_s(self, name: str) -> float:
        return self.spans[name][2] if name in self.spans else 0.0

    def n(self, name: str) -> int:
        return self.spans[name][0] if name in self.spans else 0


_records: Deque[Record] = collections.deque(maxlen=MAX_RECORDS)
_record: Optional[Record] = None
_open: Optional["span"] = None


class span:
    """``with span(name):`` times the block into the current record."""

    __slots__ = ("name", "t0", "child", "parent", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        global _open
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = _profiler.record_function(self.name)
            self.range.__enter__()
            if _record is not None:
                _record.profiled = True
        self.child = 0.0
        self.parent = _open
        _open = self
        self.t0 = perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        global _open
        d = perf_counter() - self.t0
        _open = self.parent
        if self.parent is not None:
            self.parent.child += d
        if _record is not None:
            e = _record.spans.get(self.name)
            if e is None:
                _record.spans[self.name] = [1, d, d - self.child]
            else:
                e[0] += 1
                e[1] += d
                e[2] += d - self.child
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def count(name: str, n: int = 1) -> None:
    """Add n to the current record's counter ``name``."""
    if _record is not None:
        _record.counts[name] = _record.counts.get(name, 0) + n


class run:
    """``with run(kind, **units) as rec:`` opens a record for one run of a
    measured path; it joins ``records()`` when the block ends. The units
    may be set on ``rec.units`` inside the block."""

    __slots__ = ("record", "outer")

    def __init__(self, kind: str, **units: int):
        self.record = Record(kind, units)

    def __enter__(self) -> Record:
        global _record
        self.outer, _record = _record, self.record
        return self.record

    def __exit__(self, *exc) -> bool:
        global _record
        _record = self.outer
        if _profiler._is_profiler_enabled:
            self.record.profiled = True
        _records.append(self.record)
        return False


def records() -> List[Record]:
    """The kept run records, oldest first."""
    return list(_records)
