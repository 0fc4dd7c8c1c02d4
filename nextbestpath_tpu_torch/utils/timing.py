"""Wall-clock phase timers and the profiler hook.

Port of ``nextbestpath_tpu/utils/timing.py``: the reference's print-based
``TimeCheck`` (macarons/utility/utils.py:86-111), accumulating named phase
timers, and ``profiler_trace``, a ``torch.profiler`` trace written for
TensorBoard. ``PhaseTimers.phase(name, block=True)`` waits for the device's
queued work before it stops the clock, so the phase's device time counts.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


class TimeCheck:
    """Reference-compatible simple timer."""

    def __init__(self):
        self.t0: Optional[float] = None

    def start(self):
        self.t0 = time.time()

    def current_time(self) -> float:
        return time.time() - (self.t0 or time.time())


class PhaseTimers:
    """Accumulating named phase timers (loop_time/backward_time analog)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block: bool = False):
        t0 = time.time()
        yield
        if block and torch.cuda.is_available():
            torch.cuda.synchronize()
        self.totals[name] += time.time() - t0
        self.counts[name] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": self.totals[k],
                    "mean_s": self.totals[k] / max(self.counts[k], 1)}
                for k in self.totals}


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """A ``torch.profiler`` trace of the block (CPU, and CUDA where a card
    is present) into ``log_dir``; a no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
