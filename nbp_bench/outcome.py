"""What a driver hands back to ``run.py``."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    # End-to-end metrics by name (setup_s among them).
    e2e: Dict[str, float]
    # What the per-layer readers read (counts, the window, the trace).
    layer: Dict[str, Any]
    # The numbers compared: name -> (value, limit); a run is correct when
    # every value is within its limit.
    checks: Dict[str, Tuple[float, float]]
    memory_peak_bytes: int
    busy_s: Optional[float] = None
    traced_s: Optional[float] = None
    breakdown: Optional[Dict[str, Any]] = None
    # With --control 1: the control's reading of each number.
    control: Optional[Dict[str, float]] = None
