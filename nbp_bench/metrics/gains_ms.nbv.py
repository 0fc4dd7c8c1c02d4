"""The host's milliseconds a next-best-view pose in the program's span
``gains`` (the view harmonics of the proxy field, the frustum masks, the
token draw's argmax and SconeVis, as the host dispatches them), over the
record's poses; the median over the window's rollouts (their ``nbv`` run
records, none profiled: the traced rollout follows the window)."""

import statistics

LAYER = "rollout"
UNIT = "ms"
MOVES = "poses_per_s"
CELLS = ("nbv_simple",)


def read(layer):
    records = [r["record"] for r in layer.get("rollouts", [])
               if r.get("record") is not None]
    vals = [1e3 * r.host_s("gains") / r.units["poses"] for r in records
            if "gains" in r.spans and r.units.get("poses")]
    return statistics.median(vals) if vals else None
