"""The share of the profiled rollout's seconds (host clock) in which the
device idles inside the program's span ``draws``: each idle gap goes to
the innermost program span over its middle.

A traced share: the profiler's cost for each eager operation stretches
the slice (a traced rollout lasts about 2.4 times an untraced one), and
that stretch is device idle, much of it inside this span: this reads
far above the untraced program's idle and compares only with other
traced runs.
The untraced counterpart is ``host_lead_ms.walk``."""

from nbp_bench.metrics import program_spans

LAYER = "device"
UNIT = "%"
MOVES = "poses_per_s"
CELLS = ("walk_simple_b4",)


def read(layer):
    return program_spans.idle_in(layer, "draws")
