"""The share of the profiled pass's seconds (host clock) in which the
device idles inside the program's span ``backward``: each idle gap goes
to the innermost program span over its middle, the autograd thread's
operations left out.

A traced share: the profiler's cost for each eager operation stretches
the slice (a traced pass lasts about 2.4 times an untraced one), and
that stretch is device idle, much of it inside this span: this reads
far above the untraced program's idle and compares only with other
traced runs.
The untraced counterpart is ``host_lead_ms.train``."""

from nbp_bench.metrics import program_spans

LAYER = "device"
UNIT = "%"
MOVES = "train_samples_per_s"
CELLS = ("train_b56",)


def read(layer):
    return program_spans.idle_in(layer, "backward")
