"""How far the host runs ahead of the device at a walk rollout's end, in
ms: the program's span ``results``, whose read-back of the coverage
curves waits for the poses still queued on the device, a few ms of
copies besides. More lead, less device idle; near 0, the host holds the
device back. No profiler's cost per operation is in it, unlike
``idle_in_draws.walk``. The median over the cell's rollouts before any
profiler (``program_spans.median``): in a ``--trace 1`` run that is one
rollout, the window's first, which may fall in the slow phase of a
process's start."""

from nbp_bench.metrics import program_spans

LAYER = "device"
UNIT = "ms"
MOVES = "poses_per_s"
CELLS = ("walk_simple_b4",)


def read(layer):
    return program_spans.median(
        layer, lambda r: 1e3 * r.host_s("results"), "results")
