"""How far the host runs ahead of the device in a training micro step,
in ms: the program's span ``chunk``, whose copies of the micro batch's
indices and weights from pageable memory wait for the stream's queued
work (the last micro step's) to finish, over the pass's micro steps.
More lead, less device idle; near 0, the host holds the device back. No
profiler's cost per operation is in it, unlike
``idle_in_backward.train``. The median over the cell's passes before any
profiler (``program_spans.median``): in a ``--trace 1`` run that is one
pass, the window's first, which may fall in the slow phase of a
process's start."""

from nbp_bench.metrics import program_spans

LAYER = "device"
UNIT = "ms"
MOVES = "train_samples_per_s"
CELLS = ("train_b56",)


def read(layer):
    return program_spans.median(
        layer, lambda r: 1e3 * r.host_s("chunk") / r.units["micro_steps"],
        "chunk")
