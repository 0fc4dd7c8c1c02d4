"""The host's milliseconds a batch pose in the walk's step: the program's
span ``pose`` (on the card the captured graph's launch), over the
rollout's batch poses; the median over the cell's rollouts before any
profiler (``program_spans.median``): in a ``--trace 1`` run that is one
rollout, the window's first, which may fall in the slow phase of a
process's start."""

from nbp_bench.metrics import program_spans

LAYER = "rollout"
UNIT = "ms"
MOVES = "poses_per_s"
CELLS = ("walk_simple_b4",)


def read(layer):
    return program_spans.median(
        layer, lambda r: 1e3 * r.host_s("pose") / r.units["batch_poses"],
        "pose")
