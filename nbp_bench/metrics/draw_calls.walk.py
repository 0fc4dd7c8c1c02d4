"""The provider calls a batch pose of the walk's draws: the program's
counter ``draw_calls`` over the rollout's batch poses (8 a scene: two
coverage draws, a direction, a rotation, four substeps' frames); the
median over the cell's rollouts before any profiler
(``program_spans.median``): in a ``--trace 1`` run that is one
rollout, the window's first, which may fall in the slow phase of a
process's start."""

from nbp_bench.metrics import program_spans

LAYER = "rollout"
UNIT = "calls/pose"
MOVES = "poses_per_s"
CELLS = ("walk_simple_b4",)


def read(layer):
    return program_spans.median(
        layer, lambda r: r.counts["draw_calls"] / r.units["batch_poses"],
        "draw_calls")
