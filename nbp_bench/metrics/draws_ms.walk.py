"""The host's milliseconds a batch pose in the walk's draws: the program's
span ``draws`` (``ScanRandomWalk._draw_pose``, every scene's provider
calls into the static buffers), over the rollout's batch poses; the
median over the cell's rollouts before any profiler
(``program_spans.median``): in a ``--trace 1`` run that is one
rollout, the window's first, which may fall in the slow phase of a
process's start."""

from nbp_bench.metrics import program_spans

LAYER = "rollout"
UNIT = "ms"
MOVES = "poses_per_s"
CELLS = ("walk_simple_b4",)


def read(layer):
    return program_spans.median(
        layer, lambda r: 1e3 * r.host_s("draws") / r.units["batch_poses"],
        "draws")
