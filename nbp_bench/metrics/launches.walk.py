"""The CUDA kernel launches a batch pose of the walk: the program's
counter ``launches`` (the rollout's change of ``kernels.LAUNCHES``, each
graph replay adding the launches its capture recorded) over the
rollout's batch poses. On the card a pose replays K3s and K1s once each,
and the initial frames launch K1s once a rollout. The median over the
cell's rollouts before any profiler (``program_spans.median``): in a
``--trace 1`` run that is one rollout, the window's first."""

from nbp_bench.metrics import program_spans

LAYER = "kernels"
UNIT = "launches/pose"
MOVES = "poses_per_s"
CELLS = ("walk_simple_b4",)


def read(layer):
    return program_spans.median(
        layer, lambda r: r.counts["launches"] / r.units["batch_poses"],
        "launches")
