"""The share (%) of a pass's micro steps whose loss and gradients were a
CUDA graph's replay: the program's counter ``graph_replays`` over the
pass's micro steps; the median over the cell's passes before any
profiler (``program_spans.median``). None where the program keeps no
such counter (a program without the graph, or the CPU's eager step)."""

from nbp_bench.metrics import program_spans

LAYER = "model"
UNIT = "%"
MOVES = "train_samples_per_s"
CELLS = ("train_b56",)


def read(layer):
    return program_spans.median(
        layer,
        lambda r: 100.0 * r.counts["graph_replays"] / r.units["micro_steps"],
        "graph_replays")
