"""The host's milliseconds a micro step in the forward: the program's span
``forward`` (the gather of the micro batch, the U-Net in train mode and
the loss), over the pass's micro steps; the median over the cell's
passes before any profiler (``program_spans.median``): in a ``--trace
1`` run that is one pass, the window's first, which may fall in the
slow phase of a process's start."""

from nbp_bench.metrics import program_spans

LAYER = "model"
UNIT = "ms"
MOVES = "train_samples_per_s"
CELLS = ("train_b56",)


def read(layer):
    return program_spans.median(
        layer, lambda r: 1e3 * r.host_s("forward") / r.units["micro_steps"],
        "forward")
