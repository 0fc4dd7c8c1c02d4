"""Training's needed operations over the window's passes that were not
profiled, over their seconds, as a share of the H100's bf16 peak: three
forwards' worth (forward and backward, 3 x 182.41 GFLOP) a sample."""

from nbp_bench import arith

LAYER = "model"
UNIT = "%"
MOVES = "train_samples_per_s"
CELLS = ("train_b56",)


def read(layer):
    if "passes" not in layer:
        return None
    runs = [p for p in layer["passes"] if not p["profiled"]] or \
        layer["passes"]
    seconds = sum(p["s"] for p in runs)
    flops = layer["train_flops_per_sample"] * sum(p["samples"] for p in runs)
    return 100.0 * flops / seconds / arith.PEAK_BF16_FLOPS
