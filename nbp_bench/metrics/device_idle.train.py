"""The share of the profiled pass's seconds (host clock) in which no
activity ran on the device: 1 - the union of the device's activity
intervals over the pass's length."""

LAYER = "device"
UNIT = "%"
MOVES = "train_samples_per_s"
CELLS = ("train_b56",)


def read(layer):
    sl = layer.get("slice")
    if sl is None or "passes" not in layer or not layer.get("slice_s"):
        return None
    return 100.0 * (1.0 - sl.busy_s() / layer["slice_s"])
