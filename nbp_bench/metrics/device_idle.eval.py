"""The share of the profiled rollout's seconds (host clock) in which no
activity ran on the device: 1 - the union of the device's activity
intervals over the rollout's length."""

LAYER = "device"
UNIT = "%"
MOVES = "poses_per_s"
CELLS = ("walk_simple_b4",)


def read(layer):
    sl = layer.get("slice")
    if sl is None or "rollouts" not in layer or not layer.get("slice_s"):
        return None
    return 100.0 * (1.0 - sl.busy_s() / layer["slice_s"])
