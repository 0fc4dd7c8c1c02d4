"""The share of the profiled next-best-view rollout's seconds (host clock)
in which no activity ran on the device: 1 - the union of the device's
activity intervals over the rollout's length. The rollout runs after the
window, eagerly, under CUPTI, whose cost for each eager operation
stretches it: this compares only between traced runs."""

LAYER = "device"
UNIT = "%"
MOVES = "poses_per_s"
CELLS = ("nbv_simple",)


def read(layer):
    sl = layer.get("slice")
    if sl is None or not layer.get("slice_s") or "traced_poses" not in layer:
        return None
    return 100.0 * (1.0 - sl.busy_s() / layer["slice_s"])
