"""The random walk's step as a share of the chip's peak: the least time
the chip could take for the work its kernels need (K1's frames' bytes
over 3.35 TB/s plus K3's pair operations over 67 TFLOP/s, as the
rooflines count them) over the host clock's seconds of the window's
rollouts that were not profiled. The walk runs no model; this bounds
what a change that takes a kernel off its path can claim."""

from nbp_bench import arith

LAYER = "rollout"
UNIT = "%"
MOVES = "poses_per_s"
CELLS = ("walk_simple_b4",)


def read(layer):
    runs = [r for r in layer.get("rollouts", []) if "k3_ops" in r]
    runs = [r for r in runs if not r["profiled"]] or runs
    if not runs:
        return None
    least = sum(r["k1_bytes"] / arith.PEAK_HBM_BYTES
                + r["k3_ops"] / arith.PEAK_F32_FLOPS for r in runs)
    return 100.0 * least / sum(r["s"] for r in runs)
