"""K3's share of its roofline in the profiled rollout: 9 f32 operations
a (GT point, valid sample) pair, the pairs of the counts its launches
were given (a pose's cloud count, capped at the sample's size, times
the scene's GT points), over 67 TFLOP/s, over the device time of its
kernels (``fill_plan_kernel`` and ``min_sq_dist_kernel``). The count
assumes the brute-force search the reference makes."""

from nbp_bench import arith

LAYER = "kernels"
UNIT = "%"
MOVES = "poses_per_s"
CELLS = ("walk_simple_b4",)


def read(layer):
    sl = layer.get("slice")
    if sl is None:
        return None
    t = sl.device_s("min_sq_dist_kernel")
    if not t:
        return None
    t += sl.device_s("fill_plan_kernel") or 0.0
    r = [r for r in layer["rollouts"] if r["profiled"]][0]
    return 100.0 * r["k3_ops"] / arith.PEAK_F32_FLOPS / t
