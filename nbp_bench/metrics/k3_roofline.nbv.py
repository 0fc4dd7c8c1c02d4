"""K3's share of its roofline in the profiled next-best-view rollout, the
single-scene launch over the 2M-slot cloud's sample: 9 f32 operations a
(GT point, valid sample) pair, the pairs of each pose's coverage (its
cloud count, capped at the sample's size, times the scene's GT points),
over 67 TFLOP/s, over the device time of its kernels
(``fill_plan_kernel`` and ``min_sq_dist_kernel``), as
``k3_roofline.eval`` reads the walk's scene-axis launches."""

from nbp_bench import arith

LAYER = "kernels"
UNIT = "%"
MOVES = "poses_per_s"
CELLS = ("nbv_simple",)


def read(layer):
    sl = layer.get("slice")
    if sl is None or "k3_ops" not in layer:
        return None
    t = sl.device_s("min_sq_dist_kernel")
    if not t:
        return None
    t += sl.device_s("fill_plan_kernel") or 0.0
    return 100.0 * layer["k3_ops"] / arith.PEAK_F32_FLOPS / t
