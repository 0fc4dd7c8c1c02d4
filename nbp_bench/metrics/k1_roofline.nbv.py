"""K1's share of its roofline in the profiled next-best-view rollout: the
bytes its frames need (the first capture's and each move's four 256 x 456
frames, 24 B a ray and the scene's triangles once a frame at 40 B,
``arith.k1_bytes``) over 3.35 TB/s, over the device time of the kernel
``ray_pinhole_kernel``, as ``k1_roofline.eval`` reads the walk's."""

from nbp_bench import arith

LAYER = "kernels"
UNIT = "%"
MOVES = "poses_per_s"
CELLS = ("nbv_simple",)


def read(layer):
    sl = layer.get("slice")
    if sl is None or "k1_bytes" not in layer:
        return None
    t = sl.device_s("ray_pinhole_kernel")
    if not t:
        return None
    return 100.0 * layer["k1_bytes"] / arith.PEAK_HBM_BYTES / t
