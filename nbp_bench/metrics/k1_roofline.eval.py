"""K1's share of its roofline in the profiled rollout: the bytes its
frames need (24 B a ray, each frame's triangles once at 40 B,
``arith.k1_bytes``) over 3.35 TB/s, over the device time of the kernel
``ray_pinhole_kernel``. A cull tests fewer pairs; the bytes stay what
the function needs, so the share cannot pass 100%."""

from nbp_bench import arith

LAYER = "kernels"
UNIT = "%"
MOVES = "poses_per_s"
CELLS = ("walk_simple_b4",)


def read(layer):
    sl = layer.get("slice")
    t = sl.device_s("ray_pinhole_kernel") if sl is not None else None
    if not t:
        return None
    r = [r for r in layer["rollouts"] if r["profiled"]][0]
    return 100.0 * r["k1_bytes"] / arith.PEAK_HBM_BYTES / t
