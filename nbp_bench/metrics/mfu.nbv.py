"""The next-best-view pose as a share of the chip's f32 peak: SconeOcc's
and SconeVis's operations a pose (``arith_scone``, from the published
layer shapes; 2 m n k a matrix product) times the window's poses a
second (host clock, no profiler in the window), over 67 TFLOP/s, the
f32 peak without TF32. The carving, the coverage, the token draw and the
sensor are not counted."""

from nbp_bench import arith

LAYER = "model"
UNIT = "%"
MOVES = "poses_per_s"
CELLS = ("nbv_simple",)


def read(layer):
    if not layer.get("window_s") or "vis_flops" not in layer:
        return None
    flops = layer["occ_flops"] + layer["vis_flops"]
    return (100.0 * flops * layer["poses"] / layer["window_s"]
            / arith.PEAK_F32_FLOPS)
