"""SconeVis's share of its roofline in the profiled rollout: its
operations a pose (``arith_scone.scone_vis_flops``: 20 candidates of
2,048 tokens, 2 m n k a matrix product, attention's two products
included) times the profiled poses, over 67 TFLOP/s (f32 without TF32),
over the device seconds of the kernels launched inside the program's
span ``scone_vis`` (``nbv_spans``: tied to the span by the launch's
correlation id)."""

from nbp_bench import arith
from nbp_bench.metrics import nbv_spans

LAYER = "model"
UNIT = "%"
MOVES = "poses_per_s"
CELLS = ("nbv_simple",)


def read(layer):
    t = nbv_spans.device_s_in_spans(layer, ("scone_vis",))
    if not t:
        return None
    flops = layer["vis_flops"] * layer["traced_poses"]
    return 100.0 * flops / arith.PEAK_F32_FLOPS / t
