"""The occupancy-weighted token draw's share of its roofline in the
profiled rollout: the least device time of a pose's draw
(``arith_scone.draw_bound_s``: one logarithm a (candidate, token, proxy
point) at the special-function units' rate, 0.196 ms at the published
sizes; the bytes no design avoids where more) times the profiled poses,
over the device seconds of the kernels launched inside the program's
spans ``gumbel`` (the noise) and ``sample`` (the frustum masks, the
volumes and each candidate's argmax) (``nbv_spans``: tied by the
launch's correlation id). The bound holds for a draw that writes no
noise too, so the share stays below 100% whatever the draw's design."""

from nbp_bench.metrics import nbv_spans

LAYER = "kernels"
UNIT = "%"
MOVES = "poses_per_s"
CELLS = ("nbv_simple",)


def read(layer):
    t = nbv_spans.device_s_in_spans(layer, ("gumbel", "sample"))
    if not t:
        return None
    return 100.0 * layer["draw_bound_s"] * layer["traced_poses"] / t
