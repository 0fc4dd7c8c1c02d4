"""The share (%) of a next-best-view pose's candidates whose tokens the
hand-written kernel drew: the program's counter ``kernel_draws`` over its
``token_draws`` (the candidates whose tokens were drawn, C a pose), both
in the ``nbv`` run record; the median over the window's rollouts (their
records, none profiled: the traced rollout follows the window). None
where the program keeps no such counter."""

import statistics

LAYER = "kernels"
UNIT = "%"
MOVES = "poses_per_s"
CELLS = ("nbv_simple",)


def read(layer):
    records = [r["record"] for r in layer.get("rollouts", [])
               if r.get("record") is not None]
    vals = [100.0 * r.counts.get("kernel_draws", 0) / r.counts["token_draws"]
            for r in records if r.counts.get("token_draws")]
    return statistics.median(vals) if vals else None
