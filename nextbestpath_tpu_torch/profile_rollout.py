"""Where a pose's time goes: the planning rollout under ``torch.profiler``.

    python3 -m nextbestpath_tpu_torch.profile_rollout [--poses 4]

Runs the main path that ``chip_smoke.py`` drives
(``eval.nbp_planning.main_path_setup``: procgen ``simple`` seed 8, default
config, full-width NBP in f32 with seeded weights and the obstacle decoder
opened), warms up as the smoke does, then profiles ``--poses`` poses on the
card. Prints the wall time per pose, the device's busy share
(the union of kernel intervals over the wall time) and the operations
with the most device time. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .eval.nbp_planning import (MAIN_PATH_SEED, MAIN_PATH_WARMUP_POSES,
                                NBPPlanningRollout, main_path_setup)


def _busy_us(events) -> float:
    """Length of the union of the device kernels' intervals, in us."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    total, end = 0.0, float("-inf")
    for s, e in spans:
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--poses", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_rollout needs a CUDA card")
    dev = torch.device("cuda")
    params, assets, model = main_path_setup()
    NBPPlanningRollout(assets, model, params=params, seed=MAIN_PATH_SEED,
                       device=dev).run(n_poses=MAIN_PATH_WARMUP_POSES)
    roll = NBPPlanningRollout(assets, model, params=params, seed=MAIN_PATH_SEED,
                              device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = roll.run(n_poses=args.poses)
        wall = time.perf_counter() - t0
    busy = _busy_us(prof.events()) / 1e6
    print(f"profiled {args.poses} poses: {wall / args.poses * 1e3:.2f} ms/pose "
          f"(under the profiler), device busy {busy / wall:.3f} of the wall, "
          f"coverage {res.coverage_evolution}")
    print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                    row_limit=25))


if __name__ == "__main__":
    main()
