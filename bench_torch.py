#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: NBP eval-rollout poses per second.

    python3 bench_torch.py [--poses 30] [--warmup-poses 3]
        [--difficulty simple] [--seed 8] [--quick] [--device cuda]
        [--dtype float32|bfloat16] [--stratified] [--batched-capture]

The single-scene path of ``bench.py`` over the port's device-resident
rollout (``nextbestpath_tpu_torch/eval/scan_rollout.py::ScanRollout``, a
pose replayed as CUDA graphs): the procgen scene of ``--difficulty`` and
``--seed`` under ``default_params()`` (``--quick``: 64x114 frames, 1024
points a frame, 262,144 point capacity, 4096 GT points, at most 10 poses,
as ``bench.py --quick``), and the full-width NBP with seeded random
weights and its obstacle decoder opened (``seeded_nbp``, ``bench.py``'s
branch without a checkpoint), computing in ``--dtype`` (default f32;
``bench.py`` runs bf16). ``--stratified`` and ``--batched-capture`` select
the scan's capture options, as ``bench.py``'s flags of those names; the
defaults (f32, the iid draw, a substep's append at a time) are the
configuration this benchmark has always measured. One warm-up rollout of
``--warmup-poses`` poses (it captures the graphs), then 5 measured
rollouts of ``--poses`` poses at ``seed + 1``. Prints ONE JSON line:

    {"metric": "env_steps_per_sec", "value": <median of 5>, "unit":
     "poses/s", "vs_baseline": value / 0.5, "min", "max", "runs": 5,
     "device": "<name, power limit>", "coverage_final", "auc", "dtype",
     "stratified", "batched_capture"}

``vs_baseline`` divides by ``bench.py``'s provisional reference rate. Runs
on the card unless ``--device cpu``; exits 2 when the card is asked for and
absent.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

REFERENCE_POSES_PER_SEC = 0.5  # bench.py's constant
RUNS = 5


def device_label(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    "cpu"."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--poses", type=int, default=30)
    ap.add_argument("--warmup-poses", type=int, default=3)
    ap.add_argument("--difficulty", default="simple")
    ap.add_argument("--seed", type=int, default=8)
    ap.add_argument("--quick", action="store_true",
                    help="small camera, small buffers, at most 10 poses")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--stratified", action="store_true",
                    help="the stratified pixel draw in every frame")
    ap.add_argument("--batched-capture", action="store_true",
                    help="a move's frames appended with one scatter")
    args = ap.parse_args(argv)

    import torch

    from nextbestpath_tpu_torch.assets import (generate_scene,
                                               pack_generated_scene)
    from nextbestpath_tpu_torch.config import default_params
    from nextbestpath_tpu_torch.eval.nbp_planning import seeded_nbp
    from nextbestpath_tpu_torch.eval.scan_rollout import ScanRollout

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("bench_torch: torch.cuda.is_available() is False; pass "
              "--device cpu to run on the CPU", file=sys.stderr)
        return 2
    if args.quick:
        params = default_params(image_height=64, image_width=114,
                                points_per_frame=1024,
                                full_pc_capacity=262144,
                                n_gt_surface_points=4096)
        poses = min(args.poses, 10)
    else:
        params = default_params()
        poses = args.poses
    params.update(stratified_sampling=args.stratified,
                  batched_capture=args.batched_capture)
    assets = pack_generated_scene(
        generate_scene(args.difficulty, seed=args.seed), params=params)
    rollout = ScanRollout(assets, seeded_nbp(dtype=getattr(torch, args.dtype)),
                          params=params, device=device)
    rollout.run(n_poses=args.warmup_poses, seed=args.seed)
    results, regens = [], []
    for _ in range(RUNS):
        results.append(rollout.run(n_poses=poses, seed=args.seed + 1))
        regens.append(sum(rollout.regen_poses))
    rates = [r.steps_per_sec for r in results]
    value = statistics.median(rates)
    res = results[0]
    print(json.dumps({
        "metric": "env_steps_per_sec", "value": value, "unit": "poses/s",
        "vs_baseline": value / REFERENCE_POSES_PER_SEC, "min": min(rates),
        "max": max(rates), "runs": RUNS, "device": device_label(device),
        "coverage_final": res.coverage_evolution[-1], "auc": res.auc,
        "dtype": args.dtype, "stratified": rollout.stratified,
        "batched_capture": rollout.batched_capture}))
    print(f"# {args.difficulty}/{args.seed}, {poses} poses a run, rates "
          f"{rates}, regeneration poses a run {regens}, points "
          f"{res.n_points}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
