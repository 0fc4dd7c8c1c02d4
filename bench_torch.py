#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: NBP eval-rollout poses per second.

    python3 bench_torch.py [--poses 30] [--warmup-poses 3]
        [--difficulty simple] [--seed 8] [--quick] [--device cuda]
        [--dtype float32|bfloat16] [--stratified] [--batched-capture]
        [--batch N] [--secondary]

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

``vs_baseline`` divides by ``bench.py``'s provisional reference rate. A
comment line on standard error gives the rates, the regeneration poses of
each run, the point count and, on the card, the peak device memory from
the rollout's construction on.

``--batch N`` (N > 1), as ``bench.py``'s: the procgen scenes ``seed + i``
(i < N), padded to a common lattice, through the true-batch
``BatchedScanRollout`` (one U-Net forward of batch N on any scene's
regeneration pose, one flag read a pose); the measured runs take
``seed + 100`` as ``bench.py``'s batched run does, ``value`` is the median
aggregate rate (N x poses / wall) and the line gains ``"batch": N``.
``--secondary`` (batch 1 only, as ``bench.py``'s) measures the other
sampling mode the same way and adds ``<tag>_value`` and
``<tag>_vs_baseline``, tag ``stratified`` (or ``faithful`` under
``--stratified``). Runs on the card unless ``--device cpu``; exits 2 when
the card is asked for and absent.
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
    ap.add_argument("--batch", type=int, default=1,
                    help="scenes rolled out together on a scene axis")
    ap.add_argument("--secondary", action="store_true",
                    help="also the other sampling mode's rate (batch 1)")
    args = ap.parse_args(argv)

    import torch

    from nextbestpath_tpu_torch.assets import (generate_scene,
                                               pack_generated_scene,
                                               pad_assets_to_common)
    from nextbestpath_tpu_torch.config import Params, default_params
    from nextbestpath_tpu_torch.eval.nbp_planning import seeded_nbp
    from nextbestpath_tpu_torch.eval.scan_rollout import (BatchedScanRollout,
                                                          ScanRollout)

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
    if args.batch < 1:
        ap.error("--batch must be at least 1")
    model = seeded_nbp(dtype=getattr(torch, args.dtype))

    def measure(rollout, seed):
        """The warm-up run (it captures the graphs), then RUNS measured
        runs: (rates, results of the first run, regeneration poses a run)."""
        rollout.run(n_poses=args.warmup_poses, seed=args.seed)
        rates, regens, outs = [], [], []
        for _ in range(RUNS):
            outs.append(rollout.run(n_poses=poses, seed=seed))
            res = outs[-1][0] if args.batch > 1 else outs[-1]
            rates.append(res.steps_per_sec)
            regens.append(sum(map(any, rollout.regen_poses))
                          if args.batch > 1 else sum(rollout.regen_poses))
        return rates, outs[0], regens

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if args.batch > 1:
        scenes = pad_assets_to_common([pack_generated_scene(
            generate_scene(args.difficulty, seed=args.seed + i),
            params=params) for i in range(args.batch)])
        rollout = BatchedScanRollout(scenes, model, params=params,
                                     device=device)
        rates, results, regens = measure(rollout, args.seed + 100)
        res = results[0]
        stratified = rollout.members[0].stratified
        batched_capture = rollout.members[0].batched_capture
    else:
        assets = pack_generated_scene(
            generate_scene(args.difficulty, seed=args.seed), params=params)
        rollout = ScanRollout(assets, model, params=params, device=device)
        rates, res, regens = measure(rollout, args.seed + 1)
        stratified, batched_capture = (rollout.stratified,
                                       rollout.batched_capture)
    value = statistics.median(rates)
    line = {
        "metric": "env_steps_per_sec", "value": value, "unit": "poses/s",
        "vs_baseline": value / REFERENCE_POSES_PER_SEC, "min": min(rates),
        "max": max(rates), "runs": RUNS, "device": device_label(device),
        "coverage_final": res.coverage_evolution[-1], "auc": res.auc,
        "dtype": args.dtype, "stratified": stratified,
        "batched_capture": batched_capture}
    if args.batch > 1:
        line["batch"] = args.batch
    elif args.secondary:
        tag = "faithful" if args.stratified else "stratified"
        other = Params(dict(params.as_dict(),
                            stratified_sampling=not args.stratified),
                       flatten=False)
        o_rates, o_res, _ = measure(
            ScanRollout(assets, model, params=other, device=device),
            args.seed + 1)
        line[f"{tag}_value"] = statistics.median(o_rates)
        line[f"{tag}_vs_baseline"] = (line[f"{tag}_value"]
                                      / REFERENCE_POSES_PER_SEC)
        print(f"# {tag}: rates {o_rates}, coverage final "
              f"{o_res.coverage_evolution[-1]:.4f} auc {o_res.auc:.4f}",
              file=sys.stderr)
    print(json.dumps(line))
    peak = (f", peak memory {torch.cuda.max_memory_allocated(device) / 2 ** 20:.1f}"
            f" MiB" if device.type == "cuda" else "")
    print(f"# {args.difficulty}/{args.seed} x {args.batch}, {poses} poses a "
          f"run, rates {rates}, regeneration poses a run {regens}, points "
          f"{res.n_points}{peak}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
