"""A copy of the benchmark's data files at sizes a CPU test can hold: the
same cells, configurations, mixes and readers, with small frames,
buffers, U-Nets and windows."""

from __future__ import annotations

import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def _edit(path: str, **changes) -> None:
    with open(path) as f:
        d = json.load(f)
    for k, v in changes.items():
        if isinstance(v, dict):
            d[k].update(v)
        else:
            d[k] = v
    with open(path, "w") as f:
        json.dump(d, f)


def tiny_root(tmp: str) -> str:
    """``tmp`` holding BENCHMARK.json and a shrunken ``nbp_bench`` data
    tree; returns it."""
    dst = os.path.join(tmp, "nbp_bench")
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp)
    cfg = os.path.join(dst, "configs")
    _edit(os.path.join(cfg, "nbp_eval_bf16.json"),
          params={"image_height": 32, "image_width": 57,
                  "points_per_frame": 96, "full_pc_capacity": 30000,
                  "n_gt_surface_points": 1000, "pc2img_size": [64, 64],
                  "value_map_size": [16, 16]})
    # At this size bf16's rounding is no guide to the full width's; the
    # tiny step computes in f32, below which the control still lies.
    _edit(os.path.join(cfg, "nbp_train_bf16.json"),
          model={"width": 8, "dtype": "float32"})
    p = os.path.join(dst, "mixes", "simple_b4_walk.json")
    with open(p) as f:
        seeds = json.load(f)["scene_seeds"][:2]
    _edit(p, poses=8, warmup_poses=2, scene_seeds=seeds)
    _edit(os.path.join(dst, "mixes", "steps_b56.json"), rows=48, side=32,
          max_pixels=16, micro_batch=4, accumulate=3)
    return tmp
