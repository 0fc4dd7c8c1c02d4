#!/usr/bin/env python
"""Split-half reliability of the NBP trainer's suffix labels, with the
PyTorch port: the counterpart of ``tools/probe_label_quality.py`` (the
same flags, JSON keys and printed lines).

The value targets are path-suffix gains: state i's label at pose j's pixel
is max(0, 100 (cov_j - cov_i)) for every later pose j on the same planned
path, so it depends on what the Boltzmann policy (beta 0.5) happened to do
after i. The probe measures that noise directly:

1. a collection rollout (``train/scan_collection.py::ScanCollection``,
   draws of seed 777) to the branch pose t;
2. K continuations of ``--cont-poses`` poses from that very mid-state
   (``snapshot`` / ``restore``), each replanning at the branch
   (``force_replan``) with draws of its own seed, 10000 + 97 k;
3. the branch pose's suffix labels of each continuation (row 0 of its
   records, ``suffix_labels_from_out``): the within-pixel spread across
   continuations, the split-half Spearman correlation of the two halves'
   mean gains on the pixels both label, and the share of pixels that one
   continuation alone labels.

A split-half reliability near 0 says the target at that state is mostly
continuation noise.

    python tools/probe_label_quality_torch.py [--ckpt weights/nbp/nbp_best_val.ckpt] \\
        [--branch-poses 5 20 40] [--continuations 8] [--device cuda|cpu]

``--quick``: 32x56 frames and small buffers, random weights (seeded).
Runs on the card unless ``--device cpu``; exits 2 when the card is asked
for and absent. The output defaults to ``data/label_quality_torch.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PREFIX_SEED = 777


def branch_seed(k: int) -> int:
    """The draws' seed of continuation k."""
    return 10_000 + 97 * k


def _avg_ranks(x):
    """Average ranks (scipy's rankdata "average"): the suffix gains hold
    many exact zeros, and positional tie-breaking would read them as rank
    agreement or disagreement by their order."""
    import numpy as np

    order = np.argsort(x, kind="stable")
    xs = np.asarray(x)[order]
    ranks = np.empty(len(x), np.float64)
    i = 0
    while i < len(xs):
        j = i
        while j + 1 < len(xs) and xs[j + 1] == xs[i]:
            j += 1
        ranks[order[i:j + 1]] = (i + j) / 2.0
        i = j + 1
    return ranks


def spearman(a, b):
    import numpy as np

    if len(a) < 3:
        return float("nan")
    ra = _avg_ranks(a)
    rb = _avg_ranks(b)
    ra = ra - ra.mean()
    rb = rb - rb.mean()
    denom = np.sqrt((ra ** 2).sum() * (rb ** 2).sum())
    return float((ra * rb).sum() / denom) if denom > 0 else float("nan")


def branch_labels(out, vms: int, grid_range) -> dict:
    """The branch pose's labels in a continuation's records (row 0):
    {(rot, row, col): gain}."""
    from nextbestpath_tpu_torch.train.scan_collection import \
        suffix_labels_from_out

    row = {}
    for pose_i, pixels, gains in suffix_labels_from_out(out, vms, grid_range):
        if pose_i != 0:
            continue
        for (r_, y, x), g in zip(pixels, gains):
            row[(int(r_), int(y), int(x))] = float(g)
    return row


def reliability(per_cont, continuations: int, branch_pose: int) -> dict:
    """A branch's entry of the report from each continuation's labels."""
    import numpy as np

    by_pixel = defaultdict(list)
    for ci, row in enumerate(per_cont):
        for px, g in row.items():
            by_pixel[px].append((ci, g))

    multi = {px: v for px, v in by_pixel.items() if len(v) >= 2}
    singles = sum(1 for v in by_pixel.values() if len(v) == 1)
    stds = [float(np.std([g for _, g in v])) for v in multi.values()]
    means = [float(np.mean([g for _, g in v])) for v in multi.values()]

    # Split-half reliability on the pixels that both halves label.
    half = continuations // 2
    a_vals, b_vals = [], []
    for px, v in by_pixel.items():
        ga = [g for ci, g in v if ci < half]
        gb = [g for ci, g in v if ci >= half]
        if ga and gb:
            a_vals.append(float(np.mean(ga)))
            b_vals.append(float(np.mean(gb)))
    rel = spearman(np.asarray(a_vals), np.asarray(b_vals))

    noise = float(np.mean(stds)) if stds else float("nan")
    signal = float(np.std(means)) if means else float("nan")
    return {
        "branch_pose": branch_pose,
        "labels_per_continuation": [len(row) for row in per_cont],
        "n_pixels_total": len(by_pixel),
        "n_pixels_multi": len(multi),
        "frac_single_continuation": round(
            singles / max(len(by_pixel), 1), 4),
        "mean_within_pixel_std": round(noise, 4),
        "across_pixel_signal_std": round(signal, 4),
        "noise_to_signal": round(noise / signal, 4)
        if signal and signal > 0 else None,
        "split_half_spearman": round(rel, 4),
        "n_split_half_pixels": len(a_vals),
    }


def main(argv=None, make_draws=None, make_branch_draws=None) -> dict:
    """Runs the probe and returns the dict it writes to ``--out``.
    make_draws(seed): the provider of the prefix's draws, as the
    collection takes them; make_branch_draws(seed): a continuation's
    (both default ``TorchDraws``; the tests inject the JAX key
    schedules)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--difficulty", default="simple")
    ap.add_argument("--scene-seed", type=int, default=8)
    ap.add_argument("--branch-poses", type=int, nargs="+",
                    default=[5, 20, 40])
    ap.add_argument("--continuations", type=int, default=8)
    ap.add_argument("--cont-poses", type=int, default=30)
    ap.add_argument("--ckpt", default="weights/nbp/nbp_best_val.ckpt")
    ap.add_argument("--out", default="data/label_quality_torch.json")
    ap.add_argument("--quick", action="store_true",
                    help="small frames/buffers (CPU smoke)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    args = ap.parse_args(argv)

    import torch

    from nextbestpath_tpu_torch.assets import (generate_scene,
                                               pack_generated_scene)
    from nextbestpath_tpu_torch.config import default_params
    from nextbestpath_tpu_torch.draws import TorchDraws
    from nextbestpath_tpu_torch.eval import quality as Q
    from nextbestpath_tpu_torch.models import unet
    from nextbestpath_tpu_torch.train.scan_collection import ScanCollection

    device = Q.tool_device("probe_label_quality_torch", args.device)
    if args.quick:
        p = default_params(image_height=32, image_width=56,
                           points_per_frame=256, full_pc_capacity=32768,
                           n_gt_surface_points=1024, max_path_len=32)
    else:
        p = default_params()
    assets = pack_generated_scene(
        generate_scene(args.difficulty, seed=args.scene_seed), params=p)
    if os.path.exists(args.ckpt) and not args.quick:
        model, ep = Q.load_policy(args.ckpt, args.dtype, device)
        print(f"# ckpt {args.ckpt} (epoch {ep})", file=sys.stderr,
              flush=True)
    else:
        torch.manual_seed(0)
        model = unet.NBP(dtype=getattr(torch, args.dtype))
    if make_branch_draws is None:
        make_branch_draws = (make_draws if make_draws is not None else
                             lambda seed: TorchDraws(seed, device))

    col = ScanCollection([assets], model, params=p, make_draws=make_draws,
                         device=device)
    vms = int(p.value_map_size[0])
    grid_range = tuple(p.prediction_range)
    report = {"difficulty": args.difficulty, "scene_seed": args.scene_seed,
              "continuations": args.continuations,
              "cont_poses": args.cont_poses, "branches": []}
    # One state's capacity for every branch: the trajectory buffer must
    # hold the longest prefix and its continuation whole.
    cap_poses = max(args.branch_poses) + args.cont_poses
    for t in args.branch_poses:
        draws = col.begin(0, seed=PREFIX_SEED, n_poses=cap_poses)
        # The prefix's poses after a stop run as the JAX scan's frozen
        # ones: the continuations go on from the same state.
        col.advance(t, draws, run_frozen=True)
        # A replan at the branch: each continuation's suffix segment
        # starts at the branch pose, row 0 of its records.
        col.force_replan()
        mid = col.snapshot()
        per_cont = []
        for k in range(args.continuations):
            col.restore(mid)
            out = col.advance(args.cont_poses, make_branch_draws(
                branch_seed(k)))
            per_cont.append(branch_labels(out, vms, grid_range))
        entry = reliability(per_cont, args.continuations, t)
        report["branches"].append(entry)
        print(f"# t={t}: {entry}", file=sys.stderr, flush=True)

    Q.write_json(args.out, report)
    print(json.dumps({"label_quality": report["branches"]}))
    return report


if __name__ == "__main__":
    main()
