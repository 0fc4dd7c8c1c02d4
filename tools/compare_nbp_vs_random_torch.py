#!/usr/bin/env python
"""Head to head on one scene with the PyTorch port: the NBP planner against
the random-walk baseline, the counterpart of
``tools/compare_nbp_vs_random.py`` (the same flags and JSON).

The reference's headline benchmark shape: coverage evolution and AUC at a
fixed pose budget. The NBP runs as a ``ScanRollout`` (f32 U-Net, as the
JAX tool's ``NBP()``), the walk as ``random_walk_rollout``, both from seed
123. Weights come from ``--weights`` when the file exists, else from a
seeded random init (the JSON's ``weights`` says which).

    python tools/compare_nbp_vs_random_torch.py [--difficulty simple] \\
        [--poses 40] [--device cuda|cpu] [--plot data/curves.png]

The coverage-curve plot is drawn only when ``--plot`` names a file; it
needs matplotlib, and the tool fails if a plot was asked for and cannot
be drawn. Runs on the card unless ``--device cpu``; exits 2 when the card
is asked for and absent.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SEED = 123


def main(argv=None) -> dict:
    """Runs both policies and returns the dict it writes to ``--out``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", default="weights/nbp/nbp_best_val.ckpt")
    ap.add_argument("--difficulty", default="simple")
    ap.add_argument("--scene-seed", type=int, default=8)
    ap.add_argument("--poses", type=int, default=40)
    ap.add_argument("--out", default="data/compare_nbp_vs_random_torch.json")
    ap.add_argument("--plot", default=None,
                    help="draw the coverage curves into this file "
                         "(needs matplotlib)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from nextbestpath_tpu_torch.assets import (generate_scene,
                                               pack_generated_scene)
    from nextbestpath_tpu_torch.config import default_params
    from nextbestpath_tpu_torch.eval import quality as Q
    from nextbestpath_tpu_torch.eval.random_walk import random_walk_rollout
    from nextbestpath_tpu_torch.eval.scan_rollout import ScanRollout
    from nextbestpath_tpu_torch.models import unet

    device = Q.tool_device("compare_nbp_vs_random_torch", args.device)
    params = default_params()
    assets = pack_generated_scene(
        generate_scene(args.difficulty, seed=args.scene_seed), params=params)

    tag = "random-init"
    if os.path.exists(args.weights):
        model, epoch = Q.load_policy(args.weights, "float32", device)
        tag = f"trained(e{epoch})"
    else:
        torch.manual_seed(0)
        model = unet.NBP().to(device)
    print(f"# NBP weights: {tag}", flush=True)

    nbp_res = ScanRollout(assets, model, params=params, device=device).run(
        n_poses=args.poses, seed=SEED)
    print(f"# NBP: final {nbp_res.coverage_evolution[-1]:.4f} "
          f"auc {nbp_res.auc:.4f} ({nbp_res.steps_per_sec:.1f} poses/s)",
          flush=True)
    rw_res = random_walk_rollout(assets, params=params, n_poses=args.poses,
                                 seed=SEED, device=device)
    print(f"# RW:  final {rw_res.coverage_evolution[-1]:.4f} "
          f"auc {rw_res.auc:.4f}", flush=True)

    out = {"weights": tag, "scene": assets.name, "poses": args.poses,
           "nbp": {"coverage_evolution": nbp_res.coverage_evolution,
                   "auc": nbp_res.auc,
                   "steps_per_sec": nbp_res.steps_per_sec},
           "random_walk": {"coverage_evolution": rw_res.coverage_evolution,
                           "auc": rw_res.auc}}
    Q.write_json(args.out, out)
    if args.plot:
        from nextbestpath_tpu_torch.utils.plotting import plot_coverage_curves

        plot_coverage_curves({"nbp": nbp_res.coverage_evolution,
                              "random_walk": rw_res.coverage_evolution},
                             args.plot)
    print(json.dumps({"nbp_auc": round(nbp_res.auc, 4),
                      "rw_auc": round(rw_res.auc, 4)}))
    return out


if __name__ == "__main__":
    main()
