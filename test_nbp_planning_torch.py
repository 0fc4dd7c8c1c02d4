#!/usr/bin/env python
"""NBP planning evaluation CLI of the PyTorch port, the counterpart of
``test_nbp_planning.py`` (same flags, same behaviour, same results JSON).

    python test_nbp_planning_torch.py --procgen simple --poses 101 \\
        [-c CONFIG] [--weights weights/nbp/nbp_best_val.ckpt] [--scan] \\
        [--device cuda|cpu] [--dtype bfloat16|float32] [--out FILE]

Scenes: ``--scene-dirs`` (reference-format scene directories), else a
config's ``test_scenes`` (``procgen:<difficulty>:<count>``, held-out seeds
from ``--seed`` + 900, or scene directories), else one procgen scene per
``--procgen`` difficulty at ``--seed`` + its index. Weights: ``--weights``,
the config's ``nbp_weights``, or ``weights/nbp/nbp_best_val.ckpt`` when
present (a flax checkpoint, read without flax); random weights otherwise,
with a warning when the named file is missing. The default path is the
legacy host rollout (``eval.nbp_planning.test_nbp_planning``); ``--scan``
runs the device-resident ``ScanRollout`` instead. The U-Net computes in
``--dtype`` (bf16 by default, as the JAX CLI's ``NBP(dtype=bfloat16)``).
Runs on the card unless ``--device cpu``; exits 2 when the card is asked
for and absent. Results go to ``--out`` (default
``data/nbp_results_torch.json``, or ``data/<results_json_name>`` of a
config), so the JAX CLI's file is never overwritten.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

DEFAULT_OUT = "data/nbp_results_torch.json"
DEFAULT_WEIGHTS = "weights/nbp/nbp_best_val.ckpt"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-c", "--config", default=None)
    ap.add_argument("--procgen", default="simple")
    ap.add_argument("--scene-dirs", default=None)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--poses", type=int, default=101)
    ap.add_argument("--seed", type=int, default=8)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--quick", action="store_true",
                    help="small camera/buffers for smoke runs")
    ap.add_argument("--scan", action="store_true",
                    help="use the device-resident scan rollout (CUDA "
                         "graphs on the card)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    args = ap.parse_args(argv)

    import torch

    from nextbestpath_tpu_torch.assets import (generate_scene, load_scene_dir,
                                               pack_generated_scene)
    from nextbestpath_tpu_torch.config import default_params, load_params
    from nextbestpath_tpu_torch.eval.nbp_planning import (scene_result,
                                                          test_nbp_planning)
    from nextbestpath_tpu_torch.eval.scan_rollout import ScanRollout
    from nextbestpath_tpu_torch.models.unet import NBP
    from nextbestpath_tpu_torch.utils.checkpoint import load_nbp

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("test_nbp_planning_torch: torch.cuda.is_available() is False; "
              "pass --device cpu to run on the CPU", file=sys.stderr)
        return 2

    params = load_params(args.config) if args.config else default_params()
    for k in ("pc2img_size", "prediction_range", "value_map_size", "n_pieces",
              "full_pc_capacity", "points_per_frame", "max_path_len",
              "fov_degrees", "camera_znear"):
        if k not in params:
            params.update(**{k: default_params().get(k)})
    if args.quick:
        params.update(image_height=64, image_width=114, points_per_frame=1024,
                      full_pc_capacity=262144, n_gt_surface_points=4096)

    def scenes_from_spec(spec: str, base_seed: int):
        """A config's test_scenes entry: 'procgen:<difficulty>:<count>'
        generates held-out scenes (seed offset 900); anything else is a
        reference-format scene directory (possibly relative to
        dataset_path)."""
        if spec.startswith("procgen:"):
            parts = spec.split(":")
            diff = parts[1]
            count = int(parts[2]) if len(parts) > 2 else 1
            return [pack_generated_scene(
                generate_scene(diff, seed=base_seed + 900 + k), params=params)
                for k in range(count)]
        root = params.get("dataset_path", ".")
        path = spec if os.path.isdir(spec) else os.path.join(root, spec)
        return [load_scene_dir(path, params=params)]

    scenes = []
    if args.scene_dirs:
        for d in args.scene_dirs.split(","):
            scenes.append(load_scene_dir(d, params=params))
    elif args.config and params.get("test_scenes"):
        for spec in params.get("test_scenes"):
            scenes.extend(scenes_from_spec(spec, args.seed))
    else:
        for i, diff in enumerate(args.procgen.split(",")):
            scenes.append(pack_generated_scene(
                generate_scene(diff.strip(), seed=args.seed + i),
                params=params))

    if args.config and params.get("results_json_name") and \
            args.out == DEFAULT_OUT:
        args.out = os.path.join("data", params.get("results_json_name"))

    torch.manual_seed(0)
    model = NBP(dtype=getattr(torch, args.dtype))
    weights = args.weights or (params.get("nbp_weights")
                               if args.config else None)
    if not weights and os.path.exists(DEFAULT_WEIGHTS):
        weights = DEFAULT_WEIGHTS
    if weights and os.path.exists(weights):
        epoch, _ = load_nbp(weights, model)
        print(f"# loaded {weights} (epoch {epoch})")
    elif weights:
        print(f"# WARNING: weights {weights} not found, using random init")

    if args.scan:
        results = {}
        for assets in scenes:
            rollout = ScanRollout(assets, model, params=params, device=device)
            res = rollout.run(n_poses=args.poses, seed=args.seed)
            results[assets.name] = scene_result(res)
            print(f"{assets.name}: final coverage "
                  f"{res.coverage_evolution[-1]:.4f} auc {res.auc:.4f} "
                  f"({res.steps_per_sec:.2f} poses/s)")
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f)
    else:
        test_nbp_planning(scenes, model, params=params, n_poses=args.poses,
                          results_path=args.out, seed=args.seed,
                          device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
