#!/usr/bin/env python
"""NBP training CLI of the PyTorch port, the counterpart of
``train_nbp.py``'s host-loop trainer (same flags, same checkpoints).

    python train_nbp_torch.py --procgen simple --epochs 2 --poses 8 \\
        --weights-dir /tmp/nbp_weights --log-dir /tmp/nbp_log \\
        --db /tmp/nbp_db/replay.npz

Scenes: ``--scene-dirs`` (reference-format scene directories), else
``--procgen`` ('simple:2,hard' : difficulty[:count], seeds from
``--seed`` as the JAX CLI draws them); ``--mirror`` adds each scene's
x-mirrored variant. Each epoch collects one ``--poses`` rollout a scene
into the replay store ``--db``; epoch 0 moves the validation split out,
later epochs train (``train/driver.py::run_training_nbp``) and write
``nbp_best_val.ckpt`` and ``nbp_epoch_<n>.ckpt`` to ``--weights-dir`` (the
JAX package reads them) and ``nbp_loss.json`` to ``--log-dir``. The
defaults are the JAX CLI's (``weights/nbp``, ``training_log``), which hold
the committed checkpoint: point both elsewhere for trial runs. Runs on the
card unless ``--device cpu``; exits 2 when the card is asked for and
absent. ``--quick`` shrinks the camera, the buffers, the model input
(64x64) and the U-Net (width 8) for smoke runs. The scan trainer
(``--scan``) is not ported.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

QUICK = dict(image_height=32, image_width=56, points_per_frame=256,
             full_pc_capacity=32768, n_gt_surface_points=1024,
             max_path_len=32, pc2img_size=[64, 64], value_map_size=[16, 16])


def parse_procgen(spec: str, seed_base: int):
    """'simple:2,normal' -> [(difficulty, seed), ...] (default count 1)."""
    out = []
    for i, tok in enumerate(spec.split(",")):
        tok = tok.strip()
        if not tok:
            continue
        if ":" in tok:
            diff, cnt = tok.split(":")
            cnt = int(cnt)
        else:
            diff, cnt = tok, 1
        for j in range(cnt):
            out.append((diff.strip(), seed_base + i * 37 + j))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-c", "--config", default=None,
                    help="JSON config (reference schema, flattened sections)")
    ap.add_argument("--procgen", default=None,
                    help="procgen training scenes: 'simple:2,hard:1' "
                         "(difficulty[:count] comma list)")
    ap.add_argument("--scene-dirs", default=None,
                    help="comma-separated reference-format scene directories")
    ap.add_argument("--mirror", action="store_true",
                    help="add the x-mirrored variant of every scene")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--poses", type=int, default=None)
    ap.add_argument("--seed", type=int, default=8)
    ap.add_argument("--db", default="nbp_data/replay.npz",
                    help="replay store (npz), loaded if present")
    ap.add_argument("--weights-dir", default="weights/nbp")
    ap.add_argument("--log-dir", default="training_log")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quick", action="store_true",
                    help="small camera, buffers, model input and U-Net")
    args = ap.parse_args(argv)

    import torch

    from nextbestpath_tpu_torch.assets import (generate_scene, load_scene_dir,
                                               pack_generated_scene)
    from nextbestpath_tpu_torch.config import default_params, load_params
    from nextbestpath_tpu_torch.train.driver import (run_training_nbp,
                                                     seeded_train_model)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("train_nbp_torch: torch.cuda.is_available() is False; pass "
              "--device cpu to run on the CPU", file=sys.stderr)
        return 2

    params = load_params(args.config) if args.config else default_params()
    for k in ("pc2img_size", "prediction_range", "value_map_size", "n_pieces",
              "full_pc_capacity", "points_per_frame", "max_path_len",
              "fov_degrees", "camera_znear"):
        if k not in params:
            params.update(**{k: default_params().get(k)})
    if args.quick:
        params.update(**QUICK)

    scenes = []
    if args.scene_dirs:
        for d in args.scene_dirs.split(","):
            scenes.append(load_scene_dir(d, params=params))
            if args.mirror:
                scenes.append(load_scene_dir(d, params=params,
                                             mirrored_axis=[0]))
    elif args.procgen:
        for diff, s in parse_procgen(args.procgen, args.seed):
            gen = generate_scene(diff, seed=s)
            scenes.append(pack_generated_scene(gen, params=params))
            if args.mirror:
                scenes.append(pack_generated_scene(gen, params=params,
                                                   mirrored_axis=[0]))
    else:
        print("train_nbp_torch: provide --scene-dirs or --procgen",
              file=sys.stderr)
        return 2

    epochs = (args.epochs if args.epochs is not None
              else int(params.get("epochs", 100)))
    poses = (args.poses if args.poses is not None
             else int(params.get("n_poses_in_trajectory", 100)))
    model = seeded_train_model(args.seed, width=8 if args.quick else 64)
    run_training_nbp(scenes, params=params, epochs=epochs, n_poses=poses,
                     db_path=args.db, weights_dir=args.weights_dir,
                     log_dir=args.log_dir, seed=args.seed, device=device,
                     model=model)
    return 0


if __name__ == "__main__":
    sys.exit(main())
