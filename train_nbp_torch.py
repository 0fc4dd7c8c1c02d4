#!/usr/bin/env python
"""NBP training CLI of the PyTorch port, the counterpart of
``train_nbp.py`` (same flags, same checkpoints).

    python train_nbp_torch.py --procgen simple --epochs 2 --poses 8 \\
        --weights-dir /tmp/nbp_weights --log-dir /tmp/nbp_log \\
        --db /tmp/nbp_db/replay.npz
    python train_nbp_torch.py --scan --procgen simple:2 --eval-procgen simple \\
        --epochs 2 --poses 8 --db-dir /tmp/nbp_db --weights-dir /tmp/nbp_w \\
        --log-dir /tmp/nbp_log

Scenes: ``--scene-dirs`` (reference-format scene directories), else
``--procgen`` ('simple:2,hard' : difficulty[:count], seeds from
``--seed`` as the JAX CLI draws them); ``--mirror`` adds each scene's
x-mirrored variant. Without ``--scan`` each epoch collects one ``--poses``
rollout a scene into the replay store ``--db``; epoch 0 moves the
validation split out, later epochs train
(``train/driver.py::run_training_nbp``) and write ``nbp_best_val.ckpt`` and
``nbp_epoch_<n>.ckpt`` to ``--weights-dir`` (the JAX package reads them)
and ``nbp_loss.json`` to ``--log-dir``.

``--scan`` runs the production trainer (``run_training_nbp_scan``): the
training scenes padded to common sizes, the device-resident collection,
the bf16 U-Net, replay shards in ``--db-dir``, ``<tag>_latest.ckpt`` with
the optimizer state every epoch (``--resume`` restarts from it and the
shards), held-out rollouts over ``--eval-procgen`` scenes (seed offset
500, padded to common sizes) every ``--eval-every`` epochs for
``--eval-poses`` poses, selecting ``<tag>_best_auc.ckpt``; ``--max-wall``
stops at the first epoch boundary past that many seconds,
``--init-weights`` warm-starts a fresh run from a checkpoint's variables,
``--tag`` names the checkpoints and the log.

The defaults are the JAX CLI's (``weights/nbp``, ``training_log``,
``nbp_data/db``), which hold the committed checkpoint: point them
elsewhere for trial runs. Runs on the card unless ``--device cpu``; exits
2 when the card is asked for and absent. ``--quick`` shrinks the camera,
the buffers, the model input (64x64) and the U-Net (width 8) for smoke
runs.
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
    ap.add_argument("--scan", action="store_true",
                    help="the production trainer: device-resident "
                         "collection, bf16, held-out evaluation, resume")
    ap.add_argument("--eval-procgen", default=None,
                    help="held-out procgen eval scenes (--scan), same "
                         "syntax, seeds offset by 500")
    ap.add_argument("--db-dir", default="nbp_data/db",
                    help="replay shard directory (--scan)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint and the shards")
    ap.add_argument("--eval-every", type=int, default=3)
    ap.add_argument("--eval-poses", type=int, default=40)
    ap.add_argument("--max-wall", type=float, default=None,
                    help="stop after this many seconds (at an epoch "
                         "boundary); resume later with --resume")
    ap.add_argument("--init-weights", default=None,
                    help="warm-start variables from this checkpoint when "
                         "not resuming")
    ap.add_argument("--tag", default="nbp",
                    help="model tag of the checkpoint and log names (--scan)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quick", action="store_true",
                    help="small camera, buffers, model input and U-Net")
    args = ap.parse_args(argv)

    import torch

    from nextbestpath_tpu_torch.assets import (generate_scene, load_scene_dir,
                                               pack_generated_scene,
                                               pad_assets_to_common)
    from nextbestpath_tpu_torch.config import default_params, load_params
    from nextbestpath_tpu_torch.train.driver import (run_training_nbp,
                                                     run_training_nbp_scan,
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
    width = 8 if args.quick else 64
    if not args.scan:
        run_training_nbp(scenes, params=params, epochs=epochs, n_poses=poses,
                         db_path=args.db, weights_dir=args.weights_dir,
                         log_dir=args.log_dir, seed=args.seed, device=device,
                         model=seeded_train_model(args.seed, width=width))
        return 0
    eval_scenes = None
    if args.eval_procgen:
        eval_scenes = pad_assets_to_common([
            pack_generated_scene(generate_scene(diff, seed=s + 500),
                                 params=params)
            for diff, s in parse_procgen(args.eval_procgen, args.seed)])
    run_training_nbp_scan(
        pad_assets_to_common(scenes), eval_scenes=eval_scenes, params=params,
        epochs=epochs, n_poses=poses, db_dir=args.db_dir,
        weights_dir=args.weights_dir, log_dir=args.log_dir,
        model_tag=args.tag, seed=args.seed, resume=args.resume,
        eval_every=args.eval_every, eval_poses=args.eval_poses,
        max_wall_s=args.max_wall, init_from=args.init_weights, device=device,
        model=seeded_train_model(args.seed, width=width,
                                 dtype=torch.bfloat16))
    return 0


if __name__ == "__main__":
    sys.exit(main())
