#!/usr/bin/env python
"""Offline depth-network pretraining CLI of the PyTorch port, the
counterpart of ``pretrain_depth.py`` (same flags, the same checkpoints).

    python pretrain_depth_torch.py --steps 3000 --procgen simple:4,normal:2,hard:2
    python pretrain_depth_torch.py --device cpu --tiny --steps 3 \\
        --out "$TMPDIR/depth_pre" --log-dir "$TMPDIR/depth_log"

Trains ManyDepth supervised against rendered zbuf over the ``--procgen``
scenes (``train/pretrain_depth.py::pretrain_depth``), evaluating on a held-
out scene of ``--eval-difficulty`` (seed ``--seed`` + 700), and writes
``depth_pre_best.ckpt`` and ``depth_pre_latest.ckpt`` to ``--out`` in the
flax layout (``train_macarons.py --depth-ckpt`` of either package reads
them) and ``depth_pre_loss.json`` to ``--log-dir``. ``--resume`` starts
from such a checkpoint. Runs on the card unless ``--device cpu``; exits 2
when the card is asked for and absent. ``--tiny`` runs 64x114 frames.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

TINY = dict(image_height=64, image_width=114, points_per_frame=256,
            full_pc_capacity=16384, n_gt_surface_points=1024)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procgen", default="simple:4,normal:2,hard:2",
                    help="training scenes: difficulty[:count] comma list")
    ap.add_argument("--eval-difficulty", default="simple")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=8)
    ap.add_argument("--out", default="weights/depth_pre")
    ap.add_argument("--log-dir", default="training_log")
    ap.add_argument("--eval-every", type=int, default=100)
    ap.add_argument("--resume", default=None,
                    help="warm-start the depth variables from this checkpoint")
    ap.add_argument("--max-wall", type=float, default=None)
    ap.add_argument("--tiny", action="store_true",
                    help="64x114 frames (CPU smoke)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from nextbestpath_tpu_torch.device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        print(f"pretrain_depth_torch: {err}", file=sys.stderr)
        return 2

    from nextbestpath_tpu_torch.assets import (generate_scene,
                                               pack_generated_scene)
    from nextbestpath_tpu_torch.config import default_params
    from nextbestpath_tpu_torch.train.pretrain_depth import pretrain_depth
    from train_nbp_torch import parse_procgen

    params = default_params(**TINY) if args.tiny else default_params()
    h, w = int(params.image_height), int(params.image_width)
    scenes = [pack_generated_scene(generate_scene(diff, seed=s), params=params)
              for diff, s in parse_procgen(args.procgen, args.seed)]
    # The held-out scene: +700, apart from training (base 8) and from the
    # NBP held-out scenes (+500).
    eval_scene = pack_generated_scene(
        generate_scene(args.eval_difficulty, seed=args.seed + 700),
        params=params)
    _, best = pretrain_depth(
        scenes, eval_scene, steps=args.steps, batch=args.batch, lr=args.lr,
        seed=args.seed, out_dir=args.out, log_dir=args.log_dir,
        eval_every=args.eval_every, image_height=h, image_width=w,
        params=params, resume=args.resume, max_wall_s=args.max_wall,
        device=device)
    print(f"done; best held-out mean|depth-zbuf| = {best:.4f} "
          f"(weights in {args.out})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
