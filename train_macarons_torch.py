#!/usr/bin/env python
"""MACARONS online training CLI of the PyTorch port, the counterpart of
``train_macarons.py`` (same flags, the same checkpoints).

    python train_macarons_torch.py --procgen simple --poses 20
    python train_macarons_torch.py --procgen simple --poses 12 \\
        --learn-depth --predicted-depth --memory-dir "$TMPDIR/macarons_mem" \\
        --replay-loops 1   (the full online stack: photometric depth,
        predicted-depth mapping, memory persistence and SCONE replay)
    python train_macarons_torch.py --device cpu --tiny --poses 2 \\
        --out "$TMPDIR/macarons_w"

Scenes: ``--scene-dirs`` (reference-format scene directories), else one
procgen scene a difficulty of ``--procgen`` (seeds ``--seed``,
``--seed`` + 1, ...). Each scene runs one trajectory of ``--poses`` poses
(``train/train_macarons.py::train_macarons_online``) with seeded models
at the published widths; ``scone_occ.ckpt`` and ``scone_vis.ckpt`` go to
``--out`` in the flax layout (the JAX package reads them). ``--epoch``
selects the memory's trajectory slot (replay serves only the other
slots). Runs on the card unless ``--device cpu``; exits 2 when the card
is asked for and absent. ``--tiny`` runs 32x56 frames and small buffers.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procgen", default="simple")
    ap.add_argument("--scene-dirs", default=None)
    ap.add_argument("--poses", type=int, default=100)
    ap.add_argument("--seed", type=int, default=8)
    ap.add_argument("--out", default="weights/macarons")
    ap.add_argument("--learn-depth", action="store_true",
                    help="online self-supervised ManyDepth training")
    ap.add_argument("--predicted-depth", action="store_true",
                    help="backproject through the predicted depth instead "
                         "of the rendered zbuf (use_perfect_depth=False)")
    ap.add_argument("--memory-dir", default=None,
                    help="persist frames/depths/snapshots per scene here "
                         "and enable scone memory replay")
    ap.add_argument("--replay-loops", type=int, default=1,
                    help="scone replay steps per pose (with --memory-dir)")
    ap.add_argument("--epoch", type=int, default=0,
                    help="trajectory epoch (selects the Memory slot; replay "
                         "serves only OTHER trajectories)")
    ap.add_argument("--tiny", action="store_true",
                    help="32x56 frames + small buffers (CPU smoke drives)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from nextbestpath_tpu_torch.device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        print(f"train_macarons_torch: {err}", file=sys.stderr)
        return 2

    from nextbestpath_tpu_torch.assets import (generate_scene, load_scene_dir,
                                               pack_generated_scene)
    from nextbestpath_tpu_torch.config import default_params
    from nextbestpath_tpu_torch.models.convert import (scone_occ_to_flax,
                                                       scone_vis_to_flax)
    from nextbestpath_tpu_torch.sim.memory import Memory
    from nextbestpath_tpu_torch.train.train_macarons import (
        TINY, MacaronsTrainState, train_macarons_online)
    from nextbestpath_tpu_torch.utils.checkpoint import save_checkpoint

    params = default_params(**TINY) if args.tiny else default_params()
    if args.scene_dirs:
        scenes = [load_scene_dir(d, params=params)
                  for d in args.scene_dirs.split(",")]
    else:
        scenes = [pack_generated_scene(generate_scene(d.strip(),
                                                      seed=args.seed + i),
                                       params=params)
                  for i, d in enumerate(args.procgen.split(","))]

    state = MacaronsTrainState.create(args.seed, params=params, device=device)
    memory = None
    mem_paths = []
    if args.memory_dir:
        mem_paths = [os.path.join(args.memory_dir, a.name) for a in scenes]
        memory = Memory(mem_paths, n_trajectories=5, current_epoch=args.epoch)
    for i, assets in enumerate(scenes):
        logs = train_macarons_online(
            assets, state, params=params, n_poses=args.poses, seed=args.seed,
            use_perfect_depth=not args.predicted_depth,
            learn_depth=args.learn_depth, memory=memory,
            scene_memory_path=mem_paths[i] if memory else None,
            memory_replay_loops=args.replay_loops if memory else 0)
        msg = (f"{assets.name}: final coverage {logs['coverage'][-1]:.4f} "
               f"occ loss {logs['occ_loss'][-1]:.4f}")
        if logs["depth_loss"]:
            msg += f" depth loss {logs['depth_loss'][-1]:.4f}"
        if logs["replay_occ_loss"]:
            msg += (f" replay occ {logs['replay_occ_loss'][-1]:.4f}"
                    f" ({len(logs['replay_occ_loss'])} steps)")
        if logs["replay_cov_loss"]:
            msg += f" replay cov {logs['replay_cov_loss'][-1]:.4f}"
        if logs["replay_depth_loss"]:
            msg += (f" replay depth {logs['replay_depth_loss'][-1]:.4f}"
                    f" ({len(logs['replay_depth_loss'])} steps)")
        print(msg, flush=True)
    save_checkpoint(os.path.join(args.out, "scone_occ.ckpt"),
                    {"params": scone_occ_to_flax(state.model.occ_vars)})
    save_checkpoint(os.path.join(args.out, "scone_vis.ckpt"),
                    {"params": scone_vis_to_flax(state.model.vis_vars)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
