#!/usr/bin/env python
"""Why a pretrained depth checkpoint's pretraining error and its online
error differ, with the PyTorch port: the counterpart of
``tools/probe_depth_eval_gap.py`` (the same flags and printed lines).

Evaluates a depth checkpoint (``train/pretrain_depth.py::make_eval_fn``:
mean |depth - z-buffer| over the hit pixels) on walklet batches of one
scene (``_sample_walk``: three poses a sample, two samples a batch),
rendered once with the scene's face colours and once without, over
several pose draws. Procgen scenes paint every face one grey, so the two
renders, and their errors, are equal: textures are no factor, and the
gap between errors is pose and scene variance.

    python tools/probe_depth_eval_gap_torch.py \\
        --ckpt weights/depth_pre/depth_pre_best.ckpt [--device cuda|cpu]

Trial t's walks come from seed 1234 + t. Runs on the card unless
``--device cpu``; exits 2 when the card is asked for and absent. The
JAX tool writes no file; this one also writes its trials to ``--out``
(default ``data/depth_eval_gap_torch.json``).
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BATCH = 2
TRIAL_SEED = 1234


def main(argv=None, make_draws=None) -> dict:
    """Runs the probe and returns the dict it writes to ``--out``.
    make_draws(seed): the provider of a trial's walklets (default
    ``TorchDraws``; the tests inject the JAX keys)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default="weights/depth_pre/depth_pre_best.ckpt")
    ap.add_argument("--difficulty", default="simple")
    ap.add_argument("--seed", type=int, default=708)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--out", default="data/depth_eval_gap_torch.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from nextbestpath_tpu_torch.assets import (generate_scene,
                                               pack_generated_scene)
    from nextbestpath_tpu_torch.config import default_params
    from nextbestpath_tpu_torch.draws import TorchDraws
    from nextbestpath_tpu_torch.eval import quality as Q
    from nextbestpath_tpu_torch.geometry.cameras import CameraIntrinsics
    from nextbestpath_tpu_torch.models.convert import manydepth_from_flax
    from nextbestpath_tpu_torch.models.manydepth import ManyDepth
    from nextbestpath_tpu_torch.sim.sensor import capture_rgbd
    from nextbestpath_tpu_torch.train.pretrain_depth import (
        _sample_walk, depth_scene_from_assets, make_eval_fn)
    from nextbestpath_tpu_torch.utils.checkpoint import load_checkpoint

    device = Q.tool_device("probe_depth_eval_gap_torch", args.device)
    p = default_params()
    H, W = int(p.image_height), int(p.image_width)
    assets = pack_generated_scene(
        generate_scene(args.difficulty, seed=args.seed), params=p)
    scene = depth_scene_from_assets(assets, device)
    intr = CameraIntrinsics(image_height=H, image_width=W,
                            fov_degrees=float(p.fov_degrees),
                            znear=float(p.camera_znear), zfar=float(p.zfar))
    variables, _, step, extra = load_checkpoint(args.ckpt)
    model = ManyDepth(intr=intr,
                      learn_pose="pose_decoder" in variables["params"])
    model.load_state_dict(manydepth_from_flax(variables), strict=True)
    model = model.to(device).eval()
    print(f"# loaded {args.ckpt} (step {step}, {extra})", flush=True)
    evaluate = make_eval_fn(model)
    tc = torch.from_numpy(assets.tri_colors).to(device)

    def build(walks, textured):
        cols = [[] for _ in range(7)]
        for poses in walks:
            frames = [capture_rgbd(scene.tri_soa, scene.n_tris, pose, intr,
                                   tri_colors=tc if textured else None)
                      for pose in poses]
            (r0, _, R0, T0), (r1, _, R1, T1), (r2, z2, R2, T2) = frames
            for col, v in zip(cols, (r2, R2, T2, torch.stack([r1, r0]),
                                     torch.stack([R1, R0]),
                                     torch.stack([T1, T0]), z2)):
                col.append(v)
        return tuple(torch.stack(col) for col in cols)

    trials = []
    for trial in range(args.trials):
        seed = TRIAL_SEED + trial
        draws = (make_draws(seed) if make_draws is not None
                 else TorchDraws(seed, device))
        # One set of walklets renders both ways, as the JAX tool's two
        # builds from one key.
        walks = [_sample_walk(scene, draws, assets.n_azim, 3, step=b)
                 for b in range(BATCH)]
        plain = float(evaluate(*build(walks, False)))
        tex = float(evaluate(*build(walks, True)))
        print(f"trial {trial}: plain err {plain:.4f}  textured err "
              f"{tex:.4f}", flush=True)
        trials.append({"trial": trial, "plain_err": plain,
                       "textured_err": tex})
    out = {"ckpt": args.ckpt, "step": int(step), "extra": extra,
           "difficulty": args.difficulty, "seed": args.seed,
           "trials": trials}
    Q.write_json(args.out, out)
    return out


if __name__ == "__main__":
    main()
