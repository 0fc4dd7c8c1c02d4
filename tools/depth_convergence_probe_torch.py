#!/usr/bin/env python
"""Can the ManyDepth pipeline learn depth at all? Many gradient steps on
one short window of frames, with the PyTorch port: the counterpart of
``tools/depth_convergence_probe.py`` (the same flags, JSON keys and
printed lines).

The online trainer takes one depth step a pose, which from a random
initialisation barely moves the depth error. This probe runs the regime
in which the reference's depth module is expected to converge: hundreds
of optimizer steps over a short captured window. It captures M RGB-D
frames (``sim/sensor.py::capture_rgbd``) along a straight unobstructed
lattice walk that bounces at its first blocked edge (``--object``: an arc
around a procedural blob object, whose curved shading gives the
photometric loss texture), then runs ``--steps`` depth steps
(``train/train_macarons.py::make_depth_steps``) on random target frames t
with the reference's alphas [t-1, t-2, t+1]. Every ``--eval-every`` steps
it infers the held-out frame M-2 (never a target) and logs the mean
|predicted - rendered depth| over the pixels valid in both.

    python tools/depth_convergence_probe_torch.py [--object] [--steps 500] \\
        [--device cuda|cpu]
    python tools/depth_convergence_probe_torch.py --tiny --device cpu \\
        --steps 4 --eval-every 2

Runs on the card unless ``--device cpu``; exits 2 when the card is asked
for and absent. ``--tiny``: 32x56 frames. The output defaults to
``data/depth_convergence_torch.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None, make_draws=None, state=None) -> dict:
    """Runs the probe and returns the dict it writes to ``--out``.
    make_draws(seed): the provider of the depth steps' augmentation draws
    in the sequential schedule, one ``depth`` group a step (default
    ``TorchDraws``; seed ``--seed`` + 1). state: the
    ``MacaronsTrainState`` to train (default one made from ``--seed``;
    the tests pass the JAX tool's weights)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--eval-every", type=int, default=25)
    ap.add_argument("--difficulty", default="simple")
    ap.add_argument("--seed", type=int, default=8)
    ap.add_argument("--tiny", action="store_true",
                    help="32x56 frames (CPU smoke)")
    ap.add_argument("--object", action="store_true",
                    help="orbit a procedural blob object instead of walking "
                    "a scene: curved Lambert-shaded geometry gives the "
                    "photometric loss real texture to match, isolating "
                    "'can the pipeline learn depth' from the flat-gray "
                    "scene shading (the reference's AiMDoom texture is "
                    "flat gray too, load_scene_with_texture)")
    ap.add_argument("--out", default="data/depth_convergence_torch.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from nextbestpath_tpu_torch.assets import (generate_scene,
                                               pack_generated_scene)
    from nextbestpath_tpu_torch.config import default_params
    from nextbestpath_tpu_torch.draws import TorchDraws
    from nextbestpath_tpu_torch.eval import quality as Q
    from nextbestpath_tpu_torch.geometry.cameras import CameraIntrinsics
    from nextbestpath_tpu_torch.ops.raytrace import (segments_hit_mesh,
                                                     tris_to_soa)
    from nextbestpath_tpu_torch.planning.grid_paths import (DIRS,
                                                            lattice_positions)
    from nextbestpath_tpu_torch.sim.sensor import capture_rgbd
    from nextbestpath_tpu_torch.train.train_macarons import (
        AUG_SHAPES, MacaronsTrainState, make_depth_steps)

    dev = Q.tool_device("depth_convergence_probe_torch", args.device)
    if args.tiny:
        params = default_params(image_height=32, image_width=56)
    else:
        params = default_params(image_height=256, image_width=456)
    intr = CameraIntrinsics(
        image_height=int(params.image_height),
        image_width=int(params.image_width),
        fov_degrees=float(params.fov_degrees),
        znear=float(params.camera_znear), zfar=float(params.zfar))
    ambient = float(params.get("ambient_light_intensity", 0.85))

    def f32(values):
        return torch.tensor(np.asarray(values, np.float32), device=dev)

    if args.object:
        from nextbestpath_tpu_torch.assets.objects import generate_object

        obj = generate_object(args.seed)
        tri_soa = tris_to_soa(torch.from_numpy(obj.tris).to(dev))
        n_tris = torch.tensor([obj.n_tris], dtype=torch.int32, device=dev)
        tri_colors = None
        # An arc of small azimuth steps at a fixed elevation, the camera on
        # a sphere looking at the blob's centre: frames that overlap with
        # real parallax and curved shading.
        radius, elev = 2.5, 20.0
        center = np.zeros(3, np.float32)
        poses = []
        for i in range(args.frames):
            azim = 8.0 * i
            e, a = np.deg2rad(elev), np.deg2rad(azim)
            pos = center + radius * np.asarray(
                [np.cos(e) * np.sin(a), np.sin(e), np.cos(e) * np.cos(a)],
                np.float32)
            poses.append(f32([*pos, -elev, (azim + 180.0) % 360.0]))
    else:
        assets = pack_generated_scene(
            generate_scene(args.difficulty, seed=args.seed), params=params)
        tri_soa = tris_to_soa(torch.from_numpy(assets.tris).to(dev))
        n_tris = torch.tensor([assets.n_tris], dtype=torch.int32, device=dev)
        tri_colors = torch.from_numpy(assets.tri_colors).to(dev)
        positions = lattice_positions(
            torch.from_numpy(assets.pose_origin).to(dev), assets.pose_l,
            assets.pose_h).cpu().numpy()

        # A straight unobstructed walk from the start cell at a fixed
        # azimuth (consecutive frames share most of their frustum),
        # bouncing at its first blocked edge.
        l, h = int(assets.start_cam_idx[0]), int(assets.start_cam_idx[2])
        rot = int(assets.start_cam_idx[4])
        best_dir, best_run = None, -1
        for (dl, dh) in DIRS:
            run, cl, ch = 0, l, h
            while run < args.frames:
                nl, nh = cl + dl, ch + dh
                if not (0 <= nl < assets.pose_l and 0 <= nh < assets.pose_h):
                    break
                if bool(segments_hit_mesh(f32(positions[cl, ch])[None],
                                          f32(positions[nl, nh])[None],
                                          tri_soa, n_tris)[0]):
                    break
                run, cl, ch = run + 1, nl, nh
            if run > best_run:
                best_dir, best_run = (dl, dh), run
        dl, dh = best_dir
        cells, cl, ch, step_sign = [(l, h)], l, h, 1
        for _ in range(args.frames - 1):
            nl, nh = cl + step_sign * dl, ch + step_sign * dh
            if (len(cells) - 1) % max(best_run, 1) == 0 and len(cells) > 1:
                step_sign = -step_sign  # bounce at the end of the clear run
                nl, nh = cl + step_sign * dl, ch + step_sign * dh
            cl, ch = nl, nh
            cells.append((cl, ch))
        print(f"# walk dir={best_dir} clear_run={best_run} cells={cells}",
              file=sys.stderr, flush=True)
        elev = float(assets.elevations_deg[2])
        azim = float(assets.azimuths_deg[rot])
        poses = [f32([*positions[cl, ch], elev, azim]) for (cl, ch) in cells]

    frames = [capture_rgbd(tri_soa, n_tris, pose, intr,
                           tri_colors=tri_colors, ambient=ambient)
              for pose in poses]

    if state is None:
        state = MacaronsTrainState.create(args.seed, params=params,
                                          device=dev)
    depth_step, depth_infer = make_depth_steps(state.model, state.depth_tx,
                                               intr, params)
    dv, dopt = state.model.depth_vars, state.depth_opt_state

    M = len(frames)
    hold = M - 2  # the held-out target (never a training target)

    def eval_err(dv):
        rgb, zbuf, R, T = frames[hold]
        x_a = torch.stack([frames[hold - 1][0], frames[hold - 2][0]])
        R_a = torch.stack([frames[hold - 1][2], frames[hold - 2][2]])
        T_a = torch.stack([frames[hold - 1][3], frames[hold - 2][3]])
        pred = depth_infer(dv, rgb, R, T, x_a, R_a, T_a)
        valid = (pred > 0) & (zbuf > 0)
        return float(torch.sum(torch.abs(pred - zbuf) * valid)
                     / torch.clamp(torch.sum(valid), min=1))

    rng = np.random.default_rng(args.seed)
    draws = (make_draws or (lambda s: TorchDraws(s, dev)))(args.seed + 1)
    photo_curve, err_curve = [], [(0, eval_err(dv))]
    print(f"# step 0: heldout abs err {err_curve[0][1]:.4f}",
          file=sys.stderr, flush=True)
    for step in range(1, args.steps + 1):
        t = int(rng.integers(2, M - 2))
        if t == hold:
            t -= 1
        tgt = frames[t]
        x_a = torch.stack([frames[t - 1][0], frames[t - 2][0],
                           frames[t + 1][0]])
        R_a = torch.stack([frames[t - 1][2], frames[t - 2][2],
                           frames[t + 1][2]])
        T_a = torch.stack([frames[t - 1][3], frames[t - 2][3],
                           frames[t + 1][3]])
        draws.begin_group("depth")
        aug = draws.uniforms("depth", AUG_SHAPES)
        dv, dopt, photo, _ = depth_step(dv, dopt, tgt[0], tgt[2], tgt[3],
                                        x_a, R_a, T_a, aug)
        photo_curve.append(float(photo))
        if step % args.eval_every == 0:
            err_curve.append((step, eval_err(dv)))
            print(f"# step {step}: photo {photo_curve[-1]:.5f} "
                  f"heldout abs err {err_curve[-1][1]:.4f}",
                  file=sys.stderr, flush=True)

    k = max(3, len(photo_curve) // 10)
    summary = {
        "steps": args.steps, "frames": M,
        "mode": "object" if args.object else f"scene:{args.difficulty}",
        "photometric_first": round(sum(photo_curve[:k]) / k, 5),
        "photometric_last": round(sum(photo_curve[-k:]) / k, 5),
        "heldout_abs_err_first": round(err_curve[0][1], 4),
        "heldout_abs_err_last": round(err_curve[-1][1], 4),
        "heldout_abs_err_best": round(min(e for _, e in err_curve), 4),
    }
    out = {"summary": summary,
           "photometric_curve": [round(x, 5) for x in photo_curve],
           "heldout_abs_err": [[s, round(e, 4)] for s, e in err_curve]}
    Q.write_json(args.out, out)
    print(json.dumps(summary))
    return out


if __name__ == "__main__":
    main()
