#!/usr/bin/env python
"""Does online self-supervised depth learn? The photometric curve, the
depth error and the coverage it buys, with the PyTorch port: the
counterpart of ``tools/depth_quality_probe.py`` (the same flags, JSON keys
and printed lines).

Two runs of ``train/train_macarons.py::train_macarons_online`` on one
scene and seed:

1. perfect-depth mapping while ManyDepth trains online, its inferred depth
   against the rendered z-buffer logged every pose (``log_depth_error``);
2. the same trained depth weights driving the mapping
   (``use_perfect_depth=False``): the coverage against run 1's isolates
   what predicted depth costs the mapper.

``--depth-ckpt`` warm-starts ManyDepth from a depth checkpoint in the flax
layout (``pretrain_depth_torch.py`` writes one); ``--freeze-depth`` keeps
it as it is. The staged-unfreeze recipe: ``--unfreeze-after K`` poses
before the first online update, then ``--depth-lr``, ``--depth-clip``
(global-norm clip) and ``--reject-factor`` (roll an update back when its
photometric loss exceeds that factor times the median of the recent
accepted ones).

    python tools/depth_quality_probe_torch.py [--poses 60] [--device cuda|cpu]
    python tools/depth_quality_probe_torch.py --tiny --device cpu --poses 3

Runs on the card unless ``--device cpu``; exits 2 when the card is asked
for and absent. ``--tiny``: 32x56 frames and small buffers. The output
defaults to ``data/depth_quality_torch.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _mean(xs):
    return sum(xs) / max(len(xs), 1)


def main(argv=None, make_draws=None, state=None) -> dict:
    """Runs the probe and returns the dict it writes to ``--out``.
    make_draws(seed): the provider of each run's draws (default
    ``TorchDraws``; the tests inject the JAX key stream). state: the
    ``MacaronsTrainState`` to train (default one made from ``--seed`` with
    ``--depth-lr`` and ``--depth-clip``; the tests pass the JAX tool's
    weights)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--poses", type=int, default=60)
    ap.add_argument("--difficulty", default="simple")
    ap.add_argument("--seed", type=int, default=8)
    ap.add_argument("--tiny", action="store_true",
                    help="32x56 frames (CPU smoke)")
    ap.add_argument("--depth-ckpt", default=None,
                    help="warm-start depth variables (pretrain_depth "
                         "output) - the ImageNet-warm-start substitute")
    ap.add_argument("--freeze-depth", action="store_true",
                    help="skip the online photometric fine-tuning in both "
                         "phases: measures the --depth-ckpt weights as-is")
    ap.add_argument("--unfreeze-after", type=int, default=0,
                    help="poses before the first online depth update")
    ap.add_argument("--depth-lr", type=float, default=1e-4)
    ap.add_argument("--depth-clip", type=float, default=0.0,
                    help="global-norm gradient clip for online updates "
                         "(0 = off)")
    ap.add_argument("--reject-factor", type=float, default=0.0,
                    help="reject/rollback updates when the photometric "
                         "loss exceeds this factor x median of recent "
                         "accepted losses (0 = off)")
    ap.add_argument("--out", default="data/depth_quality_torch.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from nextbestpath_tpu_torch.assets import (generate_scene,
                                               pack_generated_scene)
    from nextbestpath_tpu_torch.config import default_params
    from nextbestpath_tpu_torch.eval import quality as Q
    from nextbestpath_tpu_torch.train.train_macarons import (
        MacaronsTrainState, train_macarons_online)

    device = Q.tool_device("depth_quality_probe_torch", args.device)
    if args.tiny:
        params = default_params(
            image_height=32, image_width=56, points_per_frame=256,
            full_pc_capacity=65536, n_gt_surface_points=2048,
            n_proxy_points=512)
    else:
        params = default_params(
            image_height=256, image_width=456, points_per_frame=4096,
            full_pc_capacity=1048576)
    assets = pack_generated_scene(
        generate_scene(args.difficulty, seed=args.seed), params=params)

    # Run 1: online depth learning under perfect-depth mapping, the
    # inferred depth against the z-buffer logged every pose.
    if state is None:
        state = MacaronsTrainState.create(args.seed, params=params,
                                          depth_lr=args.depth_lr,
                                          depth_clip=args.depth_clip,
                                          device=device)
    if args.depth_ckpt:
        from nextbestpath_tpu_torch.models.convert import manydepth_from_flax
        from nextbestpath_tpu_torch.models.macarons import module_vars
        from nextbestpath_tpu_torch.utils.checkpoint import load_checkpoint

        variables, _, at_step, extra = load_checkpoint(args.depth_ckpt)
        depth = state.model.depth
        depth.load_state_dict({k: v.to(device) for k, v in
                               manydepth_from_flax(variables).items()})
        state.model.depth_vars = module_vars(depth)
        print(f"# warm-started depth from {args.depth_ckpt} "
              f"(step {at_step}, {extra})", file=sys.stderr, flush=True)
    learn = not args.freeze_depth

    def run(perfect: bool):
        return train_macarons_online(
            assets, state, params=params, n_poses=args.poses, seed=args.seed,
            use_perfect_depth=perfect, learn_depth=learn,
            unfreeze_depth_after=args.unfreeze_after,
            depth_reject_factor=args.reject_factor, log_depth_error=True,
            verbose=True,
            draws=make_draws(args.seed) if make_draws is not None else None)

    logs = run(True)
    dl = logs["depth_loss"]
    de = logs["depth_abs_err"]
    k = max(3, len(dl) // 5)
    summary = {
        "poses": args.poses,
        "photometric_first": round(_mean(dl[:k]), 5),
        "photometric_last": round(_mean(dl[-k:]), 5),
        "depth_abs_err_first": round(_mean(de[:k]), 4),
        "depth_abs_err_last": round(_mean(de[-k:]), 4),
        "coverage_perfect_depth": round(logs["coverage"][-1], 4),
        # The mapping store takes the depth the mapper used: this is the
        # number that moves when predicted depth replaces the z-buffer.
        "store_coverage_perfect_depth": round(
            logs["store_coverage"][-1], 4),
        "unfreeze_after": args.unfreeze_after,
        "depth_lr": args.depth_lr,
        "depth_clip": args.depth_clip,
        "reject_factor": args.reject_factor,
        "rejected_updates": len(logs.get("depth_rejected_poses", [])),
    }
    print(f"# phase1: {summary}", file=sys.stderr, flush=True)

    # Run 2: the same trained depth weights drive the mapping.
    logs_pred = run(False)
    summary["coverage_predicted_depth"] = round(logs_pred["coverage"][-1], 4)
    summary["store_coverage_predicted_depth"] = round(
        logs_pred["store_coverage"][-1], 4)
    summary["depth_abs_err_predicted_run"] = round(
        _mean(logs_pred["depth_abs_err"][-k:]), 4)

    out = {"summary": summary,
           "photometric_curve": [round(x, 5) for x in dl],
           "depth_abs_err_curve": [round(x, 4) for x in de],
           "coverage_perfect": [round(x, 4) for x in logs["coverage"]],
           "coverage_predicted": [round(x, 4)
                                  for x in logs_pred["coverage"]],
           "store_coverage_perfect": [
               round(x, 4) for x in logs["store_coverage"]],
           "store_coverage_predicted": [
               round(x, 4) for x in logs_pred["store_coverage"]]}
    Q.write_json(args.out, out)
    print(json.dumps(summary))
    return out


if __name__ == "__main__":
    main()
