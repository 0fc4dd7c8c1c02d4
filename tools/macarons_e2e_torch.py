#!/usr/bin/env python
"""MACARONS end-to-end quality table with the PyTorch port, online
training then NBV against the random walk: the counterpart of
``tools/macarons_e2e.py`` (the same flags, JSON and table).

Trains the MACARONS stack online with perfect depth
(``train/train_macarons.py::train_macarons_online``) on training-seed
procgen scenes, then scores the trained SconeOcc / SconeVis greedy NBV
(``eval/macarons_nbv.py``) against the random walk (``ScanRandomWalk``)
on held-out scenes (``eval/heldout.py``), seed block s from 1000 + 97 s.

    python tools/macarons_e2e_torch.py --train-scenes 2 --train-poses 100 \\
        --eval-poses 100 --difficulties simple [--device cuda|cpu]
    python tools/macarons_e2e_torch.py --tiny --device cpu \\
        --train-poses 3 --eval-poses 3 --save "$TMPDIR/macarons_e2e"

``--occ-ckpt`` / ``--vis-ckpt`` warm-start the SCONE models from
checkpoints in the flax layout; the trained ones go to ``--save`` (the
default ``weights/macarons`` is the trainer's; point trials elsewhere).
Runs on the card unless ``--device cpu``; exits 2 when the card is asked
for and absent. ``--tiny``: 32x56 frames and small buffers.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> dict:
    """Trains, scores, and returns the dict it writes to ``--out``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--train-scenes", type=int, default=2)
    ap.add_argument("--train-poses", type=int, default=100)
    ap.add_argument("--eval-poses", type=int, default=100)
    ap.add_argument("--eval-scenes-per-diff", type=int, default=2)
    ap.add_argument("--eval-seeds", type=int, default=2)
    ap.add_argument("--difficulties", default="simple")
    ap.add_argument("--seed", type=int, default=8)
    ap.add_argument("--occ-ckpt", default=None,
                    help="warm-start SconeOcc from this checkpoint")
    ap.add_argument("--vis-ckpt", default=None)
    ap.add_argument("--save", default="weights/macarons",
                    help="save trained scone weights here")
    ap.add_argument("--out", default="data/macarons_e2e_torch.json")
    ap.add_argument("--tiny", action="store_true",
                    help="32x56 frames (CPU smoke)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    diffs = tuple(d.strip() for d in args.difficulties.split(",") if d.strip())

    import numpy as np

    from nextbestpath_tpu_torch.assets import (generate_scene,
                                               pack_generated_scene)
    from nextbestpath_tpu_torch.config import default_params
    from nextbestpath_tpu_torch.eval import quality as Q
    from nextbestpath_tpu_torch.eval.heldout import held_out_assets
    from nextbestpath_tpu_torch.eval.macarons_nbv import macarons_nbv_rollout
    from nextbestpath_tpu_torch.eval.random_walk import ScanRandomWalk
    from nextbestpath_tpu_torch.models.convert import (scone_occ_from_flax,
                                                       scone_occ_to_flax,
                                                       scone_vis_from_flax,
                                                       scone_vis_to_flax)
    from nextbestpath_tpu_torch.models.macarons import module_vars
    from nextbestpath_tpu_torch.train.train_macarons import (
        TINY, MacaronsTrainState, train_macarons_online)
    from nextbestpath_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                         save_checkpoint)

    device = Q.tool_device("macarons_e2e_torch", args.device)
    params = default_params(**TINY) if args.tiny else default_params()

    # -- Phase 1: online training (perfect depth), training-seed scenes ----
    state = MacaronsTrainState.create(args.seed, params=params, device=device)
    model = state.model
    for which, path, from_flax in (("occ", args.occ_ckpt, scone_occ_from_flax),
                                   ("vis", args.vis_ckpt, scone_vis_from_flax)):
        if path and os.path.exists(path):
            module = getattr(model, f"scone_{which}")
            module.load_state_dict(from_flax(load_checkpoint(path)[0]))
            setattr(model, f"{which}_vars", module_vars(module))
            print(f"# warm-started {which} from {path}", file=sys.stderr)

    train_logs = {}
    for i in range(args.train_scenes):
        for j, diff in enumerate(diffs):
            assets = pack_generated_scene(
                generate_scene(diff, seed=args.seed + j * 37 + i),
                params=params)
            logs = train_macarons_online(
                assets, state, params=params, n_poses=args.train_poses,
                seed=args.seed + i, use_perfect_depth=True, verbose=True)
            def mean(values):
                return round(float(np.mean(values)), 4)

            train_logs[assets.name] = {
                "final_coverage": round(logs["coverage"][-1], 4),
                "occ_loss_first": mean(logs["occ_loss"][:5]),
                "occ_loss_last": mean(logs["occ_loss"][-5:]),
                "cov_loss_first": mean(logs["cov_loss"][:5]),
                "cov_loss_last": mean(logs["cov_loss"][-5:]),
            }
            print(f"# trained on {assets.name}: {train_logs[assets.name]}",
                  file=sys.stderr, flush=True)
    if args.save:
        save_checkpoint(os.path.join(args.save, "scone_occ.ckpt"),
                        {"params": scone_occ_to_flax(model.occ_vars)})
        save_checkpoint(os.path.join(args.save, "scone_vis.ckpt"),
                        {"params": scone_vis_to_flax(model.vis_vars)})

    # -- Phase 2: held-out NBV vs random walk ------------------------------
    # The trainer replaces the variables; the NBV rollout runs the modules.
    model.scone_occ.load_state_dict(model.occ_vars)
    model.scone_vis.load_state_dict(model.vis_vars)
    eval_assets = held_out_assets(params,
                                  scenes_per_diff=args.eval_scenes_per_diff,
                                  difficulties=diffs)
    rw = ScanRandomWalk(eval_assets, params=params, device=device)
    table = {a.name: {"nbv_auc": [], "rw_auc": [], "nbv_final": [],
                      "rw_final": []} for a in eval_assets}
    for s in range(args.eval_seeds):
        for a in eval_assets:
            res = macarons_nbv_rollout(
                a, model.scone_occ, model.scone_vis, params=params,
                n_poses=args.eval_poses, seed=Q.block_seed(s), device=device)
            table[a.name]["nbv_auc"].append(res.auc)
            table[a.name]["nbv_final"].append(res.coverage_evolution[-1])
            print(f"# nbv {a.name} seed{s}: final "
                  f"{res.coverage_evolution[-1]:.4f} auc {res.auc:.4f}",
                  file=sys.stderr, flush=True)
        for a, r in zip(eval_assets, rw.run(n_poses=args.eval_poses,
                                            seed=Q.block_seed(s))):
            table[a.name]["rw_auc"].append(r.auc)
            table[a.name]["rw_final"].append(r.coverage_evolution[-1])

    per_diff = {}
    for diff in diffs:
        row = Q.difficulty_row(table, Q.names_of(eval_assets, diff), "nbv")
        # The JAX tool decides on the rounded means here.
        row["nbv_wins"] = bool(row["nbv_auc"] > row["rw_auc"])
        per_diff[diff] = row

    out = {"train_poses": args.train_poses, "eval_poses": args.eval_poses,
           "train": train_logs, "per_scene": table, "per_difficulty": per_diff}
    Q.write_json(args.out, out)
    print("\n" + Q.markdown_table(per_diff, diffs, "nbv"))
    return out


if __name__ == "__main__":
    main()
