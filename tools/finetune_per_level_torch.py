#!/usr/bin/env python
"""Per-level NBP fine-tuning in one process with the PyTorch port: the
counterpart of ``tools/finetune_per_level.py`` (the same flags, JSON and
table, plus the paths below).

The reference ships one weight file a difficulty; this tool warm-starts a
per-level fine-tune from the shared policy (``--init``) for each level with
the scan trainer (``train/driver.py::run_training_nbp_scan``), saving
``nbp_<level>_best_val.ckpt`` and ``nbp_<level>_best_auc.ckpt`` into
``--weights-dir``, then scores each level's checkpoint (the AUC-selected
one when present) against the random walk on that level's held-out
scenes. Every level's scenes are padded to one common shape up front, as
the JAX tool does for its one compile.

    python tools/finetune_per_level_torch.py --epochs 6 [--device cuda|cpu] \\
        [--weights-dir "$TMPDIR/nbp_ft"] [--log-dir "$TMPDIR/nbp_ft_log"] \\
        [--db-root "$TMPDIR/nbp_ft_db"]

The final table scores the scenes that checkpoint selection saw; the
unbiased verdict is ``tools/compare_ckpts_torch.py --scene-offset 1``.
Runs on the card unless ``--device cpu``; exits 2 when the card is asked
for and absent. The defaults of ``--weights-dir`` and ``--log-dir`` are the
trainer's (``weights/nbp``, ``training_log``).
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DIFFS = ("simple", "normal", "hard", "insane")
# Poses of the trainer's held-out evaluations and of the final table.
EVAL_POSES = 40


def main(argv=None) -> dict:
    """Fine-tunes and scores every level; returns the dict it writes to
    ``--out``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--levels", default=",".join(DIFFS))
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--poses", type=int, default=100)
    ap.add_argument("--scenes-per-level", type=int, default=2)
    ap.add_argument("--init", default="weights/nbp/nbp_best_val.ckpt")
    ap.add_argument("--eval-every", type=int, default=3)
    ap.add_argument("--max-wall", type=float, default=None,
                    help="per-level wall budget (seconds)")
    ap.add_argument("--eval-scenes-per-level", type=int, default=2)
    ap.add_argument("--eval-seeds", type=int, default=2)
    ap.add_argument("--out", default="data/eval_vs_random_ft_torch.json")
    ap.add_argument("--weights-dir", default="weights/nbp")
    ap.add_argument("--log-dir", default="training_log")
    ap.add_argument("--db-root", default="nbp_data",
                    help="each level's replay shards go to "
                         "<db-root>/db_ft_<level>")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"),
                    help="the final table's U-Net")
    args = ap.parse_args(argv)
    levels = [lv.strip() for lv in args.levels.split(",") if lv.strip()]

    from nextbestpath_tpu_torch.assets import (generate_scene,
                                               pack_generated_scene)
    from nextbestpath_tpu_torch.assets.scene_assets import pad_assets_to_common
    from nextbestpath_tpu_torch.config import default_params
    from nextbestpath_tpu_torch.eval import quality as Q
    from nextbestpath_tpu_torch.eval.heldout import held_out_seed
    from nextbestpath_tpu_torch.eval.random_walk import ScanRandomWalk
    from nextbestpath_tpu_torch.eval.scan_rollout import BatchedScanRollout
    from nextbestpath_tpu_torch.train.driver import run_training_nbp_scan

    device = Q.tool_device("finetune_per_level_torch", args.device)
    params = default_params()
    # train_nbp's procgen seeds 8 + i * 37 + j; the held-out ones +500.
    ordered = [d for d in DIFFS if d in levels]
    train_sets, eval_sets, everything = {}, {}, []
    for i, diff in enumerate(DIFFS):
        if diff not in levels:
            continue
        tr = [pack_generated_scene(generate_scene(diff, seed=8 + i * 37 + j),
                                   params=params)
              for j in range(args.scenes_per_level)]
        ev = [pack_generated_scene(generate_scene(diff,
                                                  seed=held_out_seed(i, j)),
                                   params=params)
              for j in range(args.eval_scenes_per_level)]
        train_sets[diff], eval_sets[diff] = tr, ev
        everything.extend(tr + ev)
    it = iter(pad_assets_to_common(everything))
    for diff in ordered:
        train_sets[diff] = [next(it) for _ in train_sets[diff]]
        eval_sets[diff] = [next(it) for _ in eval_sets[diff]]

    for diff in ordered:
        print(f"=== fine-tune {diff} ===", flush=True)
        run_training_nbp_scan(
            train_sets[diff], eval_scenes=eval_sets[diff], params=params,
            epochs=args.epochs, n_poses=args.poses,
            db_dir=os.path.join(args.db_root, f"db_ft_{diff}"),
            weights_dir=args.weights_dir, log_dir=args.log_dir,
            model_tag=f"nbp_{diff}", seed=8, resume=False,
            eval_every=args.eval_every, eval_poses=EVAL_POSES,
            max_wall_s=args.max_wall, init_from=args.init, device=device)

    # Each level's checkpoint against the random walk on its held-out
    # scenes; the rollout-AUC-selected checkpoint when there is one.
    table = {}
    for diff in ordered:
        w = os.path.join(args.weights_dir, f"nbp_{diff}_best_auc.ckpt")
        if not os.path.exists(w):
            w = os.path.join(args.weights_dir, f"nbp_{diff}_best_val.ckpt")
        model, ep = Q.load_policy(w, args.dtype, device)
        results = Q.nbp_vs_random(
            BatchedScanRollout(eval_sets[diff], model, params=params,
                               device=device),
            ScanRandomWalk(eval_sets[diff], params=params, device=device),
            EVAL_POSES, args.eval_seeds)
        table[diff] = dict(Q.difficulty_row(results, list(results)),
                           weights_epoch=ep)
        print(f"{diff}: NBP {table[diff]['nbp_auc']} vs "
              f"random {table[diff]['rw_auc']} "
              f"({'WIN' if table[diff]['nbp_wins'] else 'loss'})", flush=True)

    out = {"per_difficulty": table}
    Q.write_json(args.out, out)
    print(Q.markdown_table(table, ordered))
    return out


if __name__ == "__main__":
    main()
