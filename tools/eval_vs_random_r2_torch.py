#!/usr/bin/env python
"""Held-out NBP-vs-random-walk comparison across the difficulty levels,
with the PyTorch port: the counterpart of ``tools/eval_vs_random_r2.py``
(the same flags, JSON keys and table).

Coverage AUC of a trained NBP policy against the random-walk baseline on
held-out procgen scenes (``eval/heldout.py``: seeds disjoint from
training) at simple/normal/hard/insane. The policy runs as one
``BatchedScanRollout`` over every scene, the baseline as one
``ScanRandomWalk``; seed block s rolls scene i out from 1000 + 97 s + i.

    python tools/eval_vs_random_r2_torch.py [--poses 40] \\
        [--weights weights/nbp/nbp_best_val.ckpt] [--dtype bfloat16] \\
        [--device cuda|cpu] [--out data/eval_vs_random_r2_torch.json]

Runs on the card unless ``--device cpu``; exits 2 when the card is asked
for and absent. The U-Net computes in ``--dtype`` (bf16 by default, as the
JAX tool's ``NBP(dtype=bfloat16)``). A missing checkpoint is an error.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DIFFS = ("simple", "normal", "hard", "insane")


def main(argv=None, make_draws=None, make_walk_draws=None) -> dict:
    """Runs the table and returns the dict it writes to ``--out``.
    make_draws / make_walk_draws: seed -> the provider of an NBP / a
    random-walk rollout's draws (default ``TorchDraws``; the tests inject
    the JAX key schedules)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--poses", type=int, default=40)
    ap.add_argument("--scenes-per-diff", type=int, default=2)
    ap.add_argument("--seeds", type=int, default=2,
                    help="rollout seeds per scene (AUCs are averaged)")
    ap.add_argument("--weights", default="weights/nbp/nbp_best_val.ckpt")
    ap.add_argument("--out", default="data/eval_vs_random_r2_torch.json")
    ap.add_argument("--difficulties", default=",".join(DIFFS),
                    help="comma list (per-level fine-tune evals)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    args = ap.parse_args(argv)
    diffs = tuple(d.strip() for d in args.difficulties.split(",") if d.strip())

    from nextbestpath_tpu_torch.config import default_params
    from nextbestpath_tpu_torch.eval import quality as Q
    from nextbestpath_tpu_torch.eval.heldout import held_out_assets
    from nextbestpath_tpu_torch.eval.random_walk import ScanRandomWalk
    from nextbestpath_tpu_torch.eval.scan_rollout import BatchedScanRollout

    device = Q.tool_device("eval_vs_random_r2_torch", args.device)
    params = default_params()
    # The shared held-out recipe: the promotion gate's scenes too.
    assets = held_out_assets(params, scenes_per_diff=args.scenes_per_diff,
                             difficulties=diffs)
    model, epoch = Q.load_policy(args.weights, args.dtype, device)
    print(f"# weights {args.weights} (epoch {epoch})", file=sys.stderr,
          flush=True)

    nbp = BatchedScanRollout(assets, model, params=params,
                             make_draws=make_draws, device=device)
    walk = ScanRandomWalk(assets, params=params, make_draws=make_walk_draws,
                          device=device)
    results = Q.nbp_vs_random(nbp, walk, args.poses, args.seeds)
    if device.type == "cuda":
        from nextbestpath_tpu_torch import kernels

        print(f"# kernels: {kernels.BUILD_INFO.get('path')} compiled="
              f"{kernels.BUILD_INFO.get('compiled')}, launches "
              f"{kernels.LAUNCHES}", file=sys.stderr, flush=True)
    table = {diff: Q.difficulty_row(results, Q.names_of(assets, diff))
             for diff in diffs}
    out = {"poses": args.poses, "weights_epoch": epoch,
           "per_scene": results, "per_difficulty": table}
    Q.write_json(args.out, out)
    print("\n" + Q.markdown_table(table, diffs))
    return out


if __name__ == "__main__":
    main()
