#!/usr/bin/env python
"""The ceiling of the MACARONS greedy NBV harness with the PyTorch port:
the counterpart of ``tools/probe_nbv_oracle.py`` (the same flags, JSON
keys and table).

Runs ``eval/macarons_nbv.py::macarons_nbv_rollout`` with ``oracle=True``
(the ground-truth coverage gain of each candidate, no learned model) on
the held-out scenes and seeds of ``tools/macarons_e2e_torch.py``, beside
the random walk (``ScanRandomWalk``), seed block s from 1000 + 97 s. If
the oracle loses to the walk, the greedy harness (the candidate set and
its one-step lookahead) is the limit and no SCONE training can win; if it
wins, the gap to the learned NBV is the models' headroom.

    python tools/probe_nbv_oracle_torch.py [--eval-poses 100] \\
        [--difficulties simple] [--device cuda|cpu]

Runs on the card unless ``--device cpu``; exits 2 when the card is asked
for and absent. The output defaults to ``data/nbv_oracle_torch.json``.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None, make_draws=None, make_walk_draws=None) -> dict:
    """Runs the probe and returns the dict it writes to ``--out``.
    make_draws / make_walk_draws: seed -> the provider of an oracle
    rollout's / a walk's draws (default ``TorchDraws``; the tests inject
    the JAX key streams)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--eval-poses", type=int, default=100)
    ap.add_argument("--eval-scenes-per-diff", type=int, default=2)
    ap.add_argument("--eval-seeds", type=int, default=2)
    ap.add_argument("--difficulties", default="simple")
    ap.add_argument("--out", default="data/nbv_oracle_torch.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    diffs = tuple(d.strip() for d in args.difficulties.split(",") if d.strip())

    from nextbestpath_tpu_torch.config import default_params
    from nextbestpath_tpu_torch.eval import quality as Q
    from nextbestpath_tpu_torch.eval.heldout import held_out_assets
    from nextbestpath_tpu_torch.eval.macarons_nbv import macarons_nbv_rollout
    from nextbestpath_tpu_torch.eval.random_walk import ScanRandomWalk

    device = Q.tool_device("probe_nbv_oracle_torch", args.device)
    params = default_params()
    eval_assets = held_out_assets(params,
                                  scenes_per_diff=args.eval_scenes_per_diff,
                                  difficulties=diffs)
    rw = ScanRandomWalk(eval_assets, params=params,
                        make_draws=make_walk_draws, device=device)
    table = {a.name: {"oracle_auc": [], "oracle_final": [], "rw_auc": [],
                      "rw_final": []} for a in eval_assets}
    for s in range(args.eval_seeds):
        seed = Q.block_seed(s)
        for a in eval_assets:
            res = macarons_nbv_rollout(
                a, None, None, params=params, n_poses=args.eval_poses,
                seed=seed, oracle=True, verbose=True,
                draws=make_draws(seed) if make_draws is not None else None,
                device=device)
            table[a.name]["oracle_auc"].append(res.auc)
            table[a.name]["oracle_final"].append(res.coverage_evolution[-1])
            print(f"# oracle {a.name} seed{s}: final "
                  f"{res.coverage_evolution[-1]:.4f} auc {res.auc:.4f}",
                  file=sys.stderr, flush=True)
        for a, r in zip(eval_assets, rw.run(n_poses=args.eval_poses,
                                            seed=seed)):
            table[a.name]["rw_auc"].append(r.auc)
            table[a.name]["rw_final"].append(r.coverage_evolution[-1])

    per_diff = {}
    for diff in diffs:
        row = Q.difficulty_row(table, Q.names_of(eval_assets, diff), "oracle")
        # The JAX tool decides on the rounded means.
        row["oracle_wins"] = bool(row["oracle_auc"] > row["rw_auc"])
        per_diff[diff] = row

    out = {"eval_poses": args.eval_poses, "per_scene": table,
           "per_difficulty": per_diff}
    Q.write_json(args.out, out)
    print("\n| difficulty | oracle AUC | random AUC | oracle final | rw final |")
    print("|---|---|---|---|---|")
    for diff in diffs:
        t = per_diff[diff]
        print(f"| {diff} | {t['oracle_auc']} | {t['rw_auc']} "
              f"| {t['oracle_final']} | {t['rw_final']} |")
    return out


if __name__ == "__main__":
    main()
