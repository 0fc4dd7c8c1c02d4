#!/usr/bin/env python
"""Reference-protocol evaluation with the PyTorch port, 101 poses a
rollout, one batch a difficulty: the counterpart of ``tools/eval101_all.py``
(the same flags, merged JSON and table).

Runs ``tools/eval_vs_random_r2_torch.py`` once a difficulty (4 held-out
scenes x 3 seeds by default), each in its own process, so that each batch
keeps its own lattice (no padding of every scene to the ``insane``
lattice) and its own device memory, then merges the per-difficulty JSONs
(written beside ``--out``) into ``--out`` with the combined table. A
difficulty whose process fails is recorded as FAILED. Each process loads
the kernel library that the first one built (``nextbestpath_tpu_torch/
_build/``, named by a hash of the sources).

    python tools/eval101_all_torch.py [--device cuda|cpu] [--dtype bfloat16] \\
        [--weights 'weights/nbp/nbp_{level}_best_auc.ckpt']

``--weights`` is one checkpoint, or a pattern with ``{level}``; a level
whose file is missing falls back to the ``nbp_best_val.ckpt`` beside the
pattern (``weights/nbp/nbp_best_val.ckpt`` for the JAX tool's patterns).
Each level's wall time goes to stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

DIFFS = ("simple", "normal", "hard", "insane")


def level_weights(pattern: str, diff: str) -> str:
    """The checkpoint of one level: the pattern's file when it exists
    (as given, or under the repo), else the nbp_best_val.ckpt beside it."""
    w = pattern.format(level=diff)
    if os.path.exists(w):
        return os.path.abspath(w)
    if os.path.exists(os.path.join(REPO, w)):
        return w
    fallback = os.path.join(os.path.dirname(pattern), "nbp_best_val.ckpt")
    print(f"# {w} missing -> {fallback}", file=sys.stderr, flush=True)
    return os.path.abspath(fallback) if os.path.exists(fallback) else fallback


def main(argv=None) -> dict:
    """Runs every level and returns the merged dict it writes to --out."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--poses", type=int, default=101)
    ap.add_argument("--scenes-per-diff", type=int, default=4)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--weights", default="weights/nbp/nbp_best_val.ckpt",
                    help="single checkpoint, or a per-difficulty pattern "
                         "with {level} (e.g. "
                         "'weights/nbp/nbp_{level}_best_auc.ckpt' - the "
                         "reference's per-level weight files); levels whose "
                         "file is missing fall back to the nbp_best_val.ckpt "
                         "beside the pattern")
    ap.add_argument("--out", default="data/eval_vs_random_r3_101_torch.json")
    ap.add_argument("--difficulties", default=",".join(DIFFS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    args = ap.parse_args(argv)
    diffs = [d.strip() for d in args.difficulties.split(",") if d.strip()]

    from nextbestpath_tpu_torch.eval import quality as Q

    Q.tool_device("eval101_all_torch", args.device)
    merged = {"poses": args.poses, "scenes_per_diff": args.scenes_per_diff,
              "seeds": args.seeds, "per_scene": {}, "per_difficulty": {}}
    part_dir = os.path.dirname(os.path.abspath(args.out))
    for diff in diffs:
        part = os.path.join(part_dir, f"eval101_{diff}_torch.json")
        if os.path.exists(part):
            os.remove(part)
        cmd = [sys.executable,
               os.path.join(REPO, "tools", "eval_vs_random_r2_torch.py"),
               "--poses", str(args.poses),
               "--scenes-per-diff", str(args.scenes_per_diff),
               "--seeds", str(args.seeds),
               "--weights", level_weights(args.weights, diff),
               "--difficulties", diff, "--out", part,
               "--device", args.device, "--dtype", args.dtype]
        print(f"# running {diff} ...", file=sys.stderr, flush=True)
        t0 = time.perf_counter()
        rc = subprocess.run(cmd, cwd=REPO).returncode
        print(f"# {diff}: {time.perf_counter() - t0:.1f} s wall, rc {rc}",
              file=sys.stderr, flush=True)
        if rc != 0:
            print(f"# {diff} FAILED rc={rc}", file=sys.stderr, flush=True)
            continue
        with open(part) as f:
            d = json.load(f)
        merged["per_scene"].update(d["per_scene"])
        merged["per_difficulty"].update(d["per_difficulty"])
        merged["weights_epoch"] = d.get("weights_epoch")

    Q.write_json(args.out, merged)
    print("\n" + Q.markdown_table(merged["per_difficulty"], diffs))
    return merged


if __name__ == "__main__":
    main()
