"""What the policy-quality tools (``tools/*_torch.py``) share: the device
they were asked for, a policy read from a checkpoint, NBP against the
random walk on held-out scenes, and the per-difficulty table.

The tools are the port's counterparts of the JAX package's ``tools/``
quality workflow (the held-out NBP-vs-random table, the 101-pose reference
protocol, the promotion gate, the per-level fine-tune); their JSON keys
and markdown tables are the JAX tools', built here once.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .heldout import DIFFICULTIES

# Rollout seed of seed block s, as every JAX quality tool draws them.
SEED_BASE, SEED_STEP = 1000, 97

Results = Dict[str, Dict[str, List[float]]]


def block_seed(s: int) -> int:
    return SEED_BASE + SEED_STEP * s


def tool_device(tool: str, device: str) -> torch.device:
    """The device a tool was asked for; exits 2 (with the reason on
    stderr) when that is the card and there is none, rather than carrying
    on on the CPU."""
    try:
        return resolve_device(device)
    except RuntimeError as err:
        print(f"{tool}: {err}", file=sys.stderr)
        raise SystemExit(2) from err


def load_policy(path: str, dtype: str, device) -> Tuple[torch.nn.Module, int]:
    """(an unfolded NBP computing in ``dtype`` on ``device`` with the
    checkpoint's weights, its epoch). A missing file raises: a tool never
    scores random weights in place of the ones it was given."""
    from ..models import unet
    from ..utils.checkpoint import load_nbp

    model = unet.NBP(dtype=getattr(torch, dtype))
    epoch, _ = load_nbp(path, model)
    return model.to(device), int(epoch)


def difficulty_of(name: str) -> str:
    for d in DIFFICULTIES:
        if f"_{d}_" in name:
            return d
    raise ValueError(name)


def names_of(assets, diff: str) -> List[str]:
    return [a.name for a in assets if f"_{diff}_" in a.name]


def nbp_vs_random(nbp, walk, n_poses: int, seeds: int) -> Results:
    """Per scene, the AUCs and final coverages of ``seeds`` seed blocks of
    the NBP rollout (a ``BatchedScanRollout``) and the random walk (a
    ``ScanRandomWalk``) over the same scenes; block s runs scene i from
    ``block_seed(s) + i``. The batch's ms a pose goes to stderr."""
    results = {a.name: {"nbp_auc": [], "rw_auc": [], "nbp_final": [],
                        "rw_final": []} for a in nbp.assets_list}
    for s in range(seeds):
        for who, roll in (("nbp", nbp), ("rw", walk)):
            res = roll.run(n_poses=n_poses, seed=block_seed(s))
            print(f"# {'NBP' if who == 'nbp' else 'random-walk'} rollouts, "
                  f"seed block {s}: {len(res)} scenes x {n_poses} poses, "
                  f"{res[0].wall_time_s:.3f} s, "
                  f"{1e3 * res[0].wall_time_s / n_poses:.3f} ms a pose of "
                  f"the batch", file=sys.stderr, flush=True)
            for a, r in zip(nbp.assets_list, res):
                results[a.name][f"{who}_auc"].append(r.auc)
                results[a.name][f"{who}_final"].append(
                    r.coverage_evolution[-1])
    return results


def difficulty_row(results: Results, names: Sequence[str],
                   who: str = "nbp") -> Dict[str, object]:
    """A difficulty's row: the mean over its scenes of each scene's mean
    over seeds, rounded to 4 places; ``{who}_wins`` from the unrounded
    AUCs."""
    def mean(key):
        return float(np.mean([np.mean(results[n][key]) for n in names]))

    mine, rw = mean(f"{who}_auc"), mean("rw_auc")
    return {f"{who}_auc": round(mine, 4), "rw_auc": round(rw, 4),
            f"{who}_final": round(mean(f"{who}_final"), 4),
            "rw_final": round(mean("rw_final"), 4),
            f"{who}_wins": bool(mine > rw)}


def markdown_table(table: Mapping[str, Optional[Mapping]],
                   diffs: Sequence[str], who: str = "nbp") -> str:
    """The JAX tools' table; a difficulty without a row reads FAILED."""
    w = who.upper()
    lines = [f"| difficulty | {w} AUC | random AUC | {w} final | rw final "
             f"| {w} wins |", "|---|---|---|---|---|---|"]
    for diff in diffs:
        t = table.get(diff)
        if not t:
            lines.append(f"| {diff} | FAILED | | | | |")
            continue
        lines.append(f"| {diff} | {t[f'{who}_auc']} | {t['rw_auc']} | "
                     f"{t[f'{who}_final']} | {t['rw_final']} | "
                     f"{'YES' if t[f'{who}_wins'] else 'no'} |")
    return "\n".join(lines)


def write_json(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)
