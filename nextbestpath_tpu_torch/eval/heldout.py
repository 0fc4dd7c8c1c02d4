"""Shared held-out evaluation scene recipe.

Port of ``nextbestpath_tpu/eval/heldout.py`` over the port's assets: the
one recipe of held-out procgen seeds, so that every tool that scores
held-out scenes (the random-walk baseline table, the checkpoint promotion
gate, the trainer's periodic eval) scores the same ones.

The seeds are disjoint from training (the trainer's procgen recipe uses
base 8 without the +500 offset).
"""

from __future__ import annotations

from typing import Sequence

DIFFICULTIES = ("simple", "normal", "hard", "insane")


def held_out_seed(difficulty_index: int, scene_index: int) -> int:
    """Held-out procgen seed: the training recipe's base shifted by +500."""
    return 8 + difficulty_index * 37 + scene_index + 500


def held_out_assets(params, scenes_per_diff: int = 2,
                    difficulties: Sequence[str] = DIFFICULTIES,
                    pad: bool = True, scene_offset: int = 0):
    """Packed held-out scenes for the given difficulties (training-disjoint).

    Difficulty indices are always taken from the FULL difficulty list, so a
    filtered run (e.g. only "hard") still evaluates the same scenes as the
    4-difficulty table.

    scene_offset shifts the per-difficulty scene index: the trainer's
    periodic AUC-selection eval uses scene j=0 of each difficulty, so a
    promotion gate that must be uncontaminated by checkpoint selection
    passes scene_offset >= 1 to score scenes the selection never saw.
    """
    from ..assets import generate_scene, pack_generated_scene
    from ..assets.scene_assets import pad_assets_to_common

    assets = []
    for i, diff in enumerate(DIFFICULTIES):
        if diff not in difficulties:
            continue
        for j in range(scene_offset, scene_offset + scenes_per_diff):
            assets.append(pack_generated_scene(
                generate_scene(diff, seed=held_out_seed(i, j)),
                params=params))
    return pad_assets_to_common(assets) if pad else assets
