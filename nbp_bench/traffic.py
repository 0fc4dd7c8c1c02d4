"""The general generator: what a mix file asks for, made from the seed.

A mix of kind ``rollouts`` (the random walk's) names a procgen level,
the scenes' procgen seeds, the poses of a rollout, the warm-up's poses,
the poses the checks judge and a pool of ``draw_pool`` rollouts. Every run rolls
the same scenes out, the same pool of rollouts cycle after cycle, back
to back: one client that waits for each pose. A scene's draws in a
rollout of the pool are the same in every run; the run's seed orders the
scenes in the batch and the rollouts in a cycle. So every seed does the
same work in another order.

A mix of kind ``train_steps`` gives the staged dataset's rows, the
micro batch, the micro steps an optimizer step, the image side and the
most labelled pixels a row; the seed makes the rows and orders them.
"""

from __future__ import annotations

import random
from typing import Dict, List


def scene_order(mix: Dict, seed: int) -> List[int]:
    """The indices of the mix's scenes in this run's batch order."""
    order = list(range(len(mix["scene_seeds"])))
    random.Random(int(seed)).shuffle(order)
    return order


def scene_assets(mix: Dict, seed: int, params):
    """The run's scenes as the program packs them, padded to one lattice
    and triangle buffer. Each raw scene (triangles, GT points, lattice)
    is the input both the program and the reference read."""
    from nextbestpath_tpu_torch.assets import (generate_scene,
                                               pack_generated_scene)
    from nextbestpath_tpu_torch.assets.scene_assets import \
        pad_assets_to_common

    assets = [pack_generated_scene(generate_scene(
        mix["level"], seed=mix["scene_seeds"][i]), params=params)
        for i in scene_order(mix, seed)]
    return pad_assets_to_common(assets)


WARMUP = -1


def pool_order(mix: Dict, seed: int) -> List[int]:
    """The pool's rollouts in this run's cycle order."""
    order = list(range(int(mix["draw_pool"])))
    random.Random(int(seed) + 1).shuffle(order)
    return order


def rollout_seed(k: int) -> int:
    """The seed the program's rollout is run with for rollout k of the
    pool (WARMUP: the warm-up); its scene at batch position i asks the
    provider for this plus i."""
    return 1_000_003 * (k + 2)


def draw_seed(k: int, scene: int) -> int:
    """The draws' seed of scene ``scene`` (its index in the mix) in
    rollout k of the pool: the same wherever the scene sits."""
    return 7919 * (k + 2) + 104_729 * (scene + 1)


def dataset(mix: Dict, seed: int, device):
    """The staged training rows, made on the device from the seed in the
    layout the trainer stages a collection in: x (N, S, S, 5) f16 (the
    height-binned point counts and the trajectory's), layout (N, S, S) u8,
    pixels (N, P, 3) int64 (rotation, row, column of the value map),
    gains and pweights (N, P) f32, a random count of labelled pixels a
    row, at least one."""
    import torch

    from . import weights
    from .weights import draw_seed

    n, s, p = int(mix["rows"]), int(mix["side"]), int(mix["max_pixels"])
    vm = s // 4
    gen = torch.Generator(device=device)
    gen.manual_seed(draw_seed(seed, 2))

    def u(*shape):
        return torch.rand(shape, generator=gen, device=device)

    x = weights.model_inputs(n, s, 5, seed, 4, device,
                             occupied=float(mix["occupied_share"]))
    n_lab = 1 + torch.floor(u(n) * p).long()
    pix = torch.stack([torch.floor(u(n, p) * 8), torch.floor(u(n, p) * vm),
                       torch.floor(u(n, p) * vm)], -1).long()
    return {"x": x.to(torch.float16),
            "layout": (u(n, s, s) < float(mix["obstacle_share"])).to(
                torch.uint8),
            "pixels": pix, "gains": u(n, p),
            "pweights": (torch.arange(p, device=device)[None, :]
                         < n_lab[:, None]).to(torch.float32)}
