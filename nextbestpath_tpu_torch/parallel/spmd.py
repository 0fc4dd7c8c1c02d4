"""Rollouts and collection one scene a rank.

Port of ``nextbestpath_tpu/parallel/spmd.py``. The reference runs one
scene per GPU, each an independent process under DDP
(macarons_utils.py:177-326; DistributedSampler :279-293). The JAX package
shard_maps the single-scene scan over a mesh, one scene a device, with no
collective inside the rollout. Here rank r replays its own captured
single-scene graphs (``eval/scan_rollout.py::ScanRollout``,
``train/scan_collection.py::ScanCollection``) on scene r of the group,
padded to the group's common sizes, from seed ``seed + r``; no collective
runs inside a graph, and the host results meet in one object gather after
the run, in scene order, on every rank. A rank plans only when its own
scene regenerates, as the JAX per-device plan gate.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch.distributed as dist

from ..assets.scene_assets import SceneAssets
from ..config import Params, default_params
from ..eval.nbp_planning import RolloutResult
from ..eval.scan_rollout import (ScanRollout, common_sizes, pad_scene_arrays,
                                 scene_arrays_from_assets)
from ..models.unet import NBP
from ..train.replay import ReplayDB
from ..train.scan_collection import (CollectOut, ScanCollection,
                                     suffix_labels_from_out)
from .mesh import Mesh


def _one_scene_a_rank(what: str, n_scenes: int, mesh: Mesh) -> None:
    if n_scenes != mesh.size:
        raise ValueError(
            f"{what} needs exactly one scene a rank (got {n_scenes} scenes, "
            f"{mesh.size} ranks); run groups of {mesh.size} scenes or pad "
            "the list")


def gather(obj, mesh: Mesh) -> list:
    """Every rank's ``obj`` (a host object), in rank order, on every
    rank."""
    out = [None] * mesh.size
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


class ShardedScanRollout:
    """Evaluation rollouts, one scene a rank (JAX ``ShardedScanRollout``).

    ``assets_list`` has one scene a rank; rank r builds a ``ScanRollout``
    of scene r padded to the list's common triangle and GT sizes, on its
    device."""

    def __init__(self, assets_list: Sequence[SceneAssets], model: NBP,
                 mesh: Mesh, params: Optional[Params] = None,
                 fold_bn: bool = True):
        _one_scene_a_rank("ShardedScanRollout", len(assets_list), mesh)
        p = params or default_params()
        f_max, g_max = common_sizes(assets_list)
        assets = assets_list[mesh.rank]
        scene = pad_scene_arrays(scene_arrays_from_assets(
            assets, n_pieces=int(p.n_pieces), device=mesh.device),
            f_max, g_max)
        self.mesh = mesh
        self.n_scenes = len(assets_list)
        self.rollout = ScanRollout(assets, model, params=p, fold_bn=fold_bn,
                                   scene=scene, device=mesh.device)

    def run(self, n_poses: int = 101, seed: int = 8,
            variables: Optional[NBP] = None) -> List[RolloutResult]:
        """Scene i from seed + i (JAX ``spmd.py:129``); returns every
        scene's result on every rank. Each result's wall time is the
        slowest rank's, and its rate the aggregate ``n_scenes * n_poses /
        wall``, as the JAX results carry the one program's."""
        r = self.mesh.rank
        dist.barrier(group=self.mesh.group)
        res = self.rollout.run(n_poses=n_poses, seed=seed + r,
                               variables=variables)
        results = gather(res, self.mesh)
        wall = max(x.wall_time_s for x in results)
        for x in results:
            x.wall_time_s = wall
            x.steps_per_sec = self.n_scenes * n_poses / wall
        return results


class ShardedScanCollection:
    """Training-rollout collection, one scene a rank (JAX
    ``ShardedScanCollection``): every rank holds a ``ScanCollection`` of
    the whole group (padded to its common sizes) and runs scene r; the
    records are gathered in scene order and every rank appends every
    scene's suffix-labelled experiences, so that every rank's replay store
    is the same."""

    def __init__(self, assets_list: Sequence[SceneAssets], model: NBP,
                 mesh: Mesh, params: Optional[Params] = None, **kwargs):
        _one_scene_a_rank("ShardedScanCollection", len(assets_list), mesh)
        self.mesh = mesh
        self.n_scenes = len(assets_list)
        self._col = ScanCollection(assets_list, model, params=params,
                                   device=mesh.device, **kwargs)
        self.p = self._col.p
        self.wall_time_s = 0.0

    def run_all(self, variables: Optional[NBP], seeds: Sequence[int],
                n_poses: int = 100) -> CollectOut:
        """Scene r on rank r from ``seeds[r]``; returns every scene's
        records stacked on a leading scene axis, on every rank.
        ``wall_time_s``: the barrier to the gather's end."""
        if len(seeds) != self.n_scenes:
            raise ValueError(f"{len(seeds)} seeds for {self.n_scenes} scenes")
        r = self.mesh.rank
        dist.barrier(group=self.mesh.group)
        t0 = time.perf_counter()
        out = self._col.run(r, variables, seed=seeds[r], n_poses=n_poses)
        outs = gather(out, self.mesh)
        self.wall_time_s = time.perf_counter() - t0
        return CollectOut(*[np.stack(f) for f in zip(*outs)])

    def collect_all(self, variables: Optional[NBP], db: ReplayDB,
                    seed: int = 0, n_poses: int = 100) -> List[List[float]]:
        """Collect every scene (scene i from seed + i) and append the
        suffix-labelled experiences to ``db`` scene by scene. Returns each
        scene's coverage of its valid poses and of the pose where it
        stopped."""
        p = self.p
        out = self.run_all(variables, [seed + i for i in range(self.n_scenes)],
                           n_poses=n_poses)
        coverages = []
        for s in range(self.n_scenes):
            one = CollectOut(*[f[s] for f in out])
            for pose_i, pixels, gains in suffix_labels_from_out(
                    one, int(p.value_map_size[0]), tuple(p.prediction_range)):
                db.append(np.transpose(one.model_input[pose_i], (2, 0, 1)),
                          one.gt_obs[pose_i], pixels, gains, pose_i)
            n_valid = int(np.sum(one.valid))
            coverages.append([float(c) for c in
                              one.coverage[:max(n_valid + 1, 1)]])
        return coverages
