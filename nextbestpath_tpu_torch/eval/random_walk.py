"""Random-walk exploration baseline on PyTorch.

Port of ``nextbestpath_tpu/eval/random_walk.py::random_walk_rollout``, the
baseline set beside the NBP evaluation: each pose the agent moves to a
uniformly random neighbour whose lattice edge the scene's GT collision
table leaves open, with a uniformly random rotation, under the same mapping
and coverage harness as the legacy host rollout (K2 once for the scene's
tables, K3 for the metric a pose, K1 for the moves' frames).

Draws: the capture and the metric take the sequential schedule of
``draws.py`` (one group for the initial capture, then a pose's ``cov`` and
``move``) and the metric's argsort sampler; the moves come from numpy's
``default_rng(seed)``, which both packages draw identically.
``ScanRandomWalk``, the batched device-resident variant, is not ported.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from ..assets.scene_assets import SceneAssets
from ..config import Params, default_params
from ..device import DeviceLike, resolve_device
from ..draws import TorchDraws
from ..geometry.cameras import CameraIntrinsics
from ..ops.coverage import compute_auc, coverage_percentage_exact
from ..ops.raytrace import tris_to_soa
from ..planning.grid_paths import DIRS
from ..sim.rollout import TrajectoryBuffer, move_and_capture
from ..sim.sensor import PointBuffer
from ..sim.tables import build_scene_tables
from .nbp_planning import RolloutResult


@torch.inference_mode()
def random_walk_rollout(assets: SceneAssets, params: Optional[Params] = None,
                        n_poses: int = 200, seed: int = 8, draws=None,
                        verbose: bool = False,
                        device: DeviceLike = "cuda") -> RolloutResult:
    """n_poses random-walk poses from the scene's start. draws: a provider
    in the sequential schedule (default: TorchDraws from ``seed`` on the
    device). device: "cuda" unless the caller asks for the CPU."""
    dev = resolve_device(device)
    p = params or default_params()
    draws = draws if draws is not None else TorchDraws(seed, dev)
    intr = CameraIntrinsics(
        image_height=int(p.image_height), image_width=int(p.image_width),
        fov_degrees=float(p.fov_degrees), znear=float(p.camera_znear),
        zfar=float(p.zfar))
    n_px = intr.image_height * intr.image_width
    n_steps = int(p.n_interpolation_steps)
    tri_soa = tris_to_soa(torch.from_numpy(assets.tris).to(dev))
    n_tris = torch.tensor([assets.n_tris], dtype=torch.int32, device=dev)
    gt = torch.from_numpy(assets.gt_surface).to(dev)
    n_azim = assets.n_azim
    tables = build_scene_tables(tri_soa, n_tris,
                                torch.from_numpy(assets.pose_origin).to(dev),
                                assets.pose_l, assets.pose_h)
    blocked = tables.gt_edge_blocked.cpu().numpy()
    positions = tables.positions.cpu().numpy()
    capture_kw = dict(n_steps=n_steps, n_azim=n_azim,
                      n_slots=int(p.points_per_frame),
                      gathering_factor=float(p.gathering_factor),
                      sensor_range=float(p.sensor_range))

    def pose5(idx):
        i_l, i_h, rot = idx
        pos = positions[i_l, i_h]
        return torch.tensor(np.asarray(
            [pos[0], pos[1], pos[2], assets.elevations_deg[2],
             assets.azimuths_deg[rot]], np.float32), device=dev)

    def frames(role):
        draws.begin_group(role)
        return [draws.uniform(role, (n_px,), step=s)
                for s in range(1, n_steps + 1)]

    pc = PointBuffer.create(int(p.full_pc_capacity), dev)
    traj = TrajectoryBuffer.create(8 * (n_poses + 4), dev)
    start = assets.start_cam_idx
    cur = (int(start[0]), int(start[2]), int(start[4]))

    t1 = time.time()
    pose0 = pose5(cur)
    move_and_capture(tri_soa, n_tris, pose0, pose0, pc, traj,
                     frames("init"), intr, **capture_kw)

    rng = np.random.default_rng(seed)
    coverage_evolution: List[float] = []
    for pose_i in range(n_poses):
        draws.begin_group("cov")
        cov = float(coverage_percentage_exact(
            gt, pc.points, pc.count, draws.uniform("cov", (pc.capacity,))))
        coverage_evolution.append(cov)
        if verbose and pose_i % 20 == 0:
            print(f"rw pose {pose_i}: coverage {cov:.4f}")

        # Random unblocked neighbour move + random rotation.
        open_dirs = [d for d, _ in enumerate(DIRS)
                     if not blocked[d, cur[0], cur[1]]]
        if open_dirs:
            d = int(rng.choice(open_dirs))
            dl, dh = DIRS[d]
            nxt = (cur[0] + dl, cur[1] + dh, int(rng.integers(n_azim)))
        else:
            nxt = (cur[0], cur[1], int(rng.integers(n_azim)))

        move_and_capture(tri_soa, n_tris, pose5(cur), pose5(nxt), pc, traj,
                         frames("move"), intr, **capture_kw)
        cur = nxt

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t1
    return RolloutResult(
        coverage_evolution=coverage_evolution,
        auc=compute_auc(coverage_evolution),
        cam_positions=traj.xyz[:int(traj.count)].cpu().numpy(),
        wall_time_s=wall,
        n_points=int(pc.count),
        steps_per_sec=n_poses / wall)
