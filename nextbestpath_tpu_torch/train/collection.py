"""Training rollout collection.

Port of ``nextbestpath_tpu/train/collection.py``: on one scene, roll the
agent with Boltzmann exploration over the U-Net's candidate values, follow
ground-truth-edge paths, and mine *path-suffix* labels: every later pose
on the executed path becomes a (value-map pixel, coverage gain) target of
every earlier state. Experiences go to a ``ReplayDB``.

Per pose: the coverage metric (argsort sampler, kernel K3), the loop-start
frame (K1), the model input and the GT layout (``ops.obstacle_map``); when
the path is used up, the U-Net's value map (eval mode: its running
statistics do not move), the training scores, the GT-edge distance field
(P1), the Boltzmann-sampled first candidate with score-descending
fallbacks, the path (P2) and its orientations; then the move's four frames
(K1), with the reference's random rotation override (p = 0.6). The scene
tables are cast once with K2.

Draws come in the sequential schedule of ``draws.py``, one group for each
``next_key()`` of the JAX function, in its order: ``init`` (the initial
capture); then each pose ``cov`` and ``obs``; when a path is planned
``goal`` (the Boltzmann pick's Gumbel noise) and ``plan`` (the
orientations); then ``rot`` (the override's uniform) and, when it is
taken, ``rot`` again (its randint); then ``move``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..assets.scene_assets import SceneAssets
from ..config import Params, default_params
from ..device import DeviceLike, resolve_device
from ..draws import TorchDraws
from ..eval.nbp_planning import build_model_input
from ..geometry.cameras import CameraIntrinsics
from ..models.unet import NBP
from ..ops.coverage import coverage_percentage_exact
from ..ops.obstacle_map import gt_obstacle_map
from ..ops.raytrace import tris_to_soa
from ..ops.scatter2d import height_bins
from ..planning.candidates import boltzmann_first, score_candidates_train
from ..planning.grid_paths import (INF, bfs_distance_field, extract_path,
                                   pick_orientations)
from ..sim.rollout import TrajectoryBuffer, move_and_capture, observe_current
from ..sim.sensor import PointBuffer
from ..sim.tables import build_scene_tables
from .replay import ReplayDB


def _suffix_labels(experiences: List[dict], value_map_size: int,
                   grid_range: Tuple[float, float]):
    """Path-suffix label mining on host values.

    experiences[i] = dict(coverage, model_input, gt_obs, cam_pose5 (np
    (5,) f32), rot (int)). For every pair i < j: pose j's position in pose
    i's egocentric value-map frame; if inside, pixel (rot_j, row, col) with
    gain max(0, (cov_j - cov_i) * 100). Rounding is Python's ``round`` on
    the f32 coordinates, half to even, as in the JAX package.
    """
    out = []
    lo, hi = grid_range
    scale = value_map_size / (hi - lo)
    for i, ex in enumerate(experiences):
        pixels, gains = [], []
        cam = ex["cam_pose5"]
        for j in range(i + 1, len(experiences)):
            nxt = experiences[j]
            dx = nxt["cam_pose5"][0] - cam[0]
            dz = nxt["cam_pose5"][2] - cam[2]
            row = int(round((-dz - lo) * scale))
            col = int(round((-dx - lo) * scale))
            if 0 <= row < value_map_size and 0 <= col < value_map_size:
                gain = (nxt["coverage"] - ex["coverage"]) * 100.0
                pixels.append((int(nxt["rot"]), row, col))
                gains.append(max(gain, 0.0))
        if pixels:
            out.append((ex, np.asarray(pixels, np.int32),
                        np.asarray(gains, np.float32)))
    return out


def collect_trajectory(assets: SceneAssets, nbp_model: NBP, db: ReplayDB,
                       params: Optional[Params] = None, seed: int = 0,
                       n_poses: int = 100, verbose: bool = False,
                       draws=None, device: DeviceLike = "cuda"
                       ) -> List[float]:
    """One training rollout on one scene; experiences appended to ``db``.
    Returns the coverage evolution. draws: a provider in the sequential
    schedule (default: TorchDraws from ``seed`` on the device). The model
    runs in eval mode and is put back in the mode it came in."""
    dev = resolve_device(device)
    p = params or default_params()
    draws = draws if draws is not None else TorchDraws(seed, dev)
    intr = CameraIntrinsics(
        image_height=int(p.image_height), image_width=int(p.image_width),
        fov_degrees=float(p.fov_degrees), znear=float(p.camera_znear),
        zfar=float(p.zfar))
    n_px = intr.image_height * intr.image_width
    n_steps = int(p.n_interpolation_steps)
    capture_kw = dict(n_slots=int(p.points_per_frame),
                      gathering_factor=float(p.gathering_factor),
                      sensor_range=float(p.sensor_range))
    tris = torch.from_numpy(assets.tris).to(dev)
    tri_soa = tris_to_soa(tris)
    n_tris = torch.tensor([assets.n_tris], dtype=torch.int32, device=dev)
    gt = torch.from_numpy(assets.gt_surface).to(dev)
    L, H, n_azim = assets.pose_l, assets.pose_h, assets.n_azim
    tables = build_scene_tables(tri_soa, n_tris,
                                torch.from_numpy(assets.pose_origin).to(dev),
                                L, H)
    verts_y = assets.tris[:assets.n_tris, :, 1]
    y_bins = height_bins(float(verts_y.min()), float(verts_y.max()),
                         int(p.n_pieces), device=dev)
    grid_range = tuple(p.prediction_range)
    vms = int(p.value_map_size[0])
    img_size = int(p.pc2img_size[0])
    max_len = int(p.max_path_len)

    def frame_scores(role: str):
        draws.begin_group(role)
        return [draws.uniform(role, (n_px,), step=s)
                for s in range(1, n_steps + 1)]

    unreachable = np.zeros((L, H), bool)
    start = assets.start_cam_idx
    cur = (int(start[0]), int(start[2]), int(start[4]))

    positions_np = tables.positions.cpu().numpy()
    gt_blocked = tables.gt_edge_blocked
    inside = tables.inside.cpu().numpy()

    def pose5(idx) -> torch.Tensor:
        i_l, i_h, rot = idx
        pos = positions_np[i_l, i_h]
        return torch.tensor(np.asarray(
            [pos[0], pos[1], pos[2], assets.elevations_deg[2],
             assets.azimuths_deg[rot]], np.float32), device=dev)

    coverage_evolution: List[float] = []
    experiences: List[Dict] = []
    path: List[Tuple[int, int, int]] = []
    path_record = 0

    def flush_experiences():
        for ex, pixels, gains in _suffix_labels(experiences, vms, grid_range):
            db.append(ex["model_input"], ex["gt_obs"], pixels, gains,
                      ex["pose_i"])
        experiences.clear()

    was_training = nbp_model.training
    nbp_model.to(dev).eval()
    try:
        with torch.inference_mode():
            pc = PointBuffer.create(int(p.full_pc_capacity), dev)
            traj = TrajectoryBuffer.create(8 * (n_poses + 4), dev)
            visited_rot = torch.zeros((L, H, n_azim), dtype=torch.bool,
                                      device=dev)
            visited_rot[cur] = True
            pose0 = pose5(cur)
            move_and_capture(tri_soa, n_tris, pose0, pose0, pc, traj,
                             frame_scores("init"), intr, n_steps=n_steps,
                             n_azim=n_azim, **capture_kw)
            for pose_i in range(n_poses):
                draws.begin_group("cov")
                cov = float(coverage_percentage_exact(
                    gt, pc.points, pc.count,
                    draws.uniform("cov", (pc.capacity,))))
                coverage_evolution.append(cov)
                if verbose and pose_i % 10 == 0:
                    print(f"collect pose {pose_i}: coverage {cov:.4f}")
                if cov > 0.95:
                    break

                cur_pose5 = pose5(cur)
                draws.begin_group("obs")
                observe_current(tri_soa, n_tris, cur_pose5, pc,
                                draws.uniform("obs", (n_px,)), intr,
                                **capture_kw)
                model_input, _ = build_model_input(
                    pc, traj, cur_pose5[:3], y_bins,
                    n_pieces=int(p.n_pieces), img_size=img_size)
                gt_obs = gt_obstacle_map(tris, n_tris, cur_pose5,
                                         grid_size=img_size,
                                         grid_range=grid_range)

                if path_record >= len(path):
                    flush_experiences()
                    path, path_record = [], 0
                    path = _plan(nbp_model, model_input, tables, gt_blocked,
                                 cur, cur_pose5, visited_rot, unreachable,
                                 inside, draws, vms, max_len, n_azim)
                    if not path:
                        break

                experiences.append(dict(
                    coverage=cov,
                    model_input=model_input[0].permute(2, 0, 1).cpu().numpy(),
                    gt_obs=gt_obs.cpu().numpy(),
                    cam_pose5=cur_pose5.cpu().numpy(),
                    rot=cur[2], pose_i=pose_i))

                nxt = path[path_record]
                draws.begin_group("rot")
                if float(draws.uniform("rot", ())) <= 0.6:
                    draws.begin_group("rot")
                    nxt = (nxt[0], nxt[1], int(draws.randint("rot", 0, n_azim)))
                move_and_capture(tri_soa, n_tris, cur_pose5, pose5(nxt), pc,
                                 traj, frame_scores("move"), intr,
                                 n_steps=n_steps, n_azim=n_azim, **capture_kw)
                visited_rot[nxt] = True
                cur = nxt
                path_record += 1
    finally:
        nbp_model.train(was_training)
    flush_experiences()
    return coverage_evolution


def _plan(model, model_input, tables, gt_blocked, cur, cur_pose5,
          visited_rot, unreachable, inside, draws, vms, max_len, n_azim
          ) -> List[Tuple[int, int, int]]:
    """The next path: the U-Net's value map scores the lattice, the first
    candidate is Boltzmann-sampled (beta 0.5), then the others follow by
    descending score; the first admissible one inside the volume and
    reachable on the GT edges (1 <= dist < INF) is the goal. Marks
    unreachable candidates in ``unreachable``. Returns [] when no
    candidate qualifies."""
    L, H = tables.positions.shape[:2]
    dev = cur_pose5.device
    value_map, _ = model(model_input)
    scores = score_candidates_train(tables.positions, cur_pose5[:3],
                                    value_map[0], cur[:2], value_map_size=vms)
    start = torch.tensor(cur[:2], dtype=torch.int64, device=dev)
    dist = bfs_distance_field(gt_blocked, start, L, H)
    dist_np = dist.cpu().numpy()
    scores_np = scores.cpu().numpy()

    draws.begin_group("goal")
    first = int(boltzmann_first(scores, draws.gumbel("goal", (L * H,)),
                                beta=0.5))
    order = list(np.argsort(-scores_np.reshape(-1)))
    order.remove(first)
    order.insert(0, first)

    chosen = None
    for flat in order:
        gl, gh = divmod(int(flat), H)
        if scores_np[gl, gh] <= -1e29:
            break  # the rest are inadmissible
        if not inside[gl, gh] or unreachable[gl, gh]:
            continue
        if dist_np[gl, gh] >= int(INF) or dist_np[gl, gh] < 1:
            unreachable[gl, gh] = True
            continue
        chosen = (gl, gh)
        break
    if chosen is None:
        return []

    path_arr, path_len, _ = extract_path(
        dist, gt_blocked, torch.tensor(chosen, dtype=torch.int64, device=dev),
        L, H, max_len=max_len)
    draws.begin_group("plan")
    rots = pick_orientations(
        path_arr, torch.arange(max_len, device=dev) < path_len, value_map[0],
        tables.positions, cur_pose5[:3], visited_rot,
        draws.uniform("plan", (max_len, n_azim)), n_azim=n_azim,
        value_map_size=vms)
    n = int(path_len)
    path_np = path_arr.cpu().numpy()
    rots_np = rots.cpu().numpy()
    return [(int(path_np[i, 0]), int(path_np[i, 1]), int(rots_np[i]))
            for i in range(n)]
