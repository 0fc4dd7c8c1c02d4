"""NBP planning evaluation rollout on PyTorch.

Port of ``nextbestpath_tpu/eval/nbp_planning.py``: the host-orchestrated
``NBPPlanningRollout`` in both of its modes, and the multi-scene
evaluation ``test_nbp_planning``. Per pose: the coverage metric (kernel
K3), the loop-start frame (K1), the model input and the U-Net forward, on
regeneration poses the layout fusion, candidate scoring, the distance
field, path and orientations with the first-segment retry loop, then the
move's four frames (K1). The per-scene tables are cast once with K2.

The two modes differ in their draws and the metric's sampler:

* ``shared_rng=False`` (the default, as the JAX package's): draws in the
  sequential schedule of ``draws.py`` (one key a group, a fresh one for
  each planning attempt), and the exact argsort subsample of the coverage
  metric (``ops.coverage.coverage_percentage_exact``);
* ``shared_rng=True``: the role schedule (one set of role draws a pose,
  the same orientation draws for every attempt) and the stride subsample,
  as the scan rollout draws them.

Contract kept from the reference: obstacle threshold 0.13, layout fusion
with the point-cloud projection and the current-height slice, trajectory
pixels passable, density penalty 10, collision/passable edge memos,
anti-revisit random rotation, per-pose coverage.

Random draws come from a provider (``draws.py``); the default is a
``torch.Generator`` on the device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import kernels
from ..assets import generate_scene, pack_generated_scene
from ..assets.scene_assets import SceneAssets
from ..config import Params, default_params
from ..device import DeviceLike, resolve_device
from ..draws import TorchDraws
from ..geometry.cameras import CameraIntrinsics
from ..models.unet import NBP
from ..ops.coverage import (compute_auc, coverage_percentage,
                            coverage_percentage_exact)
from ..ops.raytrace import tris_to_soa
from ..ops.scatter2d import (binned_count_imgs, count_img, height_bins,
                             plan_count_imgs)
from ..planning.candidates import score_candidates_test
from ..planning.grid_paths import (DIRS, EDGE_COLLISION, EDGE_PASSABLE, INF,
                                   apply_edge_memo, bfs_distance_field,
                                   extract_path, layout_edge_blocked,
                                   pick_orientations)
from ..sim.rollout import (TrajectoryBuffer, interpolate_move,
                           move_and_capture, observe_current)
from ..sim.sensor import PointBuffer
from ..sim.tables import SceneTables, build_scene_tables
from ..utils.timing import span

OBSTACLE_THRESHOLD = 0.13

# The main path that chip_smoke.py drives and profile_rollout.py traces:
# main_path_setup()'s scene, config and model, rolled out with draws from
# MAIN_PATH_SEED after MAIN_PATH_WARMUP_POSES poses of warm-up.
MAIN_PATH_DIFFICULTY = "simple"
MAIN_PATH_SEED = 8  # the procgen scene's seed and the rollout's draws'
MAIN_PATH_WARMUP_POSES = 2

Grid = Tuple[float, float]


def build_model_input(pc: PointBuffer, traj: TrajectoryBuffer,
                      cam_xyz: torch.Tensor, y_bins: torch.Tensor,
                      n_pieces: int = 4, img_size: int = 256,
                      grid_range: Grid = (-40.0, 40.0)):
    """(1, S, S, n_pieces+1) NHWC model input and the trajectory image:
    n_pieces height-sliced count images of the cloud + the trajectory's."""
    pc_imgs = binned_count_imgs(pc.points, pc.valid_mask(), cam_xyz, y_bins,
                                n_pieces, img_size, grid_range)
    traj_img = count_img(traj.xyz, traj.valid_mask(), cam_xyz, img_size,
                         grid_range)
    x = torch.cat([pc_imgs, traj_img[None]], dim=0)
    return x.permute(1, 2, 0)[None].contiguous(), traj_img


def _layout_projections(pc: PointBuffer, cam_pose5: torch.Tensor,
                        img_size: int, grid_range: Grid):
    """(proj, filt): the clamped full-cloud projection and the clamped
    current-height slice |y - cam_y| < 0.1."""
    pts = pc.points
    valid = pc.valid_mask()
    cam_y = cam_pose5[1]
    proj = count_img(pts, valid, cam_pose5[:3], img_size,
                     grid_range).clamp(max=1.0)
    band = valid & (pts[:, 1] < cam_y + 0.1) & (pts[:, 1] > cam_y - 0.1)
    filt = count_img(pts, band, cam_pose5[:3], img_size,
                     grid_range).clamp(max=1.0)
    return proj, filt


def fuse_layout_from_projections(pred_obstacle: torch.Tensor,
                                 proj: torch.Tensor, filt: torch.Tensor,
                                 traj_img: torch.Tensor):
    """Threshold the predicted obstacle map, substitute the height slice
    where the cloud has observations, clear trajectory pixels."""
    layout = (pred_obstacle >= OBSTACLE_THRESHOLD).to(torch.float32)
    layout = torch.where(proj > 0, filt, layout)
    layout = torch.where(traj_img > 0, torch.zeros_like(layout), layout)
    return layout, proj


def build_plan_projections(pc: PointBuffer, traj: TrajectoryBuffer,
                           cam_pose5: torch.Tensor, y_bins: torch.Tensor,
                           n_pieces: int = 4, img_size: int = 256,
                           grid_range: Grid = (-40.0, 40.0)):
    """(model_input, traj_img, proj, filt): build_model_input's outputs and
    fuse_layout's two clamped projections, from one scatter over the cloud
    (ops.scatter2d.plan_count_imgs) and one over the trajectory."""
    imgs = plan_count_imgs(pc.points, pc.valid_mask(), cam_pose5[:3], y_bins,
                           cam_pose5[1], n_pieces, img_size, grid_range)
    traj_img = count_img(traj.xyz, traj.valid_mask(), cam_pose5[:3],
                         img_size, grid_range)
    x = torch.cat([imgs[:n_pieces], traj_img[None]], dim=0)
    model_input = x.permute(1, 2, 0)[None].contiguous()
    proj = imgs[:n_pieces + 1].sum(dim=0).clamp(max=1.0)
    filt = imgs[n_pieces + 1].clamp(max=1.0)
    return model_input, traj_img, proj, filt


def fuse_layout(pred_obstacle: torch.Tensor, pc: PointBuffer,
                traj_img: torch.Tensor, cam_pose5: torch.Tensor,
                img_size: int = 256, grid_range: Grid = (-40.0, 40.0)):
    """Binary layout (S, S) and the clamped cloud projection."""
    proj, filt = _layout_projections(pc, cam_pose5, img_size, grid_range)
    return fuse_layout_from_projections(pred_obstacle, proj, filt, traj_img)


def select_goal(scores: torch.Tensor, dist: torch.Tensor, L: int, H: int):
    """Best-scoring candidate that is reachable (dist in [1, INF)).
    Returns (goal (2,) int64 (l, h), found 0-d bool), both on the device
    of the inputs (no sync)."""
    ok = (dist >= 1) & (dist < INF) & (scores > -1e29)
    masked = torch.where(ok, scores, torch.full_like(scores, -float("inf")))
    flat_idx = torch.argmax(masked.reshape(-1))
    return torch.stack([flat_idx // H, flat_idx % H]), ok.any()


@dataclasses.dataclass
class RolloutResult:
    coverage_evolution: List[float]
    auc: float
    cam_positions: np.ndarray
    wall_time_s: float
    n_points: int
    steps_per_sec: float


def _edge_dir(a, b) -> Optional[int]:
    d = (b[0] - a[0], b[1] - a[1])
    for k, dd in enumerate(DIRS):
        if d == dd:
            return k
    return None


def _memo_edge(memo: np.ndarray, a, b, state: int) -> None:
    d = _edge_dir(a, b)
    if d is not None:
        memo[d, a[0], a[1]] = state
    d2 = _edge_dir(b, a)
    if d2 is not None:
        memo[d2, b[0], b[1]] = state


class NBPPlanningRollout:
    """Host-orchestrated eval rollout over device stages.

    nbp_model: a ``models.unet.NBP`` (put in eval mode on ``device``).
    shared_rng: the mode (module docstring). draws: a provider of the
    draws in the mode's schedule (default: TorchDraws from ``seed`` on the
    device). device: "cuda" unless the caller asks for the CPU; raises if
    CUDA is asked for and absent."""

    def __init__(self, assets: SceneAssets, nbp_model: NBP,
                 params: Optional[Params] = None, seed: int = 8,
                 draws=None, shared_rng: bool = False,
                 max_plan_retries: int = 8, device: DeviceLike = "cuda"):
        self.device = dev = resolve_device(device)
        self.params = p = params or default_params()
        self.shared_rng = bool(shared_rng)
        self.max_plan_retries = int(max_plan_retries)
        self.assets = assets
        self.model = nbp_model.to(dev).eval()
        self.draws = draws if draws is not None else TorchDraws(seed, dev)
        self.intr = CameraIntrinsics(
            image_height=int(p.image_height), image_width=int(p.image_width),
            fov_degrees=float(p.fov_degrees), znear=float(p.camera_znear),
            zfar=float(p.zfar))
        self.tri_soa = tris_to_soa(torch.from_numpy(assets.tris).to(dev))
        self.n_tris = torch.tensor([assets.n_tris], dtype=torch.int32,
                                   device=dev)
        self.gt = torch.from_numpy(assets.gt_surface).to(dev)
        self.tables: SceneTables = build_scene_tables(
            self.tri_soa, self.n_tris,
            torch.from_numpy(assets.pose_origin).to(dev),
            assets.pose_l, assets.pose_h)
        verts_y = assets.tris[:assets.n_tris, :, 1]
        self.y_bins = height_bins(float(verts_y.min()), float(verts_y.max()),
                                  int(p.n_pieces), device=dev)
        self.L = assets.pose_l
        self.H = assets.pose_h
        self.n_azim = assets.n_azim
        self._positions_np = self.tables.positions.cpu().numpy()
        self._gt_eb_np = self.tables.gt_edge_blocked.cpu().numpy()
        # The last run's regeneration flag a pose and its kernel launches
        # (the scene tables' K2 launch comes before, at construction).
        self.regen_poses: List[bool] = []
        self.launches: Dict[str, int] = {}

    def _pose5(self, idx_lh_rot) -> torch.Tensor:
        i_l, i_h, rot = idx_lh_rot
        pos = self._positions_np[i_l, i_h]
        elev = self.assets.elevations_deg[2]  # fixed elevation index 2
        azim = self.assets.azimuths_deg[rot]
        return torch.tensor(np.asarray([pos[0], pos[1], pos[2], elev, azim],
                                       np.float32), device=self.device)

    def _capture_kw(self):
        p = self.params
        return dict(n_slots=int(p.points_per_frame),
                    gathering_factor=float(p.gathering_factor),
                    sensor_range=float(p.sensor_range))

    def _group(self, role: str) -> None:
        """A fresh key for the next group of draws (sequential schedule)."""
        if not self.shared_rng:
            self.draws.begin_group(role)

    def _frame_scores(self, role: str):
        n_px = self.intr.image_height * self.intr.image_width
        self._group(role)
        return [self.draws.uniform(role, (n_px,), step=s)
                for s in range(1, int(self.params.n_interpolation_steps) + 1)]

    def _coverage(self, pc: PointBuffer) -> torch.Tensor:
        if not self.shared_rng:
            self._group("cov")
            scores = self.draws.uniform("cov", (pc.capacity,))
            return coverage_percentage_exact(self.gt, pc.points, pc.count,
                                             scores)
        c = torch.clamp(pc.count, min=1)
        start_i = self.draws.randint("cov", 0, c)
        stride_half = self.draws.randint(
            "cov", 1, torch.clamp(c // 2, min=2), step=1)
        return coverage_percentage(self.gt, pc.points, pc.count, start_i,
                                   stride_half)

    def _randint(self, role: str, high: int) -> int:
        self._group(role)
        return int(self.draws.randint(role, 0, high))

    @torch.inference_mode()
    def run(self, n_poses: int = 101, verbose: bool = False) -> RolloutResult:
        p = self.params
        dev = self.device
        n_px = self.intr.image_height * self.intr.image_width
        img_size = int(p.pc2img_size[0])
        n_steps = int(p.n_interpolation_steps)
        t1 = time.time()
        launches0 = dict(kernels.LAUNCHES)
        self.regen_poses = []

        pc = PointBuffer.create(int(p.full_pc_capacity), dev)
        traj = TrajectoryBuffer.create(8 * (n_poses + 4), dev)
        edge_memo = np.zeros((4, self.L, self.H), np.int8)
        banned = np.zeros((self.L, self.H), bool)
        visited_rot = np.zeros((self.L, self.H, self.n_azim), bool)

        start = self.assets.start_cam_idx
        cur = (int(start[0]), int(start[2]), int(start[4]))
        visited_rot[cur] = True
        idx_history: List[Tuple[int, int, int]] = []

        # Initial captures: a full interpolation from start to start.
        pose0 = self._pose5(cur)
        move_and_capture(self.tri_soa, self.n_tris, pose0, pose0, pc, traj,
                         self._frame_scores("init"), self.intr,
                         n_steps=n_steps, n_azim=self.n_azim,
                         **self._capture_kw())

        path: List[Tuple[int, int, int]] = []
        path_record = 0
        gt_eb = self._gt_eb_np
        coverage_evolution: List[float] = []

        for pose_i in range(n_poses):
            if self.shared_rng:
                self.draws.begin_pose()
            with span("coverage"):
                cov = float(self._coverage(pc))
            coverage_evolution.append(cov)
            if verbose and pose_i % 10 == 0:
                print(f"pose {pose_i}: coverage {cov:.4f} pc {int(pc.count)}")

            cur_pose5 = self._pose5(cur)
            self._group("obs")
            with span("observe"):
                observe_current(self.tri_soa, self.n_tris, cur_pose5, pc,
                                self.draws.uniform("obs", (n_px,)), self.intr,
                                **self._capture_kw())
            with span("projections"):
                model_input, traj_img = build_model_input(
                    pc, traj, cur_pose5[:3], self.y_bins,
                    n_pieces=int(p.n_pieces), img_size=img_size)

            regen = pose_i == 0 or path_record >= len(path)
            if not regen:
                nxt = path[path_record]
                d_idx = _edge_dir(cur, nxt)
                if d_idx is None:
                    regen = True
                elif gt_eb[d_idx, cur[0], cur[1]]:
                    _memo_edge(edge_memo, cur, nxt, EDGE_COLLISION)
                    banned[path[-1][0], path[-1][1]] = True
                    regen = True
            # Passable memo for the edge just traversed.
            if idx_history:
                a, b = cur, idx_history[-1]
                if _edge_dir(a, b) is not None:
                    _memo_edge(edge_memo, a, b, EDGE_PASSABLE)

            with span("unet"):
                value_map, obstacle_map = self.model(model_input)
            if regen:
                with span("plan"):
                    layout, proj256 = fuse_layout(
                        obstacle_map[0, :, :, 0], pc, traj_img, cur_pose5,
                        img_size=img_size)
                    scores = score_candidates_test(
                        self.tables.positions, cur_pose5[:3], value_map[0],
                        proj256, torch.from_numpy(banned).to(dev),
                        value_map_size=int(p.value_map_size[0]),
                        layout_size=img_size)
                    plan_u = (self._plan_draws() if self.shared_rng
                              else None)
                    path, path_record = self._plan(
                        scores, layout, cur_pose5, cur, edge_memo,
                        value_map[0], visited_rot, gt_eb, plan_u)

            if not path:
                nxt = (cur[0], cur[1], self._randint("rot", self.n_azim))
            else:
                nxt = path[path_record]
                if nxt in set(idx_history):
                    nxt = (nxt[0], nxt[1], self._randint("rot2", self.n_azim))

            self.regen_poses.append(regen)
            idx_history.append(cur)
            with span("move"):
                move_and_capture(self.tri_soa, self.n_tris, cur_pose5,
                                 self._pose5(nxt), pc, traj,
                                 self._frame_scores("move"), self.intr,
                                 n_steps=n_steps, n_azim=self.n_azim,
                                 **self._capture_kw())
            visited_rot[nxt] = True
            cur = nxt
            path_record += 1

        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.time() - t1
        self.launches = {k: n - launches0[k]
                         for k, n in kernels.LAUNCHES.items()}
        return RolloutResult(
            coverage_evolution=coverage_evolution,
            auc=compute_auc(coverage_evolution),
            cam_positions=traj.xyz[:int(traj.count)].cpu().numpy(),
            wall_time_s=wall,
            n_points=int(pc.count),
            steps_per_sec=n_poses / wall)

    def _plan_draws(self) -> torch.Tensor:
        return self.draws.uniform("plan", (int(self.params.max_path_len),
                                           self.n_azim))

    def _plan(self, scores, layout, cur_pose5, cur, edge_memo, value_map,
              visited_rot, gt_eb, plan_u):
        """Field -> goal -> path -> first-segment GT check, retried with the
        collision memoised. Updates edge_memo in place; returns (path,
        path_record). Every attempt that reaches the orientation pick uses
        ``plan_u``, or, when it is None (sequential schedule), a fresh
        group of draws."""
        p = self.params
        dev = self.device
        max_len = int(p.max_path_len)
        layout_blocked = layout_edge_blocked(
            self.tables.positions, cur_pose5[:3], layout, self.L, self.H,
            layout_size=int(p.pc2img_size[0]))
        visited = torch.from_numpy(visited_rot).to(dev)
        start = torch.tensor(cur[:2], dtype=torch.int64, device=dev)
        for _ in range(self.max_plan_retries):
            blocked = apply_edge_memo(layout_blocked,
                                      torch.from_numpy(edge_memo).to(dev))
            dist = bfs_distance_field(blocked, start, self.L, self.H)
            goal, found = select_goal(scores, dist, self.L, self.H)
            if not bool(found):
                return [], 0
            path_arr, path_len, _ = extract_path(dist, blocked, goal, self.L,
                                                 self.H, max_len=max_len)
            path_len = int(path_len)
            if plan_u is None:
                self._group("plan")
                attempt_u = self._plan_draws()
            else:
                attempt_u = plan_u
            rots = pick_orientations(
                path_arr, torch.arange(max_len, device=dev) < path_len,
                value_map, self.tables.positions, cur_pose5[:3], visited,
                attempt_u, n_azim=self.n_azim,
                value_map_size=int(p.value_map_size[0]))
            path_np = path_arr.cpu().numpy()
            rots_np = rots.cpu().numpy()
            path = [(int(path_np[i, 0]), int(path_np[i, 1]), int(rots_np[i]))
                    for i in range(path_len)]
            if not path:
                return [], 0
            first = path[0]
            d_idx = _edge_dir(cur, first)
            if d_idx is not None and gt_eb[d_idx, cur[0], cur[1]]:
                _memo_edge(edge_memo, cur, first, EDGE_COLLISION)
                continue
            return path, 0
        return [], 0


def scene_result(res: RolloutResult) -> dict:
    """A scene's entry in the results JSON, under the JAX function's keys."""
    return {"coverage_evolution": res.coverage_evolution, "auc": res.auc,
            "cam_positions": res.cam_positions.tolist(),
            "wall_time_s": res.wall_time_s,
            "steps_per_sec": res.steps_per_sec}


def test_nbp_planning(assets_list: Sequence[SceneAssets], nbp_model: NBP,
                      params: Optional[Params] = None, n_poses: int = 101,
                      results_path: Optional[str] = None, seed: int = 8,
                      verbose: bool = True, device: DeviceLike = "cuda",
                      make_draws: Optional[Callable[[int], object]] = None,
                      rollouts: Optional[list] = None) -> Dict[str, dict]:
    """Multi-scene evaluation (JAX ``test_nbp_planning``): a legacy-mode
    ``NBPPlanningRollout`` a scene, each from ``seed``. Returns, and writes
    to ``results_path`` as JSON, each scene's coverage evolution, AUC,
    camera positions, wall time and poses a second by scene name.
    make_draws(seed) gives a scene's draws provider (default: TorchDraws);
    ``rollouts``, a list, receives each scene's rollout (its regeneration
    flags and launches)."""
    results = {}
    for assets in assets_list:
        rollout = NBPPlanningRollout(
            assets, nbp_model, params=params, seed=seed, device=device,
            draws=None if make_draws is None else make_draws(seed))
        res = rollout.run(n_poses=n_poses, verbose=verbose)
        if rollouts is not None:
            rollouts.append(rollout)
        results[assets.name] = scene_result(res)
        if verbose:
            print(f"{assets.name}: final coverage "
                  f"{res.coverage_evolution[-1]:.4f} auc {res.auc:.4f} "
                  f"({res.steps_per_sec:.2f} poses/s)")
    if results_path:
        os.makedirs(os.path.dirname(results_path) or ".", exist_ok=True)
        with open(results_path, "w") as f:
            json.dump(results, f)
    return results


# pytest collects test_* functions of modules that tests import by name.
test_nbp_planning.__test__ = False


def seeded_nbp(width: int = 64, seed: int = 0,
               dtype: torch.dtype = torch.float32) -> NBP:
    """An NBP U-Net computing in ``dtype`` with random weights from
    ``seed`` and the untrained obstacle decoder opened (``final2`` bias
    -4), as the JAX package's bench does without a checkpoint."""
    torch.manual_seed(seed)
    model = NBP(width=width, dtype=dtype)
    with torch.no_grad():
        model.final2.bias -= 4.0
    return model


def main_path_setup() -> Tuple[Params, SceneAssets, NBP]:
    """(params, assets, model) of the main path: the procgen scene of
    MAIN_PATH_DIFFICULTY and MAIN_PATH_SEED under default_params() and a
    full-width seeded_nbp()."""
    params = default_params()
    assets = pack_generated_scene(
        generate_scene(MAIN_PATH_DIFFICULTY, seed=MAIN_PATH_SEED),
        params=params)
    return params, assets, seeded_nbp()


def main_path_move(assets: SceneAssets, n_steps: int, device) -> torch.Tensor:
    """The poses (n_steps, 5) of a move from the start pose to a lattice
    neighbour (one step along l, one azimuth step round): the frames whose
    shapes K1 gets from move_and_capture on the main path."""
    start = np.asarray(assets.start_cam_idx).copy()
    nxt = start.copy()
    nxt[0] = start[0] + 1 if start[0] + 1 < assets.pose_l else start[0] - 1
    nxt[4] = (start[4] + 1) % assets.n_azim
    old, new = (torch.tensor(assets.pose_from_idx(i), dtype=torch.float32,
                             device=device) for i in (start, nxt))
    return interpolate_move(old, new, n_steps, assets.n_azim)
