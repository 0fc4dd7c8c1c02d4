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

``ScanRandomWalk`` (JAX :45) is the batched, device-resident variant over
padded same-lattice scenes: a pose of all B scenes is one CUDA graph with
no host read (eagerly on the CPU). Its draws take the walk's role schedule
of ``draws.py``: a uniformly random open neighbour by the Gumbel argmax
over the GT edge table (``jax.random.categorical``), a random rotation, the
move's frames, and the stride-sampled coverage with ``gt_valid``.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..assets.scene_assets import SceneAssets
from ..config import Params, default_params
from ..device import DeviceLike, resolve_device
from ..draws import TorchDraws
from ..geometry.cameras import CameraIntrinsics
from ..ops.coverage import (compute_auc, coverage_percentage_exact,
                            coverage_percentage_scenes)
from ..ops.raytrace import tris_to_soa
from ..planning.grid_paths import DIRS
from ..sim.rollout import TrajectoryBuffer, append_move, move_and_capture
from ..sim.sensor import PointBuffer
from ..sim.tables import build_scene_tables
from .nbp_planning import RolloutResult
from .scan_rollout import (MIN_POSE_CAPACITY, GraphSteps, _at, _stop_clock,
                           _sync, common_sizes, pad_scene_arrays,
                           render_moves, scene_arrays_from_assets,
                           stack_scenes, stacked_buffers)


class ScanRandomWalk(GraphSteps):
    """The random-walk baseline over B padded same-lattice scenes on the
    device (JAX ``ScanRandomWalk``).

    Each pose, for every scene: the stride-sampled coverage (one K3 launch
    for the B scenes, padded GT rows masked), a uniformly random neighbour
    among the open edges of the GT table (``gumbel`` noise, argmax over the
    open directions; in place when none is open), a uniformly random
    rotation, and the move's frames (one K1 launch for the B x n_steps
    frames). The walk has no data-dependent branch, so on the card a pose is
    one captured graph and no host read. The scenes share a lattice and an
    elevation, as the JAX class requires. Scene i's draws come from
    ``make_draws(seed + i)`` (default ``TorchDraws``) in the walk's role
    schedule (``draws.py``)."""

    STEPS = ("pose",)

    def __init__(self, assets_list: Sequence[SceneAssets],
                 params: Optional[Params] = None,
                 make_draws: Optional[Callable[[int], object]] = None,
                 device: DeviceLike = "cuda"):
        if not assets_list:
            raise ValueError("ScanRandomWalk needs at least one scene")
        elevs = {float(a.elevations_deg[2]) for a in assets_list}
        if len(elevs) != 1:
            raise ValueError(f"the scenes need a common elevation (got "
                             f"{elevs})")
        f_max, g_max = common_sizes(assets_list)
        self.device = dev = resolve_device(device)
        self.params = p = params or default_params()
        self.assets_list = list(assets_list)
        self.n_scenes = B = len(self.assets_list)
        self.make_draws = make_draws
        self.intr = CameraIntrinsics(
            image_height=int(p.image_height), image_width=int(p.image_width),
            fov_degrees=float(p.fov_degrees), znear=float(p.camera_znear),
            zfar=float(p.zfar))
        a0 = self.assets_list[0]
        self.L, self.H, self.A = a0.pose_l, a0.pose_h, a0.n_azim
        self.n_px = self.intr.image_height * self.intr.image_width
        self.n_steps = int(p.n_interpolation_steps)
        self.scenes = [pad_scene_arrays(scene_arrays_from_assets(
            a, n_pieces=int(p.n_pieces), device=dev), f_max, g_max)
            for a in self.assets_list]
        self.scene = stack_scenes(self.scenes)
        self._elev = torch.full((B, 1), elevs.pop(), dtype=torch.float32,
                                device=dev)
        self._dirs = torch.tensor(DIRS, dtype=torch.int64, device=dev)

        def z(shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        i64 = torch.int64
        self.draw_bufs = dict(
            cov_start=z(B, i64), cov_stride=z(B, i64), dir=z((B, 4)),
            rot=z(B, i64), move=z((B, self.n_steps, self.n_px)))
        self.cur = z((B, 3), i64)
        self.pose_i = z((), i64)
        self._pose_cap = 0
        self.pcs = self.trajs = None
        self._init_graphs(1)

    def _pose5(self, idx3: torch.Tensor) -> torch.Tensor:
        """(B, 5) poses of the (B, 3) lattice indices."""
        sc = self.scene
        pos = torch.stack([_at(sc.positions[b], idx3[b, 0], idx3[b, 1])
                           for b in range(self.n_scenes)])
        azim = torch.gather(sc.azims, 1, idx3[:, 2:3])
        return torch.cat([pos, self._elev, azim], dim=1)

    def _ensure_capacity(self, n_poses: int) -> None:
        if self.pcs is not None and n_poses <= self._pose_cap:
            return
        cap = max(int(n_poses), MIN_POSE_CAPACITY)
        B, dev = self.n_scenes, self.device
        self._pc, self._pc_count, self.pcs = stacked_buffers(
            B, int(self.params.full_pc_capacity), dev, PointBuffer)
        self._traj, self._traj_count, self.trajs = stacked_buffers(
            B, 8 * (cap + 4), dev, TrajectoryBuffer)
        self.cov_curve = torch.zeros((B, cap), dtype=torch.float32,
                                     device=dev)
        self._pose_cap = cap
        self._graphs = {}

    def _moves(self, old5: torch.Tensor, new5: torch.Tensor,
               scores) -> None:
        """B moves rendered in one K1 launch, each scene's frames appended
        a substep at a time."""
        zb, R, T, poses = render_moves(self.scene, old5, new5, self.n_steps,
                                       self.A, self.intr)
        p = self.params
        for b in range(self.n_scenes):
            append_move(zb[b], R[b], T[b], poses[b], self.pcs[b],
                        self.trajs[b], scores[b], self.intr,
                        n_slots=int(p.points_per_frame),
                        gathering_factor=float(p.gathering_factor),
                        sensor_range=float(p.sensor_range))

    def _init_state(self, draws) -> None:
        """Empty buffers, the start poses and the initial captures."""
        for t in (self._pc, self._pc_count, self._traj, self._traj_count,
                  self.pose_i, self.cov_curve):
            t.zero_()
        self.cur.copy_(torch.tensor(
            [[int(a.start_cam_idx[0]), int(a.start_cam_idx[2]),
              int(a.start_cam_idx[4])] for a in self.assets_list],
            dtype=torch.int64))
        pose0 = self._pose5(self.cur)
        self._moves(pose0, pose0, [
            torch.stack([d.uniform("init", (self.n_px,), step=k).to(
                self.device) for k in range(1, self.n_steps + 1)])
            for d in draws])

    def _draw_pose(self, draws) -> None:
        """Each scene's draws of a pose into the static buffers."""
        bufs = self.draw_bufs
        for b, d in enumerate(draws):
            d.begin_pose()
            c = torch.clamp(self._pc_count[b], min=1)
            bufs["cov_start"][b].copy_(d.randint("cov", 0, c))
            bufs["cov_stride"][b].copy_(d.randint(
                "cov", 1, torch.clamp(c // 2, min=2), step=1))
            bufs["dir"][b].copy_(d.gumbel("dir", (4,)))
            bufs["rot"][b].copy_(d.randint("rot", 0, self.A))
            for k in range(self.n_steps):
                bufs["move"][b, k].copy_(
                    d.uniform("move", (self.n_px,), step=k + 1))

    def _pose_step(self) -> None:
        """One pose of every scene (JAX ``ScanRandomWalk._step``)."""
        sc, bufs, cur = self.scene, self.draw_bufs, self.cur
        covs = coverage_percentage_scenes(
            sc.gt, self._pc[:, :-1], self._pc_count, bufs["cov_start"],
            bufs["cov_stride"], sc.gt_valid)
        self.cov_curve.index_copy_(1, self.pose_i.reshape(1), covs[:, None])
        open_mask = torch.stack([
            ~_at(sc.gt_edge_blocked[b].permute(1, 2, 0), cur[b, 0], cur[b, 1])
            for b in range(self.n_scenes)])
        logits = torch.where(open_mask, 0.0, -float("inf"))
        d = torch.argmax(bufs["dir"] + logits, dim=1)
        step = torch.where(open_mask.any(dim=1, keepdim=True),
                           self._dirs[d], torch.zeros_like(self._dirs[d]))
        nxt = torch.cat([cur[:, :2] + step, bufs["rot"][:, None]], dim=1)
        self._moves(self._pose5(cur), self._pose5(nxt), bufs["move"])
        cur.copy_(nxt)
        self.pose_i.add_(1)

    @torch.no_grad()
    def run(self, n_poses: int = 200, seed: int = 8) -> List[RolloutResult]:
        """One walk a scene, scene i from seed + i; each result's wall time
        is the whole batch's, and its rate counts every scene's poses."""
        draws = [self.make_draws(seed + i) if self.make_draws is not None
                 else TorchDraws(seed + i, self.device)
                 for i in range(self.n_scenes)]
        self._ensure_capacity(n_poses)
        if self._use_graphs and not self._graphs:
            self._capture()
        self._init_state(draws)
        self._begin_run()
        _sync(self.device)
        t1 = time.perf_counter()
        for _ in range(n_poses):
            self._draw_pose(draws)
            self._step("pose")
        results = []
        for b in range(self.n_scenes):
            coverage = self.cov_curve[b, :n_poses].cpu().numpy()
            tr = self.trajs[b]
            results.append(RolloutResult(
                coverage_evolution=[float(c) for c in coverage],
                auc=compute_auc(coverage),
                cam_positions=tr.xyz[:int(tr.count)].to(
                    "cpu", copy=True).numpy(),
                wall_time_s=0.0, n_points=int(self.pcs[b].count),
                steps_per_sec=0.0))
        return _stop_clock(results, t1, n_poses, self.device)


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
