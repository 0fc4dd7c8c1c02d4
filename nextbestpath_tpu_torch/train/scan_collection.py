"""Training rollout collection with its state on the device.

Port of ``nextbestpath_tpu/train/scan_collection.py``. The JAX module folds a
whole collection rollout into one ``lax.scan``; here a pose is the three
steps of ``eval/scan_rollout.py`` (``GraphSteps``), captured once as CUDA
graphs on the card and replayed, run eagerly on the CPU:

* ``pre``: the coverage metric (stride sampler, K3, padded GT masked), the
  loop-start frame (K1), the model input, the GT layout
  (``gt_obstacle_map_soa``) and the plan decision
  ``regen & ~done & cov <= 0.95``;
* ``plan`` (the scan's ``lax.cond``, replayed only when the decision is
  set): the folded eval-mode U-Net, the training scores, the GT-edge
  distance field (P1), the Boltzmann pick among the reachable candidates
  inside the volume, ``argmax(gumbel + where(ok, scores / beta, -inf))`` as
  ``jax.random.categorical`` takes it (index 0, not found, when none is
  ok), the path (P2) and its orientations;
* ``post``: the pose's record (``model_input`` in f16), the next waypoint
  with the random rotation override (p = 0.6), the frozen no-op once the
  rollout is done, the move's four frames (K1) and ``visited_rot``.

A pose reads two flags on the host, the plan decision and whether the
rollout was already done (the pose's one sync); once it was, the remaining
poses are left out: their records stay invalid, as the JAX scan's frozen
poses are. The records stay on the device and are copied to the host once
a rollout.

A rollout can branch: ``run`` is ``begin`` (the scene, the draws and the
initial captures) then ``advance`` (n poses, their records counted from
row 0), and between the two, or between two ``advance`` calls,
``snapshot`` / ``restore`` copy the state out and back into the tensors
the graphs read and ``force_replan`` makes the next pose plan anew (the
JAX label-quality probe's continuations from one mid-state). The records'
row counter is the collection's own, not the state's.

All scenes are padded to common triangle and GT sizes and share one
lattice (``pad_assets_to_common``), so one capture serves every scene and
every epoch: ``run`` copies the scene's arrays and the folded weights into
the tensors the graphs read. The weights come from the caller's model (the
trainer's, in train mode) folded per run into the collection's own copy;
the caller's running statistics are never touched.

The draws come from a provider (``draws.py``) under the collection's role
set, one role for each key of the JAX step's 8-way split: ``cov``,
``obs``, ``bolt`` (the Boltzmann pick's Gumbel noise), ``pick`` (the
orientations' uniforms), ``u`` (the override's uniform), ``rot`` (its
random rotation) and ``move``; ``init`` serves the initial capture. Every
role is drawn every pose (the plan's too, as the JAX split makes its keys
whether the plan runs or not), into static buffers outside the graphs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..assets.scene_assets import SceneAssets
from ..config import Params, default_params
from ..device import DeviceLike, resolve_device
from ..draws import TorchDraws, frame_draws
from ..eval.nbp_planning import build_model_input
from ..eval.scan_rollout import (MIN_POSE_CAPACITY, GraphSteps, SceneArrays,
                                 _at, common_sizes, pad_scene_arrays,
                                 scene_arrays_from_tables)
from ..geometry.cameras import CameraIntrinsics
from ..models.fold import fold_bn as fold_bn_model
from ..models.unet import NBP
from ..ops.coverage import coverage_percentage
from ..ops.obstacle_map import gt_obstacle_map_soa
from ..ops.raytrace import tris_to_soa
from ..planning.candidates import NEG, score_candidates_train
from ..planning.grid_paths import (INF, bfs_distance_field, extract_path,
                                   pick_orientations)
from ..sim.rollout import TrajectoryBuffer, move_and_capture, observe_current
from ..sim.sensor import PointBuffer, stratified_applies
from ..sim.tables import build_scene_tables
from ..utils.timing import span
from .replay import ReplayDB

COVERAGE_STOP = 0.95


def soa_to_tris(tri_soa: torch.Tensor) -> torch.Tensor:
    """(9, F) SoA (v0, e1, e2) -> dense (F, 3, 3) triangles."""
    v0 = tri_soa[0:3].T
    return torch.stack([v0, v0 + tri_soa[3:6].T, v0 + tri_soa[6:9].T], dim=1)


@dataclasses.dataclass
class CollectScene(SceneArrays):
    """A scene's device constants for collection: the scan's, and the
    inside-volume mask of the candidate filter."""

    inside: torch.Tensor = None    # (L, H) bool


@dataclasses.dataclass
class CollectState:
    """The rollout's state, static tensors updated in place."""

    pc: PointBuffer
    traj: TrajectoryBuffer
    cur: torch.Tensor          # (3,) int64 (i_l, i_h, rot)
    path: torch.Tensor         # (P, 3) int64
    path_len: torch.Tensor     # int64
    path_record: torch.Tensor  # int64
    visited_rot: torch.Tensor  # (L, H, A) bool
    done: torch.Tensor         # bool: the rollout ended (coverage, no path)


class CollectOut(NamedTuple):
    """A rollout's per-pose records, stacked, on the host."""

    model_input: np.ndarray  # (n, S, S, C) f16
    gt_obs: np.ndarray       # (n, S, S) bool
    pose5: np.ndarray        # (n, 5) f32
    rot: np.ndarray          # (n,) int32
    coverage: np.ndarray     # (n,) f32
    valid: np.ndarray        # (n,) bool
    planned: np.ndarray      # (n,) bool: a new path was planned at the pose


@dataclasses.dataclass
class CollectDraws:
    """A pose's draws, by the roles of the module docstring."""

    cov_start: torch.Tensor   # int64
    cov_stride: torch.Tensor  # int64
    obs: torch.Tensor         # (H*W,) f32
    bolt: torch.Tensor        # (L*H,) f32 Gumbel noise
    pick: torch.Tensor        # (max_len, A) f32
    u: torch.Tensor           # f32
    rot: torch.Tensor         # int64
    move: torch.Tensor        # (n_steps, H*W) f32
    obs_ranks: Optional[torch.Tensor]   # stratified draw only
    move_ranks: Optional[torch.Tensor]


class ScanCollection(GraphSteps):
    """Collection rollouts over a set of same-lattice scenes.

    model: the policy (an unfolded ``models.unet.NBP``, f32 or bf16); the
    collection folds it into its own copy (``fold_bn``, as the JAX class
    does by default), and each ``run`` refolds the weights it is given. make_draws(seed): the provider of a
    run's draws (default ``TorchDraws(seed)`` on the device; the tests
    inject the JAX key schedule). device: "cuda" unless the caller asks for
    the CPU."""

    def __init__(self, assets_list: Sequence[SceneAssets], model: NBP,
                 params: Optional[Params] = None,
                 boltzmann_beta: float = 0.5,
                 rotation_override_p: float = 0.6,
                 make_draws: Optional[Callable[[int], object]] = None,
                 device: DeviceLike = "cuda"):
        if not assets_list:
            raise ValueError("ScanCollection needs at least one scene")
        self.device = dev = resolve_device(device)
        self.p = p = params or default_params()
        f_max, g_max = common_sizes(assets_list)
        self._fold_bn = True
        self.model = fold_bn_model(model).to(dev).eval()
        self.beta = float(boltzmann_beta)
        self.rot_p = float(rotation_override_p)
        self.make_draws = make_draws
        self.assets_list = list(assets_list)
        self.intr = CameraIntrinsics(
            image_height=int(p.image_height), image_width=int(p.image_width),
            fov_degrees=float(p.fov_degrees), znear=float(p.camera_znear),
            zfar=float(p.zfar))
        a0 = self.assets_list[0]
        self.L, self.H, self.A = a0.pose_l, a0.pose_h, a0.n_azim
        self.n_px = self.intr.image_height * self.intr.image_width
        self.n_slots = int(p.points_per_frame)
        self.stratified = bool(p.get("stratified_sampling", False)) and \
            stratified_applies(self.n_px, self.n_slots,
                               float(p.gathering_factor))
        self.n_steps = int(p.n_interpolation_steps)
        self.max_len = int(p.max_path_len)
        self.S = int(p.pc2img_size[0])
        self.vms = int(p.value_map_size[0])
        self.C = int(p.n_pieces) + 1
        self._init_graphs(2)

        self.scenes: List[CollectScene] = []
        for a in self.assets_list:
            tri_soa = tris_to_soa(torch.from_numpy(a.tris).to(dev))
            n_tris = torch.tensor([a.n_tris], dtype=torch.int32, device=dev)
            tables = build_scene_tables(
                tri_soa, n_tris, torch.from_numpy(a.pose_origin).to(dev),
                a.pose_l, a.pose_h)
            arrays = pad_scene_arrays(scene_arrays_from_tables(
                a, tri_soa, n_tris, tables, int(p.n_pieces)), f_max, g_max)
            self.scenes.append(CollectScene(*arrays.tensors(),
                                            inside=tables.inside))
        # The tensors the graphs read; run() copies a scene into them.
        self.scene = CollectScene(*[t.clone()
                                    for t in self.scenes[0].tensors()])
        # The JAX class takes the first scene's elevation for every scene.
        self._elev = torch.full((1,), float(a0.elevations_deg[2]),
                                dtype=torch.float32, device=dev)

        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.pose_draws = CollectDraws(
            cov_start=z((), torch.int64), cov_stride=z((), torch.int64),
            obs=z(self.n_px, torch.float32),
            bolt=z(self.L * self.H, torch.float32),
            pick=z((self.max_len, self.A), torch.float32),
            u=z((), torch.float32), rot=z((), torch.int64),
            move=z((self.n_steps, self.n_px), torch.float32),
            obs_ranks=z(self.n_slots, torch.float32)
            if self.stratified else None,
            move_ranks=z((self.n_steps, self.n_slots), torch.float32)
            if self.stratified else None)
        # What pre hands to plan and post.
        self.cov = z((), torch.float32)
        self.cur_pose5 = z(5, torch.float32)
        self.model_input = z((1, self.S, self.S, self.C), torch.float32)
        self.gt_obs = z((self.S, self.S), torch.bool)
        self.found = z((), torch.bool)
        self.flags = z(2, torch.bool)   # (plan now, done before the pose)
        self.row = z((), torch.int64)   # the record that post writes
        self.state: Optional[CollectState] = None
        self._pose_cap = 0
        self.plan_poses: List[bool] = []

    # -- set-up --------------------------------------------------------------

    def _ensure_capacity(self, n_poses: int) -> None:
        """Static state and records for n_poses; a larger rollout than they
        hold reallocates them and drops the graphs captured over them."""
        if self.state is not None and n_poses <= self._pose_cap:
            return
        cap = max(int(n_poses), MIN_POSE_CAPACITY)
        dev = self.device

        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        i64 = torch.int64
        self.state = CollectState(
            pc=PointBuffer.create(int(self.p.full_pc_capacity), dev),
            traj=TrajectoryBuffer.create(8 * (cap + 4), dev),
            cur=z(3, i64), path=z((self.max_len, 3), i64),
            path_len=z((), i64), path_record=z((), i64),
            visited_rot=z((self.L, self.H, self.A), torch.bool),
            done=z((), torch.bool))
        S, C = self.S, self.C
        self.records = dict(
            model_input=z((cap, S, S, C), torch.float16),
            gt_obs=z((cap, S, S), torch.bool),
            pose5=z((cap, 5), torch.float32), rot=z(cap, torch.int32),
            coverage=z(cap, torch.float32), valid=z(cap, torch.bool),
            planned=z(cap, torch.bool))
        self._pose_cap = cap
        self._graphs = {}

    def _pose5(self, idx3: torch.Tensor) -> torch.Tensor:
        pos = _at(self.scene.positions, idx3[0], idx3[1])
        azim = self.scene.azims.index_select(0, idx3[2].reshape(1))
        return torch.cat([pos, self._elev, azim])

    def _capture_kw(self):
        p = self.p
        return dict(n_slots=self.n_slots,
                    gathering_factor=float(p.gathering_factor),
                    sensor_range=float(p.sensor_range))

    def _frame(self, draws, role: str, step: Optional[int] = None):
        return frame_draws(draws, role, self.n_px, self.n_slots,
                           self.stratified, step=step)

    def _visit(self, idx3: torch.Tensor) -> None:
        flat = (idx3[0] * self.H + idx3[1]) * self.A + idx3[2]
        self.state.visited_rot.view(-1).index_fill_(0, flat.reshape(1), True)

    def _state_tensors(self) -> Tuple[torch.Tensor, ...]:
        s = self.state
        return (s.pc._storage, s.pc.count, s.traj._storage, s.traj.count,
                s.cur, s.path, s.path_len, s.path_record, s.visited_rot,
                s.done)

    def _init_state(self, scene_idx: int, draws) -> None:
        """The initial state in place: empty buffers, the scene's start
        pose, and the initial captures (a full interpolation from the start
        to itself)."""
        s = self.state
        for t in self._state_tensors():
            t.zero_()
        start = self.assets_list[scene_idx].start_cam_idx
        s.cur.copy_(torch.tensor([int(start[0]), int(start[2]),
                                  int(start[4])], dtype=torch.int64))
        self._visit(s.cur)
        pose0 = self._pose5(s.cur)
        frames = [self._frame(draws, "init", step=k)
                  for k in range(1, self.n_steps + 1)]
        move_and_capture(self.scene.tri_soa, self.scene.n_tris, pose0, pose0,
                         s.pc, s.traj, [f[0].to(self.device) for f in frames],
                         self.intr,
                         frame_ranks=([f[1].to(self.device) for f in frames]
                                      if self.stratified else None),
                         n_steps=self.n_steps, n_azim=self.A,
                         **self._capture_kw())

    def _draw_pose(self, draws) -> None:
        """The pose's draws, every role, into the static buffers."""
        d = self.pose_draws
        draws.begin_pose()
        c = torch.clamp(self.state.pc.count, min=1)
        d.cov_start.copy_(draws.randint("cov", 0, c))
        d.cov_stride.copy_(draws.randint("cov", 1, torch.clamp(c // 2, min=2),
                                         step=1))
        scores, ranks = self._frame(draws, "obs")
        d.obs.copy_(scores)
        if self.stratified:
            d.obs_ranks.copy_(ranks)
        d.bolt.copy_(draws.gumbel("bolt", (self.L * self.H,)))
        d.pick.copy_(draws.uniform("pick", (self.max_len, self.A)))
        d.u.copy_(draws.uniform("u", ()))
        d.rot.copy_(draws.randint("rot", 0, self.A))
        for k in range(self.n_steps):
            scores, ranks = self._frame(draws, "move", step=k + 1)
            d.move[k].copy_(scores)
            if self.stratified:
                d.move_ranks[k].copy_(ranks)

    # -- the step ------------------------------------------------------------

    def _pre_step(self) -> None:
        """Coverage, the loop-start frame, the model input, the GT layout
        and the plan decision."""
        s, d, sc, p = self.state, self.pose_draws, self.scene, self.p
        with span("coverage"):
            cov = coverage_percentage(sc.gt, s.pc.points, s.pc.count,
                                      d.cov_start, d.cov_stride,
                                      gt_valid=sc.gt_valid)
        cur_pose5 = self._pose5(s.cur)
        with span("observe"):
            observe_current(sc.tri_soa, sc.n_tris, cur_pose5, s.pc, d.obs,
                            self.intr, frame_ranks=d.obs_ranks,
                            **self._capture_kw())
        with span("model_input"):
            model_input, _ = build_model_input(
                s.pc, s.traj, cur_pose5[:3], sc.y_bins,
                n_pieces=int(p.n_pieces), img_size=self.S)
        with span("gt_layout"):
            gt_obs = gt_obstacle_map_soa(sc.tri_soa, sc.n_tris, cur_pose5,
                                         grid_size=self.S,
                                         grid_range=tuple(p.prediction_range))
        regen = s.path_record >= s.path_len
        plan_now = regen & ~s.done & (cov <= COVERAGE_STOP)
        self.cov.copy_(cov)
        self.cur_pose5.copy_(cur_pose5)
        self.model_input.copy_(model_input)
        self.gt_obs.copy_(gt_obs > 0.5)
        self.found.fill_(True)
        self.flags.copy_(torch.stack([plan_now, s.done]))

    def _plan_step(self) -> None:
        """The plan: value map, training scores, reachability, the
        Boltzmann pick, the path and its orientations."""
        s, sc, d = self.state, self.scene, self.pose_draws
        L, H = self.L, self.H
        cam = self.cur_pose5
        with span("unet"):
            value_map, _ = self.model(self.model_input)
        vm0 = value_map[0]
        scores = score_candidates_train(sc.positions, cam[:3], vm0,
                                        s.cur[:2],
                                        value_map_size=self.vms)
        dist = bfs_distance_field(sc.gt_edge_blocked, s.cur[:2], L, H)
        reachable = (dist >= 1) & (dist < INF)
        ok = (scores > NEG / 2) & sc.inside & reachable
        logits = torch.where(ok, scores / self.beta,
                             torch.full_like(scores, -float("inf")))
        flat = torch.argmax(d.bolt + logits.reshape(-1))
        goal = torch.stack([flat // H, flat % H])
        found = ok.any()
        path_arr, plen, _ = extract_path(dist, sc.gt_edge_blocked, goal,
                                         L, H, max_len=self.max_len)
        valid = torch.arange(self.max_len, device=self.device) < plen
        rots = pick_orientations(path_arr, valid, vm0, sc.positions,
                                 cam[:3], s.visited_rot, d.pick,
                                 n_azim=self.A, value_map_size=self.vms)
        path = torch.cat([path_arr, rots[:, None]], dim=-1).long()
        s.path.copy_(torch.where(found, path, 0))
        s.path_len.copy_(torch.where(found, plen.long(), 0))
        self.found.copy_(found)

    def _post_step(self) -> None:
        """The record, the next waypoint and the move."""
        s, d, sc = self.state, self.pose_draws, self.scene
        plan_now = self.flags[0]
        path_record = torch.where(plan_now, 0, s.path_record)
        done = s.done | (self.cov > COVERAGE_STOP) | ~self.found
        i = self.row.reshape(1)
        rec = self.records
        rec["model_input"].index_copy_(
            0, i, self.model_input.to(torch.float16))
        rec["gt_obs"].index_copy_(0, i, self.gt_obs[None])
        rec["pose5"].index_copy_(0, i, self.cur_pose5[None])
        rec["rot"].index_copy_(0, i, s.cur[2:3].to(torch.int32))
        rec["coverage"].index_copy_(0, i, self.cov.reshape(1))
        rec["valid"].index_copy_(0, i, (~done).reshape(1))
        rec["planned"].index_copy_(0, i, plan_now.reshape(1))
        P = s.path.shape[0]
        nxt = _at(s.path, path_record.clamp(0, P - 1))
        override = d.u <= self.rot_p
        nxt = torch.stack([nxt[0], nxt[1], torch.where(override, d.rot,
                                                       nxt[2])])
        nxt = torch.where(done, s.cur, nxt)
        with span("move"):
            move_and_capture(sc.tri_soa, sc.n_tris, self.cur_pose5,
                             self._pose5(nxt), s.pc, s.traj, d.move,
                             self.intr, frame_ranks=d.move_ranks,
                             n_steps=self.n_steps, n_azim=self.A,
                             **self._capture_kw())
        self._visit(nxt)
        s.cur.copy_(nxt)
        s.path_record.copy_(path_record + 1)
        s.done.copy_(done)
        self.row.add_(1)

    # -- the rollout ---------------------------------------------------------

    @torch.no_grad()
    def begin(self, scene_idx: int, seed: int = 0, n_poses: int = 100,
              variables: Optional[NBP] = None):
        """A rollout of scene ``scene_idx`` up to its first pose: the state
        for ``n_poses`` poses (the longest run of ``advance`` calls that
        follows: the trajectory buffer must hold them all), the graphs on a
        first call, and the initial captures. variables: the policy's
        weights (an unfolded NBP, e.g. the trainer's), folded into the
        captured copy first; None keeps the last ones. Returns the run's
        draws, ``make_draws(seed)`` (default ``TorchDraws(seed)``), for
        ``advance``."""
        if variables is not None:
            self.load_weights(variables)
        draws = (self.make_draws(seed) if self.make_draws is not None
                 else TorchDraws(seed, self.device))
        self._ensure_capacity(n_poses)
        self.scene.copy_(self.scenes[scene_idx])
        if self._use_graphs and not self._graphs:
            self._capture()
        self._init_state(scene_idx, draws)
        return draws

    @torch.no_grad()
    def advance(self, n: int, draws, run_frozen: bool = False) -> CollectOut:
        """n poses from the current state with the provider ``draws``;
        returns their records on the host, row 0 the first of them. Once
        the rollout is done the remaining poses are left out (their records
        stay invalid, as the JAX scan's frozen poses are); ``run_frozen``
        runs them as the JAX scan does (the camera stays, its frames are
        still captured), for a state that goes on after them."""
        if n > self._pose_cap:
            raise ValueError(f"advance({n}) past the {self._pose_cap} poses "
                             f"of begin")
        for t in (self.row, *self.records.values()):
            t.zero_()
        self._begin_run()
        plan_poses = []
        t0 = time.perf_counter()
        for _ in range(n):
            self._draw_pose(draws)
            self._step("pre")
            plan_now, done_before = (bool(f) for f in
                                     self._read_flags(self.flags))
            if done_before and not run_frozen:
                break  # the rest are the JAX scan's frozen, invalid poses
            if plan_now:
                self._step("plan")
            self._step("post")
            plan_poses.append(plan_now)
        # A copy on the CPU too: the records are static buffers that the
        # next call overwrites.
        out = CollectOut(**{k: v[:n].to("cpu", copy=True).numpy()
                            for k, v in self.records.items()})
        self.wall_time_s = time.perf_counter() - t0
        self.plan_poses = plan_poses
        return out

    @torch.no_grad()
    def snapshot(self) -> Tuple[torch.Tensor, ...]:
        """A copy of the rollout's state, for ``restore`` within the same
        scene's rollout."""
        return tuple(t.clone() for t in self._state_tensors())

    @torch.no_grad()
    def restore(self, snap: Tuple[torch.Tensor, ...]) -> None:
        """The state of ``snap`` copied back into the tensors the graphs
        read (the trajectory buffer whole: the model input's trajectory
        channel reads it)."""
        for t, v in zip(self._state_tensors(), snap):
            t.copy_(v)

    @torch.no_grad()
    def force_replan(self) -> None:
        """The next pose plans anew from the current state: the path is
        cleared and the rollout is no longer done (the JAX probe's
        ``path_len = path_record = 0, done = False``)."""
        s = self.state
        for t in (s.path_len, s.path_record, s.done):
            t.zero_()

    @torch.no_grad()
    def run(self, scene_idx: int, variables: Optional[NBP] = None,
            seed: int = 0, n_poses: int = 100) -> CollectOut:
        """One rollout of scene ``scene_idx`` (``begin`` then ``advance``);
        returns the stacked records on the host. variables: the policy's
        weights (an unfolded NBP, e.g. the trainer's model), folded into the
        captured copy first; None keeps the last ones. Draws from
        ``make_draws(seed)``."""
        draws = self.begin(scene_idx, seed, n_poses, variables)
        return self.advance(n_poses, draws)


def suffix_labels_from_out(out: CollectOut, value_map_size: int,
                           grid_range: Tuple[float, float]):
    """Path-suffix labels from a rollout's records: for valid poses i < j
    on the same planned path, pose j's position in pose i's egocentric
    value-map frame; in-bounds pairs give a (rot_j, row, col) pixel with
    gain max(0, 100 (cov_j - cov_i)). Segments start at the poses where
    ``planned`` is set; the last one is mined too, as the host collector
    does. Returns a list of (pose_index, pixels (k, 3) i32, gains (k,)
    f32)."""
    valid = np.asarray(out.valid)
    idx = np.nonzero(valid)[0]
    if len(idx) == 0:
        return []
    lo, hi = grid_range
    scale = value_map_size / (hi - lo)
    pose5 = np.asarray(out.pose5)[idx]       # (P, 5)
    cov = np.asarray(out.coverage)[idx]      # (P,)
    rot = np.asarray(out.rot)[idx]           # (P,)
    seg = np.cumsum(np.asarray(out.planned)[idx])  # (P,) path segment id
    P = len(idx)
    dx = pose5[None, :, 0] - pose5[:, None, 0]   # (i, j)
    dz = pose5[None, :, 2] - pose5[:, None, 2]
    row = np.rint((-dz - lo) * scale).astype(np.int64)
    col = np.rint((-dx - lo) * scale).astype(np.int64)
    upper = np.triu(np.ones((P, P), bool), k=1)
    same_path = seg[:, None] == seg[None, :]
    in_b = ((row >= 0) & (row < value_map_size)
            & (col >= 0) & (col < value_map_size) & upper & same_path)
    gain = np.maximum((cov[None, :] - cov[:, None]) * 100.0, 0.0)
    results = []
    for i in range(P):
        js = np.nonzero(in_b[i])[0]
        if len(js) == 0:
            continue
        pixels = np.stack([rot[js], row[i, js], col[i, js]],
                          axis=-1).astype(np.int32)
        results.append((int(idx[i]), pixels, gain[i, js].astype(np.float32)))
    return results


def collect_trajectory_scan(collection: ScanCollection, scene_idx: int,
                            variables: Optional[NBP], db: ReplayDB,
                            seed: int = 0, n_poses: int = 100) -> List[float]:
    """One collection rollout; its suffix-labelled experiences go to ``db``.
    Returns the coverage of the valid poses and of the pose where the
    rollout stopped (its coverage was taken before it stopped)."""
    p = collection.p
    out = collection.run(scene_idx, variables, seed=seed, n_poses=n_poses)
    labeled = suffix_labels_from_out(
        out, int(p.value_map_size[0]), tuple(p.prediction_range))
    for pose_i, pixels, gains in labeled:
        db.append(np.transpose(out.model_input[pose_i], (2, 0, 1)),
                  out.gt_obs[pose_i], pixels, gains, pose_i)
    n_valid = int(np.sum(out.valid))
    return [float(c) for c in out.coverage[:max(n_valid + 1, 1)]]
