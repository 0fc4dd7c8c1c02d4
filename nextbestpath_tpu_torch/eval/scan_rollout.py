"""Device-resident NBP evaluation rollout, replayed as CUDA graphs.

Port of ``nextbestpath_tpu/eval/scan_rollout.py::ScanRollout``. The JAX class
compiles a pose's whole step into one ``lax.scan`` body; here the step is
three functions over a state that stays on the device:

* ``pre``: the coverage metric (K3), the loop-start frame (K1), the
  regeneration decision, and the collision and passable edge memos;
* ``plan`` (regeneration poses only): the one-pass projections, the U-Net,
  layout fusion, candidate scoring and edge blocking, then up to
  ``max_plan_retries`` planning attempts (the distance field and the path
  walk: ``nbp_bfs_field`` and ``nbp_extract_path``), each predicated on the
  device and masked once one succeeded, as the JAX ``fori_loop``/``cond``;
* ``post``: the next index, anti-revisit on the visited (position,
  rotation) grid, the move's four frames in one K1 launch, and the state
  update.

On the card each of the three is captured once as a ``torch.cuda.CUDAGraph``
over static tensors that it updates in place. A pose replays ``pre``, reads
the one-byte regeneration flag into pinned host memory (the pose's only
sync), replays ``plan`` when it is set, then replays ``post``. On the CPU
the same functions run eagerly (on the card too when ``_use_graphs`` is
cleared, as the checks of the captured step do).

The random draws do not run inside the graphs: before each pose the
provider (``draws.py``, roles as the JAX scan's 7-way key split) writes them
into static buffers, and the plan's orientation draws are written once the
flag says the plan runs. A captured and an uncaptured run with the same
provider therefore see the same numbers.

Behaviour kept from the JAX class: the U-Net runs only on regeneration
poses (its output is unused otherwise), and anti-revisit tests the visited
(position, rotation) grid rather than the host rollout's history list.
The params ``stratified_sampling`` (the two-stage stratified pixel draw of
``sim.sensor.backproject_sample``, where it applies) and
``batched_capture`` (a move's frames appended with one scatter) select the
JAX class's capture options; their draws are static buffers too.
``run(..., variables=model)`` (or ``load_weights``) runs new weights: they
are folded and copied into the tensors the graphs were captured over.

Several scenes on one card, as the JAX module's two single-device modes:
``BatchedScanRollout`` (JAX ``make_batched_step``) runs same-lattice scenes
padded to common triangle and GT sizes (``pad_scene_arrays``; the coverage
metric masks the padded GT rows) on a scene axis: one U-Net forward of
batch B on a pose where any scene regenerates, and one launch of K1, K3 and
each planner kernel for all scenes (``kernels.*_scenes``).
``run_interleaved`` steps several captured ``ScanRollout``s a pose at a
time, so that one scene's flag read overlaps the others' replays. Not
ported: ``segment_len`` (a TPU watchdog workaround that gives identical
results), the ``ablate`` profiling switch (the stage ranges of
``torch.profiler.record_function`` take its place) and ``mesh`` sharding.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from .. import kernels
from ..assets.scene_assets import SceneAssets
from ..config import Params, default_params
from ..device import DeviceLike, resolve_device
from ..draws import TorchDraws, frame_draws
from ..geometry.cameras import CameraIntrinsics
from ..models.fold import fold_bn as fold_bn_model
from ..models.unet import NBP
from ..ops.coverage import (compute_auc, coverage_percentage,
                            coverage_percentage_scenes)
from ..ops.raytrace import tris_to_soa
from ..ops.scatter2d import height_bins
from ..planning.candidates import score_candidates_test
from ..planning.grid_paths import (DIRS, EDGE_COLLISION, EDGE_PASSABLE,
                                   apply_edge_memo, bfs_distance_field,
                                   bfs_distance_field_scenes, extract_path,
                                   extract_path_scenes, layout_edge_blocked,
                                   pick_orientations)
from ..sim.rollout import (TrajectoryBuffer, append_move, interpolate_move,
                           move_and_capture, observe_current)
from ..sim.sensor import (PointBuffer, backproject_sample,
                          capture_depth_scenes, stratified_applies)
from ..sim.tables import build_scene_tables
from .nbp_planning import (RolloutResult, build_plan_projections,
                           fuse_layout_from_projections, select_goal)

# The static buffers hold at least this many poses (the reference's budget),
# so rollouts up to it reuse one capture. The trajectory buffer's size does
# not change results: a rollout never fills it.
MIN_POSE_CAPACITY = 101


def _edge_dir_index(a_lh: torch.Tensor, b_lh: torch.Tensor) -> torch.Tensor:
    """Direction index (0-d int64) of the edge a -> b, -1 when it is not a
    unit move."""
    dl = (b_lh[0] - a_lh[0]).long()
    dh = (b_lh[1] - a_lh[1]).long()
    idx = torch.full_like(dl, -1)
    for k, (kl, kh) in enumerate(DIRS):
        idx = torch.where((dl == kl) & (dh == kh), k, idx)
    return idx


def _memo_edge(memo: torch.Tensor, a_lh: torch.Tensor, b_lh: torch.Tensor,
               state: int, when: torch.Tensor) -> torch.Tensor:
    """memo with the edge a -> b and its reverse set to ``state`` where
    ``when`` holds; a pair that is not adjacent is dropped."""
    _, L, H = memo.shape
    cell = torch.arange(memo.numel(), device=memo.device).view(memo.shape)
    hit = torch.zeros_like(memo, dtype=torch.bool)
    for p, q in ((a_lh, b_lh), (b_lh, a_lh)):
        d = _edge_dir_index(p, q)
        on = (d >= 0) & (p[0] >= 0) & (p[0] < L) & (p[1] >= 0) & (p[1] < H)
        hit = hit | ((cell == (d * L + p[0]) * H + p[1]) & on)
    return torch.where(hit & when, state, memo)


def _at(t: torch.Tensor, *idx: torch.Tensor) -> torch.Tensor:
    """t[idx] for 0-d index tensors (in range), as a gather on the device:
    no index is read on the host."""
    flat = idx[0]
    for k, i in enumerate(idx[1:], 1):
        flat = flat * t.shape[k] + i
    rows = t.reshape(-1, *t.shape[len(idx):])
    return rows.index_select(0, flat.reshape(1).long())[0]


@dataclasses.dataclass
class SceneArrays:
    """Per-scene device constants."""

    tri_soa: torch.Tensor          # (9, F)
    n_tris: torch.Tensor           # (1,) int32
    gt: torch.Tensor               # (G, 3)
    gt_valid: torch.Tensor         # (G,) bool: False on padded GT rows
    positions: torch.Tensor        # (L, H, 3)
    gt_edge_blocked: torch.Tensor  # (4, L, H) bool
    y_bins: torch.Tensor           # (n_pieces + 1,)
    azims: torch.Tensor            # (A,)

    def tensors(self) -> List[torch.Tensor]:
        return [getattr(self, f.name) for f in dataclasses.fields(self)]

    def copy_(self, other: "SceneArrays") -> None:
        """Another scene's arrays (of the same shapes) into these tensors,
        in place: graphs captured over them then read the other scene."""
        for dst, src in zip(self.tensors(), other.tensors()):
            dst.copy_(src)


@dataclasses.dataclass
class ScanState:
    """The rollout's state, static tensors updated in place."""

    pc: PointBuffer
    traj: TrajectoryBuffer
    cur: torch.Tensor          # (3,) int64: (i_l, i_h, rot)
    prev: torch.Tensor         # (3,) int64: the previous pose
    has_prev: torch.Tensor     # bool
    path: torch.Tensor         # (P, 3) int64 waypoints with rotation
    path_len: torch.Tensor     # int64 (0 = no path)
    path_record: torch.Tensor  # int64
    edge_memo: torch.Tensor    # (4, L, H) int8
    banned: torch.Tensor       # (L, H) bool
    visited_rot: torch.Tensor  # (L, H, A) bool: every occupied (pos, rot)
    pose_i: torch.Tensor       # int64

    @staticmethod
    def create(pc_capacity: int, traj_capacity: int, max_len: int, L: int,
               H: int, A: int, device) -> "ScanState":
        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        i64 = torch.int64
        return ScanState(
            pc=PointBuffer.create(pc_capacity, device),
            traj=TrajectoryBuffer.create(traj_capacity, device),
            cur=z(3, i64), prev=z(3, i64), has_prev=z((), torch.bool),
            path=z((max_len, 3), i64), path_len=z((), i64),
            path_record=z((), i64), edge_memo=z((4, L, H), torch.int8),
            banned=z((L, H), torch.bool), visited_rot=z((L, H, A), torch.bool),
            pose_i=z((), i64))


@dataclasses.dataclass
class PrePlan:
    """What ``pre`` hands to ``plan`` and ``post``."""

    cov: torch.Tensor        # f32: the pose's coverage
    cur_pose5: torch.Tensor  # (5,) f32
    regen: torch.Tensor      # bool: the plan runs this pose


@dataclasses.dataclass
class PoseDraws:
    """A pose's random draws, by the roles of draws.py."""

    cov_start: torch.Tensor   # int64
    cov_stride: torch.Tensor  # int64
    obs: torch.Tensor         # (H*W,) f32
    rot: torch.Tensor         # int64
    rot2: torch.Tensor        # int64
    move: torch.Tensor        # (n_steps, H*W) f32
    plan: torch.Tensor        # (max_len, A) f32
    obs_ranks: Optional[torch.Tensor]   # (n_slots,) f32, stratified only
    move_ranks: Optional[torch.Tensor]  # (n_steps, n_slots) f32, likewise


def scene_arrays_from_assets(assets: SceneAssets, n_pieces: int = 4,
                             device: DeviceLike = "cuda") -> SceneArrays:
    """The per-scene device constants; the planner tables are cast once
    (one K2 launch on the card)."""
    dev = resolve_device(device)
    tri_soa = tris_to_soa(torch.from_numpy(assets.tris).to(dev))
    n_tris = torch.tensor([assets.n_tris], dtype=torch.int32, device=dev)
    tables = build_scene_tables(tri_soa, n_tris,
                                torch.from_numpy(assets.pose_origin).to(dev),
                                assets.pose_l, assets.pose_h)
    return scene_arrays_from_tables(assets, tri_soa, n_tris, tables,
                                    n_pieces)


def scene_arrays_from_tables(assets: SceneAssets, tri_soa: torch.Tensor,
                             n_tris: torch.Tensor, tables,
                             n_pieces: int = 4) -> SceneArrays:
    """SceneArrays from a scene's SoA buffer and its cast tables."""
    dev = tri_soa.device
    gt = torch.from_numpy(assets.gt_surface).to(dev)
    verts_y = assets.tris[:assets.n_tris, :, 1]
    return SceneArrays(
        tri_soa=tri_soa, n_tris=n_tris, gt=gt,
        gt_valid=torch.ones(gt.shape[0], dtype=torch.bool, device=dev),
        positions=tables.positions, gt_edge_blocked=tables.gt_edge_blocked,
        y_bins=height_bins(float(verts_y.min()), float(verts_y.max()),
                           n_pieces, device=dev),
        azims=torch.from_numpy(np.asarray(assets.azimuths_deg,
                                          np.float32)).to(dev))


def pad_scene_arrays(scene: SceneArrays, f_max: int, g_max: int
                     ) -> SceneArrays:
    """The scene with its triangle buffer padded to f_max columns (rows of
    1e8, past n_tris) and its GT cloud to g_max rows (at 1e7, gt_valid
    False), so that same-lattice scenes share one capture."""
    tri_soa, gt, gt_valid = scene.tri_soa, scene.gt, scene.gt_valid
    if tri_soa.shape[1] < f_max:
        tri_soa = torch.cat([tri_soa, torch.full(
            (9, f_max - tri_soa.shape[1]), 1e8, dtype=tri_soa.dtype,
            device=tri_soa.device)], dim=1)
    if gt.shape[0] < g_max:
        n_pad = g_max - gt.shape[0]
        gt = torch.cat([gt, torch.full((n_pad, 3), 1e7, dtype=gt.dtype,
                                       device=gt.device)])
        gt_valid = torch.cat([gt_valid, torch.zeros(
            n_pad, dtype=torch.bool, device=gt.device)])
    return dataclasses.replace(scene, tri_soa=tri_soa, gt=gt,
                               gt_valid=gt_valid)


def common_sizes(assets_list: Sequence[SceneAssets]):
    """(f_max, g_max) of same-lattice scenes; raises when the lattices
    differ (``pad_assets_to_common`` makes them agree)."""
    shapes = {(a.pose_l, a.pose_h, a.n_azim) for a in assets_list}
    if len(shapes) != 1:
        raise ValueError(f"the scenes need a common pose lattice (got "
                         f"{shapes}); pad them with pad_assets_to_common")
    return (max(a.tris.shape[0] for a in assets_list),
            max(len(a.gt_surface) for a in assets_list))


class GraphSteps:
    """The pre / plan / post steps of a device-resident rollout, run eagerly
    or captured once as CUDA graphs over static tensors and replayed.

    A subclass defines ``_pre_step``, ``_plan_step`` and ``_post_step``
    (each updates static tensors in place and reads no device value on the
    host) and calls ``_init_graphs`` in its constructor."""

    STEPS = ("pre", "plan", "post")

    def _init_graphs(self, n_flags: int) -> None:
        # On the card a pose replays captured graphs; clearing this runs
        # the same steps eagerly (the checks of the capture and the
        # profiler's stage split do).
        self._use_graphs = self.device.type == "cuda"
        self._graphs: Dict[str, torch.cuda.CUDAGraph] = {}
        self.graph_launches: Dict[str, Dict[str, int]] = {}
        # Graph replays and host reads of the flags (a captured pose's only
        # sync) of the last run.
        self.replays = dict.fromkeys(self.STEPS, 0)
        self.host_reads = 0
        if self.device.type == "cuda":
            self._flags_host = torch.zeros(n_flags,
                                           dtype=torch.bool).pin_memory()
            self._flags_read = torch.cuda.Event()

    def _capture(self) -> None:
        """Warm the three steps up on a side stream (cuDNN picks its
        algorithms, under the U-Net's f32 setting), then capture each as a
        graph. The warm-up advances the state, which ``run`` then resets.
        ``graph_launches`` records the kernel launches of each graph, which
        every replay adds to ``kernels.LAUNCHES``; a capture launches
        nothing, so its calls are taken back out."""
        kernels.build()
        steps = [(name, getattr(self, f"_{name}_step")) for name in self.STEPS]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _, fn in steps:
                fn()
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        pool = None
        for name, fn in steps:
            before = dict(kernels.LAUNCHES)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool):
                fn()
            self.graph_launches[name] = {
                k: kernels.LAUNCHES[k] - before[k] for k in before}
            kernels.LAUNCHES.update(before)
            self._graphs[name] = graph
            pool = graph.pool()
        torch.cuda.synchronize(self.device)

    def _step(self, name: str) -> None:
        """One of the three steps: its graph replayed, or its function run
        eagerly."""
        if not self._use_graphs:
            getattr(self, f"_{name}_step")()
            return
        with record_function(name):
            self._graphs[name].replay()
        kernels.count_replay(self.graph_launches[name])
        self.replays[name] += 1

    def _start_flag_read(self, flags: torch.Tensor) -> None:
        """Start the copy of device bool flags to the host: on the card a
        copy of a few bytes into pinned memory behind the queued work,
        marked by an event; ``_finish_flag_read`` waits for it."""
        self._flags_n = flags.numel()
        if not self._use_graphs:
            self._flags_host_eager = flags.cpu()
            return
        self._flags_host[:self._flags_n].copy_(flags, non_blocking=True)
        self._flags_read.record()

    def _finish_flag_read(self) -> torch.Tensor:
        """The flags of the last ``_start_flag_read`` on the host; on the
        card this waits for its event (the pose's one sync)."""
        if not self._use_graphs:
            return self._flags_host_eager
        self._flags_read.synchronize()
        self.host_reads += 1
        return self._flags_host[:self._flags_n]

    def _read_flags(self, flags: torch.Tensor) -> torch.Tensor:
        """Device bool flags on the host, read at once."""
        self._start_flag_read(flags)
        return self._finish_flag_read()

    def _begin_run(self) -> None:
        self.replays = dict.fromkeys(self.STEPS, 0)
        self.host_reads = 0

    @torch.no_grad()
    def load_weights(self, model: NBP) -> None:
        """The weights of ``model`` (an unfolded NBP of the same shape, e.g.
        the trainer's) for the next runs: folded, when this rollout folds,
        and copied into the tensors the captured graphs read (rebinding
        them would leave the graphs on the old weights). ``model`` is left
        as it is."""
        src = fold_bn_model(model) if self._fold_bn else model
        self.model.load_state_dict(src.state_dict())


class ScanRollout(GraphSteps):
    """The NBP evaluation rollout with its state on the device.

    model: a ``models.unet.NBP`` (folded with ``fold_bn`` by default, as the
    JAX class folds its variables). draws: a provider of the role draws
    (default: ``TorchDraws(seed)`` on the device, made anew by each
    ``run``); a provider given here is used as it is by every run.
    scene: the scene's arrays when the caller made them (padded ones,
    ``pad_scene_arrays``); the rollout keeps its own copy. device: "cuda"
    unless the caller asks for the CPU; raises if CUDA is asked for and
    absent."""

    def __init__(self, assets: SceneAssets, model: NBP,
                 params: Optional[Params] = None, max_plan_retries: int = 4,
                 fold_bn: bool = True, draws=None,
                 scene: Optional[SceneArrays] = None,
                 device: DeviceLike = "cuda"):
        self.device = dev = resolve_device(device)
        self.params = p = params or default_params()
        self.assets = assets
        self.max_plan_retries = int(max_plan_retries)
        self._fold_bn = fold_bn
        self.model = (fold_bn_model(model) if fold_bn else model).to(dev).eval()
        self.draws = draws
        self._init_graphs(1)
        self.intr = CameraIntrinsics(
            image_height=int(p.image_height), image_width=int(p.image_width),
            fov_degrees=float(p.fov_degrees), znear=float(p.camera_znear),
            zfar=float(p.zfar))
        if scene is None:
            self.scene = scene_arrays_from_assets(
                assets, n_pieces=int(p.n_pieces), device=dev)
        else:
            self.scene = SceneArrays(*[t.to(dev).clone()
                                       for t in scene.tensors()])
        self.L, self.H, self.A = assets.pose_l, assets.pose_h, assets.n_azim
        self._elev = torch.full((1,), float(assets.elevations_deg[2]),
                                dtype=torch.float32, device=dev)
        self.n_px = self.intr.image_height * self.intr.image_width
        self.n_slots = int(p.points_per_frame)
        self.stratified = bool(p.get("stratified_sampling", False)) and \
            stratified_applies(self.n_px, self.n_slots,
                               float(p.gathering_factor))
        self.batched_capture = bool(p.get("batched_capture", False))
        self.n_steps = int(p.n_interpolation_steps)
        self.max_len = int(p.max_path_len)
        self.state: Optional[ScanState] = None
        self._pose_cap = 0
        # The last run's regeneration flag a pose.
        self.regen_poses: List[bool] = []

        def z(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.pre = PrePlan(cov=z((), torch.float32),
                           cur_pose5=z(5, torch.float32),
                           regen=z((), torch.bool))
        self.pose_draws = PoseDraws(
            cov_start=z((), torch.int64), cov_stride=z((), torch.int64),
            obs=z(self.n_px, torch.float32), rot=z((), torch.int64),
            rot2=z((), torch.int64),
            move=z((self.n_steps, self.n_px), torch.float32),
            plan=z((self.max_len, self.A), torch.float32),
            obs_ranks=z(self.n_slots, torch.float32)
            if self.stratified else None,
            move_ranks=z((self.n_steps, self.n_slots), torch.float32)
            if self.stratified else None)

    # -- helpers -------------------------------------------------------------

    def _capture_kw(self):
        p = self.params
        return dict(n_slots=self.n_slots,
                    gathering_factor=float(p.gathering_factor),
                    sensor_range=float(p.sensor_range))

    def _frame(self, draws, role: str, step: Optional[int] = None):
        return frame_draws(draws, role, self.n_px, self.n_slots,
                           self.stratified, step=step)

    def _move_kw(self):
        return dict(n_steps=self.n_steps, n_azim=self.A,
                    batched=self.batched_capture, **self._capture_kw())

    def _pose5(self, idx3: torch.Tensor) -> torch.Tensor:
        pos = _at(self.scene.positions, idx3[0], idx3[1])
        azim = self.scene.azims.index_select(0, idx3[2].reshape(1))
        return torch.cat([pos, self._elev, azim])

    def _ensure_capacity(self, n_poses: int) -> None:
        """Static state for n_poses; a larger rollout than the buffers hold
        reallocates them and drops the graphs captured over the old ones."""
        if self.state is not None and n_poses <= self._pose_cap:
            return
        cap = max(int(n_poses), MIN_POSE_CAPACITY)
        self.state = ScanState.create(
            int(self.params.full_pc_capacity), 8 * (cap + 4), self.max_len,
            self.L, self.H, self.A, self.device)
        self.cov_curve = torch.zeros(cap, dtype=torch.float32,
                                     device=self.device)
        self._pose_cap = cap
        self._graphs = {}

    def _init_state(self, draws) -> None:
        """The initial state in place: empty buffers, the start pose, and the
        initial captures (a full interpolation from the start to itself)."""
        pose0 = self._reset_state()
        scores, ranks = self._init_draws(draws)
        move_and_capture(self.scene.tri_soa, self.scene.n_tris, pose0, pose0,
                         self.state.pc, self.state.traj, scores, self.intr,
                         frame_ranks=ranks, **self._move_kw())

    def _reset_state(self) -> torch.Tensor:
        """Empty buffers and memos and the start pose, visited; returns the
        start pose (5,)."""
        s = self.state
        for t in (s.pc._storage, s.pc.count, s.traj._storage, s.traj.count,
                  s.has_prev, s.path, s.path_len, s.path_record, s.edge_memo,
                  s.banned, s.visited_rot, s.pose_i, self.cov_curve):
            t.zero_()
        start = self.assets.start_cam_idx
        s.cur.copy_(torch.tensor([int(start[0]), int(start[2]),
                                  int(start[4])], dtype=torch.int64))
        s.prev.copy_(s.cur)
        self._visit(s.cur)
        return self._pose5(s.cur)

    def _init_draws(self, draws):
        """The initial capture's frame draws: (scores, ranks or None)."""
        frames = [self._frame(draws, "init", step=k)
                  for k in range(1, self.n_steps + 1)]
        return ([f[0].to(self.device) for f in frames],
                [f[1].to(self.device) for f in frames]
                if self.stratified else None)

    def _visit(self, idx3: torch.Tensor) -> None:
        flat = (idx3[0] * self.H + idx3[1]) * self.A + idx3[2]
        self.state.visited_rot.view(-1).index_fill_(0, flat.reshape(1), True)

    def _draw_pose(self, draws) -> None:
        """The pose's draws into the static buffers (outside any graph)."""
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
        d.rot.copy_(draws.randint("rot", 0, self.A))
        d.rot2.copy_(draws.randint("rot2", 0, self.A))
        for k in range(self.n_steps):
            scores, ranks = self._frame(draws, "move", step=k + 1)
            d.move[k].copy_(scores)
            if self.stratified:
                d.move_ranks[k].copy_(ranks)

    # -- the step ------------------------------------------------------------

    def _pre_step(self) -> None:
        """Coverage, the loop-start frame, the regeneration decision and the
        edge memos (JAX ``_pre``)."""
        s, d, sc, pre = self.state, self.pose_draws, self.scene, self.pre
        with record_function("coverage"):
            cov = coverage_percentage(sc.gt, s.pc.points, s.pc.count,
                                      d.cov_start, d.cov_stride,
                                      gt_valid=sc.gt_valid)
        cur_pose5 = self._pose5(s.cur)
        with record_function("observe"):
            observe_current(sc.tri_soa, sc.n_tris, cur_pose5, s.pc, d.obs,
                            self.intr, frame_ranks=d.obs_ranks,
                            **self._capture_kw())
        self._pre_logic(cov, cur_pose5)

    def _pre_logic(self, cov: torch.Tensor, cur_pose5: torch.Tensor) -> None:
        """The pose's coverage into the curve, then the regeneration
        decision and the edge memos into ``pre`` and the state."""
        s, sc, pre = self.state, self.scene, self.pre
        self.cov_curve.index_copy_(0, s.pose_i.reshape(1), cov.reshape(1))
        P = s.path.shape[0]
        exhausted = s.path_record >= s.path_len
        cand = _at(s.path, s.path_record.clamp(0, P - 1))
        d_idx = _edge_dir_index(s.cur[:2], cand[:2])
        blocked = _at(sc.gt_edge_blocked, d_idx.clamp(0, 3), s.cur[0],
                      s.cur[1])
        collides = ~exhausted & (d_idx >= 0) & blocked
        regen = (s.pose_i == 0) | exhausted | collides | (d_idx < 0)
        goal = _at(s.path, (s.path_len - 1).clamp(0, P - 1))
        memo = _memo_edge(s.edge_memo, s.cur[:2], cand[:2], EDGE_COLLISION,
                          collides)
        memo = _memo_edge(memo, s.cur[:2], s.prev[:2], EDGE_PASSABLE,
                          s.has_prev)
        cell = torch.arange(self.L * self.H, device=self.device)
        goal_cell = (cell == goal[0] * self.H + goal[1]).view(self.L, self.H)
        s.banned.logical_or_(goal_cell & collides)
        s.edge_memo.copy_(memo)
        pre.cov.copy_(cov)
        pre.cur_pose5.copy_(cur_pose5)
        pre.regen.copy_(regen)

    def _plan_fields(self):
        """The retry-independent half of the plan: projections, U-Net,
        layout fusion, scoring, edge blocking (JAX ``_plan_fields``)."""
        model_input, *proj = self._plan_input()
        with record_function("unet"):
            value_map, obstacle_map = self.model(model_input)
        return self._plan_maps(value_map, obstacle_map, *proj)

    def _plan_input(self):
        """The one-pass projections: (model_input (1, S, S, 5), traj_img,
        proj, filt)."""
        p, s = self.params, self.state
        with record_function("projections"):
            return build_plan_projections(
                s.pc, s.traj, self.pre.cur_pose5, self.scene.y_bins,
                n_pieces=int(p.n_pieces), img_size=int(p.pc2img_size[0]))

    def _plan_maps(self, value_map, obstacle_map, traj_img, proj, filt):
        """The U-Net's maps (batch 1) fused with the projections: (scores,
        layout_blocked, value map (S', S', A))."""
        p, s, sc = self.params, self.state, self.scene
        S = int(p.pc2img_size[0])
        cam = self.pre.cur_pose5
        layout, proj256 = fuse_layout_from_projections(
            obstacle_map[0, :, :, 0], proj, filt, traj_img)
        scores = score_candidates_test(
            sc.positions, cam[:3], value_map[0], proj256, s.banned,
            value_map_size=int(p.value_map_size[0]), layout_size=S)
        layout_blocked = layout_edge_blocked(sc.positions, cam[:3], layout,
                                             self.L, self.H, layout_size=S)
        return scores, layout_blocked, value_map[0]

    def _plan_attempt(self, scores, layout_blocked, vm0, memo):
        """One planning attempt against the memo: (memo', path, path_len,
        done), done when a path was found or nothing is reachable; a
        first-segment GT collision is memoised and leaves done False (JAX
        ``_plan_attempt``)."""
        L, H = self.L, self.H
        blocked = apply_edge_memo(layout_blocked, memo)
        dist = bfs_distance_field(blocked, self.state.cur[:2], L, H)
        goal, found = select_goal(scores, dist, L, H)
        path_arr, plen, _ = extract_path(dist, blocked, goal, L, H,
                                         max_len=self.max_len)
        return self._attempt_finish(path_arr, plen, found, vm0, memo)

    def _attempt_finish(self, path_arr, plen, found, vm0, memo):
        """An attempt's path (max_len, 2) and length turned into (memo',
        path, path_len, done): the orientations and the first segment's GT
        collision test."""
        s, sc = self.state, self.scene
        cur_lh = s.cur[:2]
        cam = self.pre.cur_pose5
        valid = torch.arange(self.max_len, device=self.device) < plen
        rots = pick_orientations(
            path_arr, valid, vm0, sc.positions, cam[:3], s.visited_rot,
            self.pose_draws.plan, n_azim=self.A,
            value_map_size=int(self.params.value_map_size[0]))
        first = path_arr[0]
        d_idx = _edge_dir_index(cur_lh, first)
        first_collides = ((d_idx >= 0)
                          & _at(sc.gt_edge_blocked, d_idx.clamp(0, 3),
                                cur_lh[0], cur_lh[1])
                          & found & (plen > 0))
        ok = found & (plen > 0) & ~first_collides
        new_path = torch.cat([path_arr, rots[:, None]], dim=-1).long()
        memo2 = _memo_edge(memo, cur_lh, first, EDGE_COLLISION,
                           first_collides)
        return (memo2, torch.where(ok, new_path, 0),
                torch.where(ok, plen.long(), 0), ok | ~found)

    def _plan_step(self) -> None:
        """The plan (JAX ``_plan``): the attempts run one after another, each
        masked once an earlier one is done, as the JAX fori_loop's cond."""
        s = self.state
        with record_function("plan"):
            scores, layout_blocked, vm0 = self._plan_fields()
            memo = s.edge_memo
            path = torch.zeros_like(s.path)
            path_len = torch.zeros_like(s.path_len)
            done = torch.zeros((), dtype=torch.bool, device=self.device)
            for _ in range(self.max_plan_retries):
                m2, p2, l2, d2 = self._plan_attempt(scores, layout_blocked,
                                                    vm0, memo)
                memo = torch.where(done, memo, m2)
                path = torch.where(done, path, p2)
                path_len = torch.where(done, path_len, l2)
                done = done | d2
            s.edge_memo.copy_(memo)
            s.path.copy_(path)
            s.path_len.copy_(path_len)

    def _post_step(self) -> None:
        """The move (JAX ``_post``): next index, anti-revisit, the move's
        frames, the state update."""
        s, d, sc, pre = self.state, self.pose_draws, self.scene, self.pre
        nxt, path_record = self._post_next()
        with record_function("move"):
            move_and_capture(sc.tri_soa, sc.n_tris, pre.cur_pose5,
                             self._pose5(nxt), s.pc, s.traj, d.move, self.intr,
                             frame_ranks=d.move_ranks, **self._move_kw())
        self._post_update(nxt, path_record)

    def _post_next(self):
        """The next pose (3,) and the path record: the path's next waypoint
        or, with no path, a random rotation in place; a revisited (position,
        rotation) gets the anti-revisit rotation."""
        s, d, pre = self.state, self.pose_draws, self.pre
        P = s.path.shape[0]
        path_record = torch.where(pre.regen, 0, s.path_record)
        no_path = s.path_len == 0
        nxt = torch.where(no_path, torch.stack([s.cur[0], s.cur[1], d.rot]),
                          _at(s.path, path_record.clamp(0, P - 1)))
        # A path's waypoints lie on the lattice; the clamps only keep the
        # gather in range.
        revisit = _at(s.visited_rot, nxt[0].clamp(0, self.L - 1),
                      nxt[1].clamp(0, self.H - 1), nxt[2].clamp(0, self.A - 1))
        nxt = torch.stack([nxt[0], nxt[1],
                           torch.where(revisit & ~no_path, d.rot2, nxt[2])])
        return nxt, path_record

    def _post_update(self, nxt: torch.Tensor, path_record: torch.Tensor
                     ) -> None:
        s = self.state
        self._visit(nxt)
        s.prev.copy_(s.cur)
        s.cur.copy_(nxt)
        s.has_prev.fill_(True)
        s.path_record.copy_(path_record + 1)
        s.pose_i.add_(1)

    # -- the rollout ---------------------------------------------------------

    def _start_run(self, n_poses: int, seed: int,
                   variables: Optional[NBP]):
        """A run's set-up: new weights, the draws, the static state (and,
        on a first run, the capture), the initial captures. Returns the
        provider."""
        if variables is not None:
            self.load_weights(variables)
        draws = self.draws if self.draws is not None else TorchDraws(
            seed, self.device)
        self._ensure_capacity(n_poses)
        if self._use_graphs and not self._graphs:
            self._capture()
        self._init_state(draws)
        self._begin_run()
        self.regen_poses = []
        return draws

    def _plan_and_post(self, draws, regen: bool) -> None:
        """The rest of a pose once its flag is on the host: the plan's draws
        and replay when it is set, then the move."""
        if regen:
            self.pose_draws.plan.copy_(
                draws.uniform("plan", (self.max_len, self.A)))
            self._step("plan")
        self._step("post")
        self.regen_poses.append(regen)

    def _result(self, n_poses: int) -> RolloutResult:
        """The run's curve, trajectory and points on the host; the clock's
        fields are set by ``_stop_clock``."""
        s = self.state
        coverage = self.cov_curve[:n_poses].cpu().numpy()
        return RolloutResult(
            coverage_evolution=[float(c) for c in coverage],
            auc=compute_auc(coverage),
            cam_positions=s.traj.xyz[:int(s.traj.count)].to(
                "cpu", copy=True).numpy(),
            wall_time_s=0.0, n_points=int(s.pc.count), steps_per_sec=0.0)

    @torch.no_grad()
    def run(self, n_poses: int = 101, seed: int = 8,
            variables: Optional[NBP] = None) -> RolloutResult:
        """n_poses poses from the scene's start; the draws come from
        ``TorchDraws(seed)`` unless a provider was given; ``variables``
        (an unfolded NBP) replaces the weights first (``load_weights``).
        The clock runs from the first pose, once the set-up has finished on
        the device, to the read of the coverage curve and the trajectory,
        after a final sync; state set-up and, on a run that needs them, the
        graphs' capture come before it."""
        draws = self._start_run(n_poses, seed, variables)
        _sync(self.device)
        t1 = time.perf_counter()
        for _ in range(n_poses):
            self._draw_pose(draws)
            self._step("pre")
            regen = bool(self._read_flags(self.pre.regen.reshape(1))[0])
            self._plan_and_post(draws, regen)
        return _stop_clock([self._result(n_poses)], t1, n_poses,
                           self.device)[0]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _stop_clock(results: List[RolloutResult], t1: float, n_poses: int,
                device: torch.device) -> List[RolloutResult]:
    """After a final sync, each result's wall time is the clock since t1
    and its rate counts every result's poses (the aggregate rate)."""
    _sync(device)
    wall = time.perf_counter() - t1
    for res in results:
        res.wall_time_s = wall
        res.steps_per_sec = len(results) * n_poses / wall
    return results


@torch.no_grad()
def run_interleaved(rollouts: Sequence[ScanRollout], n_poses: int = 101,
                    seed: int = 8, variables: Optional[NBP] = None,
                    seeds: Optional[Sequence[int]] = None
                    ) -> List[RolloutResult]:
    """Several scenes on one card, a pose of each in turn (JAX
    ``run_interleaved``), each through its own ``ScanRollout`` with its own
    state and graphs.

    Each pose draws and replays ``pre`` for every scene and starts each
    scene's flag copy behind it; then, scene by scene, it waits for that
    scene's flags, replays ``plan`` when set, and replays ``post``. A
    scene's flag read thus overlaps the device work queued behind it.
    Results are bit-identical to ``ScanRollout.run`` of the same scene and
    draws. ``seeds`` (one a scene) overrides ``seed + i``; ``variables``
    (an unfolded NBP) goes into every rollout first. Every result's
    ``wall_time_s`` is the shared clock, and ``steps_per_sec`` the
    aggregate ``len(rollouts) * n_poses / wall``. The JAX ``segment_len``
    (a TPU watchdog's knob) is not ported."""
    if seeds is None:
        seeds = [seed + i for i in range(len(rollouts))]
    draws = [r._start_run(n_poses, s, variables)
             for r, s in zip(rollouts, seeds)]
    for r in rollouts:
        _sync(r.device)
    t1 = time.perf_counter()
    for _ in range(n_poses):
        for r, d in zip(rollouts, draws):
            r._draw_pose(d)
            r._step("pre")
            r._start_flag_read(r.pre.regen.reshape(1))
        for r, d in zip(rollouts, draws):
            r._plan_and_post(d, bool(r._finish_flag_read()[0]))
    return _stop_clock([r._result(n_poses) for r in rollouts], t1, n_poses,
                       rollouts[0].device)


def stack_scenes(scenes: Sequence[SceneArrays]) -> SceneArrays:
    """Padded same-shape scenes stacked on a leading scene axis."""
    return SceneArrays(*[torch.stack(ts).contiguous()
                         for ts in zip(*[sc.tensors() for sc in scenes])])


def scene_row(scenes: SceneArrays, b: int) -> SceneArrays:
    """Scene b of stacked scenes, as views."""
    return SceneArrays(*[t[b] for t in scenes.tensors()])


def stacked_buffers(n_scenes: int, capacity: int, device, cls):
    """A stacked storage (B, capacity + 1, 3) and counts (B,) int32, and
    a buffer of type cls (PointBuffer or TrajectoryBuffer) over each row."""
    storage = torch.zeros((n_scenes, capacity + 1, 3), dtype=torch.float32,
                          device=device)
    count = torch.zeros(n_scenes, dtype=torch.int32, device=device)
    return storage, count, [cls.over(storage[b], count[b])
                            for b in range(n_scenes)]


def render_moves(scenes: SceneArrays, old5: torch.Tensor,
                 new5: torch.Tensor, n_steps: int, n_azim: int,
                 intr: CameraIntrinsics):
    """The frames of B moves (old5, new5 (B, 5)) in stacked scenes, rendered
    in one K1 launch: (zbufs (B, n_steps, H, W), R, T, poses
    (B, n_steps, 5))."""
    poses = torch.stack([interpolate_move(o, n, n_steps, n_azim)
                         for o, n in zip(old5, new5)])
    zb, R, T = capture_depth_scenes(scenes.tri_soa, scenes.n_tris, poses,
                                    intr)
    return zb, R, T, poses


class BatchedScanRollout(GraphSteps):
    """Rollouts of several same-lattice scenes with a true scene axis (JAX
    ``BatchedScanRollout`` and ``ScanRollout.make_batched_step``).

    The scenes are padded to common triangle and GT sizes
    (``pad_scene_arrays``; ``scenes`` keeps them, ``scene`` holds them
    stacked) and their state is stacked on a leading scene axis. A pose is
    three CUDA graphs over all B scenes (eagerly on the CPU):

    * ``pre``: the B coverages in one K3 launch, the B loop-start frames in
      one K1 launch, then each scene's regeneration decision and memos;
    * ``plan``, replayed when any scene's flag is set (JAX's scalar
      ``lax.cond(any_regen)``): each scene's projections, one
      (B, S, S, 5) U-Net forward, each scene's fusion and scoring, then
      ``max_plan_retries`` attempts, each one ``nbp_bfs_field`` and one
      ``nbp_extract_path`` launch for the B lattices, every scene masked
      once it is done, as its own single-scene loop; a scene that did not
      regenerate keeps its memo and path (JAX's per-scene selects);
    * ``post``: each scene's next pose, the B x n_steps move frames in one
      K1 launch, and each scene's appends and state update.

    One read of the B regeneration flags a pose is its one sync. Scene i's
    draws come from ``make_draws(seed + i)`` (default ``TorchDraws``), and
    a plan's draws are taken only for the scenes whose flag is set, so each
    scene's stream is that of its single-scene ``ScanRollout`` run. The
    decisions, and so the coverage curve, the trajectory and the point
    count, equal the single-scene runs'; the U-Net at batch B may differ
    from batch 1 in the last bit. The per-scene work runs through one
    ``ScanRollout`` a scene (``members``) whose state, scene arrays and
    weights are views of the stacked ones and of the one folded ``model``.
    """

    def __init__(self, assets_list: Sequence[SceneAssets], model: NBP,
                 params: Optional[Params] = None, max_plan_retries: int = 4,
                 fold_bn: bool = True,
                 make_draws: Optional[Callable[[int], object]] = None,
                 device: DeviceLike = "cuda"):
        if not assets_list:
            raise ValueError("BatchedScanRollout needs at least one scene")
        self.device = dev = resolve_device(device)
        p = params or default_params()
        f_max, g_max = common_sizes(assets_list)
        self.params = p
        self.assets_list = list(assets_list)
        self.n_scenes = len(self.assets_list)
        self.make_draws = make_draws
        self.max_plan_retries = int(max_plan_retries)
        self._fold_bn = fold_bn
        self.model = (fold_bn_model(model) if fold_bn else model).to(dev).eval()
        self.scenes = [pad_scene_arrays(scene_arrays_from_assets(
            a, n_pieces=int(p.n_pieces), device=dev), f_max, g_max)
            for a in self.assets_list]
        self.scene = stack_scenes(self.scenes)
        self.members = [ScanRollout(a, self.model, params=p,
                                    max_plan_retries=max_plan_retries,
                                    fold_bn=False, scene=sc, device=dev)
                        for a, sc in zip(self.assets_list, self.scenes)]
        for b, m in enumerate(self.members):
            m.scene = scene_row(self.scene, b)
        m0 = self.members[0]
        self.intr, self.L, self.H, self.A = m0.intr, m0.L, m0.H, m0.A
        self.n_steps, self.max_len = m0.n_steps, m0.max_len
        self._init_graphs(self.n_scenes)
        self.regen = torch.zeros(self.n_scenes, dtype=torch.bool, device=dev)
        self.state = None
        self._pose_cap = 0
        # The last run's flags, a list of B bools a pose.
        self.regen_poses: List[List[bool]] = []

    def _ensure_capacity(self, n_poses: int) -> None:
        """Stacked static state for n_poses, each member's state a view of
        scene b's rows; a larger rollout reallocates and drops the graphs."""
        if self.state is not None and n_poses <= self._pose_cap:
            return
        B, dev = self.n_scenes, self.device
        cap = max(int(n_poses), MIN_POSE_CAPACITY)
        pc_st, pc_n, pcs = stacked_buffers(
            B, int(self.params.full_pc_capacity), dev, PointBuffer)
        tr_st, tr_n, trs = stacked_buffers(B, 8 * (cap + 4), dev,
                                           TrajectoryBuffer)
        # The fields' shapes and types, from a state of capacity 1.
        one = ScanState.create(1, 1, self.max_len, self.L, self.H, self.A,
                               dev)
        fields = {f.name: torch.zeros((B, *getattr(one, f.name).shape),
                                      dtype=getattr(one, f.name).dtype,
                                      device=dev)
                  for f in dataclasses.fields(ScanState)
                  if f.name not in ("pc", "traj")}
        self.state = dict(fields, pc=pc_st, pc_count=pc_n, traj=tr_st,
                          traj_count=tr_n)
        self.cov_curve = torch.zeros((B, cap), dtype=torch.float32,
                                     device=dev)
        for b, m in enumerate(self.members):
            m.state = ScanState(pc=pcs[b], traj=trs[b],
                                **{k: v[b] for k, v in fields.items()})
            m.cov_curve = self.cov_curve[b]
            m._pose_cap = cap
        self._pose_cap = cap
        self._graphs = {}

    def _init_state(self, draws) -> None:
        """Each scene's initial state, its initial captures in one K1
        launch for the B x n_steps frames."""
        pose0 = torch.stack([m._reset_state() for m in self.members])
        frames = [m._init_draws(d) for m, d in zip(self.members, draws)]
        self._moves(pose0, pose0, [f[0] for f in frames],
                    [f[1] for f in frames])

    def _moves(self, old5: torch.Tensor, new5: torch.Tensor, scores,
               ranks) -> None:
        """B moves (old5, new5 (B, 5)): their frames rendered in one K1
        launch, then each scene's frames appended."""
        zb, R, T, poses = render_moves(self.scene, old5, new5, self.n_steps,
                                       self.A, self.intr)
        for b, m in enumerate(self.members):
            append_move(zb[b], R[b], T[b], poses[b], m.state.pc, m.state.traj,
                        scores[b], self.intr, frame_ranks=ranks[b],
                        batched=m.batched_capture, **m._capture_kw())

    # -- the step ------------------------------------------------------------

    def _pre_step(self) -> None:
        """B coverages (one K3 launch), B loop-start frames (one K1 launch),
        then each scene's regeneration decision and memos."""
        ms, st, sc = self.members, self.state, self.scene
        d = [m.pose_draws for m in ms]
        with record_function("coverage"):
            covs = coverage_percentage_scenes(
                sc.gt, st["pc"][:, :-1], st["pc_count"],
                torch.stack([x.cov_start for x in d]),
                torch.stack([x.cov_stride for x in d]), sc.gt_valid)
        cur5 = torch.stack([m._pose5(m.state.cur) for m in ms])
        with record_function("observe"):
            zb, R, T = capture_depth_scenes(sc.tri_soa, sc.n_tris,
                                            cur5[:, None], self.intr)
            for b, m in enumerate(ms):
                m.state.pc.append(backproject_sample(
                    zb[b, 0], R[b, 0], T[b, 0], self.intr, d[b].obs,
                    ranks_u=d[b].obs_ranks, **m._capture_kw()))
        for b, m in enumerate(ms):
            m._pre_logic(covs[b], cur5[b])
        self.regen.copy_(torch.stack([m.pre.regen for m in ms]))

    def _plan_step(self) -> None:
        """Every scene's plan with one U-Net forward of batch B and one
        launch of each planner kernel an attempt; kept where the scene
        regenerates."""
        ms, B = self.members, self.n_scenes
        L, H = self.L, self.H
        with record_function("plan"):
            inputs = [m._plan_input() for m in ms]
            with record_function("unet"):
                vmaps, omaps = self.model(torch.cat([x[0] for x in inputs]))
            fields = [m._plan_maps(vmaps[b:b + 1], omaps[b:b + 1],
                                   *inputs[b][1:])
                      for b, m in enumerate(ms)]
            start = torch.stack([m.state.cur[:2] for m in ms])
            memo = [m.state.edge_memo for m in ms]
            path = [torch.zeros_like(m.state.path) for m in ms]
            plen = [torch.zeros_like(m.state.path_len) for m in ms]
            done = [torch.zeros((), dtype=torch.bool, device=self.device)
                    for _ in ms]
            for _ in range(self.max_plan_retries):
                blocked = torch.stack([apply_edge_memo(f[1], mm)
                                       for f, mm in zip(fields, memo)])
                dist = bfs_distance_field_scenes(blocked, start, L, H)
                goals = [select_goal(f[0], dist[b], L, H)
                         for b, f in enumerate(fields)]
                path_arr, lens, _ = extract_path_scenes(
                    dist, blocked, torch.stack([g[0] for g in goals]), L, H,
                    max_len=self.max_len)
                for b, m in enumerate(ms):
                    m2, p2, l2, d2 = m._attempt_finish(
                        path_arr[b], lens[b], goals[b][1], fields[b][2],
                        memo[b])
                    memo[b] = torch.where(done[b], memo[b], m2)
                    path[b] = torch.where(done[b], path[b], p2)
                    plen[b] = torch.where(done[b], plen[b], l2)
                    done[b] = done[b] | d2
            for b, m in enumerate(ms):
                s, regen = m.state, m.pre.regen
                s.edge_memo.copy_(torch.where(regen, memo[b], s.edge_memo))
                s.path.copy_(torch.where(regen, path[b], s.path))
                s.path_len.copy_(torch.where(regen, plen[b], s.path_len))

    def _post_step(self) -> None:
        """Each scene's next pose, the B moves' frames in one K1 launch,
        each scene's appends and state update."""
        ms = self.members
        nxt = [m._post_next() for m in ms]
        with record_function("move"):
            self._moves(torch.stack([m.pre.cur_pose5 for m in ms]),
                        torch.stack([m._pose5(n[0]) for m, n in zip(ms, nxt)]),
                        [m.pose_draws.move for m in ms],
                        [m.pose_draws.move_ranks for m in ms])
        for m, (n, record) in zip(ms, nxt):
            m._post_update(n, record)

    # -- the rollout ---------------------------------------------------------

    @torch.no_grad()
    def run(self, n_poses: int = 101, seed: int = 8,
            variables: Optional[NBP] = None) -> List[RolloutResult]:
        """One rollout a scene, scene i from seed + i; ``variables`` (an
        unfolded NBP) replaces the weights first. Each result's wall time is
        the whole batch's, and its rate counts every scene's poses."""
        if variables is not None:
            self.load_weights(variables)
        draws = [self.make_draws(seed + i) if self.make_draws is not None
                 else TorchDraws(seed + i, self.device)
                 for i in range(self.n_scenes)]
        self._ensure_capacity(n_poses)
        if self._use_graphs and not self._graphs:
            self._capture()
        self._init_state(draws)
        self._begin_run()
        self.regen_poses = []
        _sync(self.device)
        t1 = time.perf_counter()
        for _ in range(n_poses):
            for m, d in zip(self.members, draws):
                m._draw_pose(d)
            self._step("pre")
            flags = [bool(f) for f in self._read_flags(self.regen)]
            if any(flags):
                for m, d, f in zip(self.members, draws, flags):
                    if f:
                        m.pose_draws.plan.copy_(
                            d.uniform("plan", (self.max_len, self.A)))
                self._step("plan")
            self._step("post")
            self.regen_poses.append(flags)
        return _stop_clock([m._result(n_poses) for m in self.members], t1,
                           n_poses, self.device)
