"""MACARONS greedy next-best-view evaluation on PyTorch.

Port of ``nextbestpath_tpu/eval/macarons_nbv.py`` (the reference's
testers/scene.py compute_trajectory with the decision core of
train_macarons). A pose:

1. the coverage metric (kernel K3, the exact argsort subsample);
2. the current frame (the last move's final frame) carves the proxy
   occupancy field and updates its view states;
3. SconeOcc predicts occupancy on n_tokens point-cloud tokens and
   n_proxy_tokens proxy points, written back to the field;
4. SconeVis scores the 20 neighbouring poses (4 unit moves x 5 azimuths)
   in one batched call, each by its fov-volume-weighted visibility gain;
5. the agent moves greedily to the best valid neighbour (kernel K1
   renders the move's four frames in one launch).

``oracle=True`` scores each candidate by the GT coverage it would add:
the 20 candidate frames rendered in one K1 launch, each sampled as a
capture samples, their points' distances to the GT in one scene-axis K3
launch, against the points covered now (K3); the models are not used.
The scene tables (K2, once) give the lattice positions and blocked edges.

Draws come in the sequential schedule of ``draws.py`` (a ``begin_group``
a JAX ``next_key()``); the default provider is a ``torch.Generator`` on
the device.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..assets.scene_assets import SceneAssets
from ..config import Params, default_params
from ..device import DeviceLike, resolve_device
from ..draws import TorchDraws
from ..geometry.cameras import CameraIntrinsics, get_camera_RT
from ..models.harmonics import base_view_harmonics
from ..models.scone import SconeOcc, SconeVis
from ..ops.coverage import (compute_auc, coverage_percentage_exact,
                            min_dists, min_sq_dists_scenes)
from ..ops.raytrace import render_depth_batch, tris_to_soa
from ..ops.view_state import compute_view_harmonics
from ..planning.grid_paths import DIRS
from ..sim.coverage_gain import predict_coverage_gain
from ..sim.proxy import ProxyField, carve_with_frame
from ..sim.rollout import TrajectoryBuffer, move_and_capture
from ..sim.sensor import PointBuffer, backproject_sample
from ..sim.tables import build_scene_tables
from ..utils import timing
from ..utils.timing import count, span
from .nbp_planning import RolloutResult

ROT_SHIFTS = (-2, -1, 0, 1, 2)
C_MAX = len(DIRS) * len(ROT_SHIFTS)  # candidate slots a pose
# The rollout's spans (``sample`` and ``scone_vis``
# nest in ``gains``; ``oracle`` replaces carve to gains in the oracle mode).
NBV_STAGES = ("coverage", "carve", "occupancy", "gumbel", "gains", "sample",
              "scone_vis", "oracle", "move")

# The small configuration of the card-against-CPU checks (the JAX
# package's own NBV tests'): 32x56 frames, 1,024 proxy points, narrow
# SCONE models, 128 point-cloud tokens and 64 proxy tokens.
NBV_SMALL = dict(image_height=32, image_width=56, points_per_frame=256,
                 full_pc_capacity=16384, n_gt_surface_points=1024,
                 n_proxy_points=1024, seq_len=64)
SCONE_OCC_SMALL = dict(seq_len=128, n_scale=2, k_for_knn=4,
                       pts_embedding_dim=32, global_feature_dim=64,
                       local_feature_dim=32, x_embedding_dim=64)
SCONE_VIS_SMALL = dict(pts_embedding_dim=64)
NBV_SMALL_TOKENS = dict(n_tokens=128, n_proxy_tokens=64)


def seeded_scone(seed: int = 0, small: bool = False
                 ) -> Tuple[SconeOcc, SconeVis]:
    """SconeOcc and SconeVis with random weights from ``seed``, at the
    published widths or (``small``) at SCONE_*_SMALL."""
    torch.manual_seed(seed)
    occ = SconeOcc(**(SCONE_OCC_SMALL if small else {}))
    vis = SconeVis(**(SCONE_VIS_SMALL if small else {}))
    return occ.eval(), vis.eval()


def _oracle_gains(tri_soa: torch.Tensor, n_tris: torch.Tensor,
                  cand_pose5: torch.Tensor, gt: torch.Tensor,
                  covered_now: torch.Tensor, scores, intr: CameraIntrinsics,
                  n_slots: int, gathering_factor: float, sensor_range: float,
                  threshold: float = 1.0) -> torch.Tensor:
    """Ground-truth greedy gain: the share of GT points a candidate's
    frame would newly cover, (C,). Every candidate is rendered (one K1
    launch) and sampled with the capture's density, its pixel scores
    ``scores[c]``; the distances of the GT to each frame's points come
    from one scene-axis K3 launch."""
    R, T = get_camera_RT(cand_pose5[:, :3], cand_pose5[:, 3:])
    zb = render_depth_batch(tri_soa, n_tris, R, T, intr)
    C = cand_pose5.shape[0]
    frames = [backproject_sample(zb[c], R[c], T[c], intr, scores[c], n_slots,
                                 gathering_factor=gathering_factor,
                                 sensor_range=sensor_range)
              for c in range(C)]
    # The valid rows of a frame lead, so its count bounds K3's loop.
    s = torch.stack([f.points for f in frames]).contiguous()
    counts = torch.stack([f.valid.sum() for f in frames]).to(torch.int32)
    g = gt.to(torch.float32).expand(C, -1, -1).contiguous()
    d = torch.sqrt(torch.clamp(min_sq_dists_scenes(g, s, counts), min=0.0))
    newly = ((d < threshold) & ~covered_now[None, :]).sum(dim=1)
    return newly.to(torch.float32) / gt.shape[0]


def _sample_tokens(draws, points: torch.Tensor, count: torch.Tensor,
                   n_tokens: int = 1024) -> torch.Tensor:
    """n_tokens points drawn with replacement from the buffer's valid
    prefix (appends keep the valid rows in front)."""
    idx = draws.randint("tokens", 0, torch.clamp(count, min=1),
                        shape=(n_tokens,))
    return points[idx]


def _write_last(proba: torch.Tensor, idx: torch.Tensor,
                values: torch.Tensor) -> None:
    """proba[idx] = values with a defined winner: where idx repeats, the
    last occurrence's value is written (a scatter with repeated indices
    has none on the card)."""
    pos = torch.arange(idx.shape[0], device=idx.device)
    last = torch.full((proba.shape[0],), -1, dtype=torch.int64,
                      device=idx.device)
    last.scatter_reduce_(0, idx, pos, reduce="amax")
    keep = last[idx] == pos
    proba[idx[keep]] = values[keep]


def neighbour_candidates(cur: Tuple[int, int, int], blocked: np.ndarray,
                         L: int, H: int, n_azim: int):
    """The 4 x 5 neighbour slots (a unit move times an azimuth shift) and
    their validity; an invalid slot holds the current pose."""
    cands: List[Tuple[int, int, int]] = []
    valid = np.zeros((C_MAX,), bool)
    for d, (dl, dh) in enumerate(DIRS):
        nl, nh = cur[0] + dl, cur[1] + dh
        ok = (0 <= nl < L and 0 <= nh < H
              and not blocked[d, cur[0], cur[1]])
        for rot_shift in ROT_SHIFTS:
            cands.append((nl, nh, (cur[2] + rot_shift) % n_azim) if ok
                         else (cur[0], cur[1], cur[2]))
            valid[len(cands) - 1] = ok
    return cands, valid


@torch.inference_mode()
def macarons_nbv_rollout(
    assets: SceneAssets,
    scone_occ: Optional[SconeOcc], scone_vis: Optional[SconeVis],
    params: Optional[Params] = None,
    n_poses: int = 100, seed: int = 8,
    n_tokens: int = 1024,
    n_proxy_tokens: int = 1024,
    vis_tokens: Optional[int] = None,
    oracle: bool = False,
    verbose: bool = False,
    draws=None,
    device: DeviceLike = "cuda",
) -> RolloutResult:
    """The greedy NBV rollout (module docstring). ``oracle=True`` swaps
    the learned gain for the GT gain (pass None for the models). draws: a
    provider in the sequential schedule (default ``TorchDraws(seed)`` on
    the device). ``vis_tokens``: the tokens of each candidate's SconeVis
    call; None takes ``min(params.seq_len, 1024)``, the JAX package's cap.

    The pose loop runs inside a run record of kind ``nbv`` (units
    ``poses`` and ``candidates``, the valid candidates summed over the
    poses) with the counters ``vis_tokens`` (tokens through SconeVis),
    ``occ_queries`` (proxy queries through SconeOcc), ``host_reads`` (the
    coverage and the argmax, two a pose), ``launches`` (the loop's
    change of ``kernels.LAUNCHES``), and from ``predict_coverage_gain``
    ``token_draws`` (the candidates whose tokens were drawn, C a learned
    pose) and ``kernel_draws`` (those drawn by the kernel G2, on a
    card)."""
    dev = resolve_device(device)
    p = params or default_params()
    draws = draws if draws is not None else TorchDraws(seed, dev)

    def group(role: str):
        draws.begin_group(role)
        return role

    if not oracle:
        scone_occ = scone_occ.to(dev).eval()
        scone_vis = scone_vis.to(dev).eval()
    intr = CameraIntrinsics(
        image_height=int(p.image_height), image_width=int(p.image_width),
        fov_degrees=float(p.fov_degrees), znear=float(p.camera_znear),
        zfar=float(p.zfar))
    n_px = intr.image_height * intr.image_width
    n_steps = int(p.n_interpolation_steps)
    cap_kw = dict(n_slots=int(p.points_per_frame),
                  gathering_factor=float(p.gathering_factor),
                  sensor_range=float(p.sensor_range))
    tri_soa = tris_to_soa(torch.from_numpy(assets.tris).to(dev))
    n_tris = torch.tensor([assets.n_tris], dtype=torch.int32, device=dev)
    gt = torch.from_numpy(assets.gt_surface).to(dev)
    L, H, n_azim = assets.pose_l, assets.pose_h, assets.n_azim
    tables = build_scene_tables(tri_soa, n_tris,
                                torch.from_numpy(assets.pose_origin).to(dev),
                                L, H)
    blocked = tables.gt_edge_blocked.cpu().numpy()
    positions = tables.positions.cpu().numpy()

    n_elev_vs = int(p.view_state_n_elev)
    n_azim_vs = int(p.view_state_n_azim)
    base_h, h_polar = base_view_harmonics(n_elev_vs, n_azim_vs,
                                          int(p.harmonic_degree), device=dev)

    def f32(x):
        return torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)

    sx_min = f32(assets.settings.scene.x_min - 0.2)
    sx_max = f32(assets.settings.scene.x_max + 0.2)
    n_proxy = int(p.n_proxy_points)
    proxy = ProxyField.create(draws.uniform(group("proxy"), (n_proxy, 3)),
                              sx_min, sx_max, n_elev_vs, n_azim_vs)
    box_center = (sx_min + sx_max) / 2.0
    box_diag = torch.linalg.norm(sx_max - sx_min)
    seq_len = (min(int(p.seq_len), 1024) if vis_tokens is None
               else int(vis_tokens))
    min_occ = float(p.get("min_occ_for_proxy_points", 0.1))
    elev2 = float(assets.elevations_deg[2])

    def pose5_np(idx) -> np.ndarray:
        pos = positions[idx[0], idx[1]]
        return np.asarray([pos[0], pos[1], pos[2], elev2,
                           assets.azimuths_deg[idx[2]]], np.float32)

    def pose5(idx) -> torch.Tensor:
        return torch.from_numpy(pose5_np(idx)).to(dev)

    def move(old, new):
        role = group("move")
        scores = [draws.uniform(role, (n_px,), step=s)
                  for s in range(1, n_steps + 1)]
        return move_and_capture(tri_soa, n_tris, old, new, pc, traj, scores,
                                intr, n_steps=n_steps, n_azim=n_azim,
                                **cap_kw)[2]

    pc = PointBuffer.create(int(p.full_pc_capacity), dev)
    traj = TrajectoryBuffer.create(8 * (n_poses + 4), dev)
    start = assets.start_cam_idx
    cur = (int(start[0]), int(start[2]), int(start[4]))

    t1 = time.time()
    pose0 = pose5(cur)
    group("init")
    scores0 = [draws.uniform("init", (n_px,), step=s)
               for s in range(1, n_steps + 1)]
    last_zbuf = move_and_capture(tri_soa, n_tris, pose0, pose0, pc, traj,
                                 scores0, intr, n_steps=n_steps,
                                 n_azim=n_azim, **cap_kw)[2]

    coverage_evolution: List[float] = []
    launches0 = sum(kernels.LAUNCHES.values())
    with timing.run("nbv", poses=n_poses, candidates=0) as rec:
        for pose_i in range(n_poses):
            with span("coverage"):
                scores = draws.uniform(group("cov"), (pc.capacity,))
                cov = float(coverage_percentage_exact(gt, pc.points,
                                                      pc.count, scores))
                count("host_reads")
            coverage_evolution.append(cov)
            if verbose and pose_i % 10 == 0:
                print(f"nbv pose {pose_i}: coverage {cov:.4f}")

            cur_pose = pose5(cur)
            # The last move's final frame is the current pose's frame.
            R, T = get_camera_RT(cur_pose[None, :3], cur_pose[None, 3:])
            R, T = R[0], T[0]
            if not oracle:
                with span("carve"):
                    proxy = carve_with_frame(
                        proxy, last_zbuf, R, T, cur_pose[:3], intr,
                        score_threshold=float(p.score_threshold),
                        carving_tolerance=float(p.carving_tolerance),
                        n_elev=n_elev_vs, n_azim=n_azim_vs,
                        sensor_range=float(p.sensor_range))
                with span("occupancy"):
                    group("tokens")
                    pc_tokens = _sample_tokens(draws, pc.points, pc.count,
                                               n_tokens)
                    vs_idx = draws.randint(group("vs_idx"), 0, n_proxy,
                                           shape=(n_proxy_tokens,))
                    vh = compute_view_harmonics(
                        proxy.view_states[None, vs_idx], base_h, h_polar,
                        n_elev_vs, n_azim_vs)
                    occ = scone_occ(
                        ((pc_tokens - box_center) / box_diag)[None],
                        ((proxy.points[vs_idx] - box_center)
                         / box_diag)[None],
                        vh, draws=draws, role=group("occ"))
                    _write_last(proxy.proba, vs_idx, occ[0])
                    count("occ_queries", n_proxy_tokens)

            cands, cand_valid = neighbour_candidates(cur, blocked, L, H,
                                                     n_azim)
            if not cand_valid.any():
                rot = int(draws.randint(group("rot"), 0, n_azim))
                cands[0] = (cur[0], cur[1], rot)
                cand_valid[0] = True
            rec.units["candidates"] += int(cand_valid.sum())
            cand_pose5 = torch.from_numpy(
                np.stack([pose5_np(c) for c in cands])).to(dev)
            if oracle:
                with span("oracle"):
                    covered_now = min_dists(gt, pc.points, pc.valid_mask(),
                                            s_count=pc.count) < 1.0
                    role = group("oracle")
                    scores = draws.uniforms(role, [(n_px,)] * C_MAX)
                    gains = _oracle_gains(tri_soa, n_tris, cand_pose5, gt,
                                          covered_now, scores, intr,
                                          **cap_kw)
            else:
                with span("gumbel"):
                    role = group("gain")
                    noise = draws.gumbels(role,
                                          [(seq_len, n_proxy)] * C_MAX)
                with span("gains"):
                    all_vh = compute_view_harmonics(
                        proxy.view_states[None], base_h, h_polar, n_elev_vs,
                        n_azim_vs)[0]
                    gains = predict_coverage_gain(
                        noise, scone_vis, proxy.points, proxy.proba, all_vh,
                        cand_pose5, intr, sx_min, sx_max,
                        sensor_range=float(p.sensor_range), min_occ=min_occ)
                count("vis_tokens", C_MAX * seq_len)
                del noise
            gains = torch.where(torch.from_numpy(cand_valid).to(dev), gains,
                                torch.full_like(gains, -float("inf")))
            nxt = cands[int(torch.argmax(gains))]
            count("host_reads")
            with span("move"):
                last_zbuf = move(cur_pose, pose5(nxt))
            cur = nxt
        count("launches", sum(kernels.LAUNCHES.values()) - launches0)

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
