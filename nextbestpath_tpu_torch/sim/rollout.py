"""Rollout state and the move/capture stage.

Port of ``nextbestpath_tpu/sim/rollout.py``: per move, the camera linearly
interpolates over ``n_steps`` substeps (azimuth wrapping the short way),
renders the substeps' depth frames together and appends each frame's
sampled points to the cloud in order; the frame of the arrival pose is
processed again at the start of the next pose (``observe_current``), so a
pose contributes five frames.

Each frame's random pixel scores are an input (``frame_scores``), drawn by
the caller from a provider in ``draws.py``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..geometry.cameras import CameraIntrinsics
from .sensor import (PointBuffer, backproject_sample, capture_depth,
                     capture_depth_batch)


class TrajectoryBuffer:
    """Fixed-capacity history of interpolated camera positions; mutable,
    written in place. Appends past capacity overwrite the last slot."""

    def __init__(self, capacity: int, device):
        self.xyz = torch.zeros((capacity, 3), dtype=torch.float32,
                               device=device)
        self.count = torch.zeros((), dtype=torch.int32, device=device)

    @staticmethod
    def create(capacity: int, device) -> "TrajectoryBuffer":
        return TrajectoryBuffer(capacity, device)

    def append(self, pos: torch.Tensor) -> "TrajectoryBuffer":
        cap = self.xyz.shape[0]
        slot = torch.clamp(self.count, max=cap - 1).long()
        self.xyz.index_copy_(0, slot.reshape(1), pos.reshape(1, 3))
        self.count = torch.clamp(self.count + 1, max=cap)
        return self

    def valid_mask(self) -> torch.Tensor:
        return (torch.arange(self.xyz.shape[0], device=self.xyz.device)
                < self.count)


def interpolate_pose(old_pose5: torch.Tensor, new_pose5: torch.Tensor,
                     step: int, n_steps: int, n_azim: int) -> torch.Tensor:
    """Linear pose interpolation with azimuth wraparound: between azimuth
    indices 0 and n_azim-1 the intermediate steps go the short way round
    (offset +-360); the final step lands exactly on the new pose."""
    frac = torch.tensor(float(step), dtype=torch.float32,
                        device=old_pose5.device) / n_steps
    pose = old_pose5 + (new_pose5 - old_pose5) * frac
    azim_step = 360.0 / n_azim
    old_a = old_pose5[4]
    new_a = new_pose5[4]
    if step == n_steps:
        return torch.cat([pose[:4], new_a.reshape(1)])
    wrap_hi = (old_a < azim_step / 2.0) & (new_a > 360.0 - 1.5 * azim_step)
    wrap_lo = (new_a < azim_step / 2.0) & (old_a > 360.0 - 1.5 * azim_step)
    zero = torch.zeros_like(old_a)
    offset = torch.where(wrap_hi, zero - 360.0,
                         torch.where(wrap_lo, zero + 360.0, zero))
    azim = old_a + ((new_a + offset) - old_a) * frac
    return torch.cat([pose[:4], azim.reshape(1)])


def interpolate_move(old_pose5: torch.Tensor, new_pose5: torch.Tensor,
                     n_steps: int, n_azim: int) -> torch.Tensor:
    """The poses of substeps 1..n_steps of a move, (n_steps, 5)."""
    return torch.stack([interpolate_pose(old_pose5, new_pose5, s, n_steps,
                                         n_azim)
                        for s in range(1, n_steps + 1)])


def move_and_capture(tri_soa: torch.Tensor, n_tris, old_pose5: torch.Tensor,
                     new_pose5: torch.Tensor, pc: PointBuffer,
                     traj: "TrajectoryBuffer",
                     frame_scores: Sequence[torch.Tensor],
                     intr: CameraIntrinsics, n_steps: int = 4,
                     n_azim: int = 8, n_slots: int = 6144,
                     gathering_factor: float = 0.05,
                     sensor_range: float = 70.0
                     ) -> Tuple[PointBuffer, "TrajectoryBuffer", torch.Tensor]:
    """One lattice move: the n_steps interpolated poses rendered together
    (one K1 launch on the card), then each substep backprojected,
    subsampled with ``frame_scores[s - 1]`` and appended in order. Returns
    (pc, traj, last_zbuf)."""
    poses = interpolate_move(old_pose5, new_pose5, n_steps, n_azim)
    zbufs, Rs, Ts = capture_depth_batch(tri_soa, n_tris, poses, intr)
    for i in range(n_steps):
        batch = backproject_sample(zbufs[i], Rs[i], Ts[i], intr,
                                   frame_scores[i], n_slots,
                                   gathering_factor=gathering_factor,
                                   sensor_range=sensor_range)
        pc.append(batch, prefix_valid=True)
        traj.append(poses[i, :3])
    return pc, traj, zbufs[-1]


def observe_current(tri_soa: torch.Tensor, n_tris, pose5: torch.Tensor,
                    pc: PointBuffer, frame_scores: torch.Tensor,
                    intr: CameraIntrinsics, n_slots: int = 6144,
                    gathering_factor: float = 0.05,
                    sensor_range: float = 70.0) -> PointBuffer:
    """The loop-start frame: the current pose rendered again and a second,
    independently sampled batch of its points appended."""
    zbuf, R, T = capture_depth(tri_soa, n_tris, pose5, intr)
    batch = backproject_sample(zbuf, R, T, intr, frame_scores, n_slots,
                               gathering_factor=gathering_factor,
                               sensor_range=sensor_range)
    return pc.append(batch, prefix_valid=True)
