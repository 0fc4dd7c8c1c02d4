"""Rollout state and the move/capture stage.

Port of ``nextbestpath_tpu/sim/rollout.py``: per move, the camera linearly
interpolates over ``n_steps`` substeps (azimuth wrapping the short way),
renders the substeps' depth frames together and appends each frame's
sampled points to the cloud in order; the frame of the arrival pose is
processed again at the start of the next pose (``observe_current``), so a
pose contributes five frames.

Each frame's random pixel scores are an input (``frame_scores``), drawn by
the caller from a provider in ``draws.py``; ``frame_ranks``, the strata's
ranks, selects the stratified draw. ``batched=True`` lands a move's frames
with one scatter into the cloud and one into the trajectory (JAX
``batched=True``) instead of one append a substep.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..geometry.cameras import CameraIntrinsics
from .sensor import (PointBuffer, backproject_sample, capture_depth,
                     capture_depth_batch)


class TrajectoryBuffer:
    """Fixed-capacity history of interpolated camera positions; mutable,
    written in place, its count included (a CUDA graph replays its appends
    into the same storage). Appends past capacity overwrite the last
    slot."""

    def __init__(self, capacity: int, device):
        # One scratch row past capacity takes the writes append_many drops.
        self._storage = torch.zeros((capacity + 1, 3), dtype=torch.float32,
                                    device=device)
        self.count = torch.zeros((), dtype=torch.int32, device=device)

    @property
    def xyz(self) -> torch.Tensor:
        return self._storage[:-1]

    @staticmethod
    def create(capacity: int, device) -> "TrajectoryBuffer":
        return TrajectoryBuffer(capacity, device)

    @classmethod
    def over(cls, storage: torch.Tensor, count: torch.Tensor):
        """A buffer over existing tensors (a row of a stacked storage and
        its count), written in place."""
        buf = cls.__new__(cls)
        buf._storage, buf.count = storage, count
        return buf

    def append(self, pos: torch.Tensor) -> "TrajectoryBuffer":
        cap = self.xyz.shape[0]
        slot = torch.clamp(self.count, max=cap - 1).long()
        self.xyz.index_copy_(0, slot.reshape(1), pos.reshape(1, 3))
        self.count.copy_(torch.clamp(self.count + 1, max=cap))
        return self

    def append_many(self, xyz: torch.Tensor) -> "TrajectoryBuffer":
        """Append B positions (B, 3) in order with one scatter, as B
        ``append`` calls: past capacity the last slot takes the last
        position, and the positions that would be overwritten go to a
        discarded row."""
        B = xyz.shape[0]
        cap = self.xyz.shape[0]
        k = torch.arange(B, device=xyz.device)
        slots = self.count + k
        keep = (slots < cap - 1) | (k == B - 1)
        slots = torch.where(keep, torch.clamp(slots, max=cap - 1),
                            torch.full_like(slots, cap))
        self._storage.index_copy_(0, slots.long(), xyz.to(torch.float32))
        self.count.copy_(torch.clamp(self.count + B, max=cap))
        return self

    def valid_mask(self) -> torch.Tensor:
        return (torch.arange(self.xyz.shape[0], device=self.xyz.device)
                < self.count)


def interpolate_pose(old_pose5: torch.Tensor, new_pose5: torch.Tensor,
                     step: int, n_steps: int, n_azim: int) -> torch.Tensor:
    """Linear pose interpolation with azimuth wraparound: between azimuth
    indices 0 and n_azim-1 the intermediate steps go the short way round
    (offset +-360); the final step lands exactly on the new pose."""
    frac = torch.full((), float(step), dtype=torch.float32,
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
                     sensor_range: float = 70.0,
                     frame_ranks: Optional[Sequence[torch.Tensor]] = None,
                     batched: bool = False
                     ) -> Tuple[PointBuffer, "TrajectoryBuffer", torch.Tensor]:
    """One lattice move: the n_steps interpolated poses rendered together
    (one K1 launch on the card), then each substep backprojected and
    subsampled with ``frame_scores[s - 1]`` (and ``frame_ranks[s - 1]``
    for the stratified draw) and appended in order, a substep at a time or
    (``batched``) all with one scatter. Returns (pc, traj, last_zbuf)."""
    poses = interpolate_move(old_pose5, new_pose5, n_steps, n_azim)
    zbufs, Rs, Ts = capture_depth_batch(tri_soa, n_tris, poses, intr)
    append_move(zbufs, Rs, Ts, poses, pc, traj, frame_scores, intr,
                n_slots=n_slots, gathering_factor=gathering_factor,
                sensor_range=sensor_range, frame_ranks=frame_ranks,
                batched=batched)
    return pc, traj, zbufs[-1]


def append_move(zbufs: torch.Tensor, Rs: torch.Tensor, Ts: torch.Tensor,
                poses: torch.Tensor, pc: PointBuffer,
                traj: "TrajectoryBuffer",
                frame_scores: Sequence[torch.Tensor], intr: CameraIntrinsics,
                n_slots: int = 6144, gathering_factor: float = 0.05,
                sensor_range: float = 70.0,
                frame_ranks: Optional[Sequence[torch.Tensor]] = None,
                batched: bool = False) -> None:
    """The second half of ``move_and_capture``, on a move's rendered frames
    (zbufs (K, H, W), Rs, Ts and poses (K, 5)): each frame sampled and
    appended in order, or (``batched``) all with one scatter."""
    batches = []
    for i in range(zbufs.shape[0]):
        batch = backproject_sample(
            zbufs[i], Rs[i], Ts[i], intr, frame_scores[i], n_slots,
            gathering_factor=gathering_factor, sensor_range=sensor_range,
            ranks_u=None if frame_ranks is None else frame_ranks[i])
        if batched:
            batches.append(batch)
        else:
            pc.append(batch, prefix_valid=True)
            traj.append(poses[i, :3])
    if batched:
        pc.append_batches(torch.stack([b.points for b in batches]),
                          torch.stack([b.valid for b in batches]))
        traj.append_many(poses[:, :3])


def observe_current(tri_soa: torch.Tensor, n_tris, pose5: torch.Tensor,
                    pc: PointBuffer, frame_scores: torch.Tensor,
                    intr: CameraIntrinsics, n_slots: int = 6144,
                    gathering_factor: float = 0.05,
                    sensor_range: float = 70.0,
                    frame_ranks: Optional[torch.Tensor] = None
                    ) -> PointBuffer:
    """The loop-start frame: the current pose rendered again and a second,
    independently sampled batch of its points appended."""
    zbuf, R, T = capture_depth(tri_soa, n_tris, pose5, intr)
    batch = backproject_sample(zbuf, R, T, intr, frame_scores, n_slots,
                               gathering_factor=gathering_factor,
                               sensor_range=sensor_range, ranks_u=frame_ranks)
    return pc.append(batch, prefix_valid=True)
