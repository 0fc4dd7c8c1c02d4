"""Depth sensor: render -> mask -> backproject -> fixed-budget subsample.

Port of ``nextbestpath_tpu/sim/sensor.py`` (perfect-depth path): depth is
the rendered zbuf clamped to [znear, zfar], the mask is zbuf > -1, and a
random ``gathering_factor`` share of the valid pixels within
``sensor_range`` is unprojected to world points, drawn iid or stratified.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..geometry.cameras import (CameraIntrinsics, _mat3, camera_center,
                                get_camera_RT)
from ..ops.raytrace import render_depth_batch


class FramePoints(NamedTuple):
    """Fixed-size backprojected point batch from one frame."""

    points: torch.Tensor  # (P, 3) world points (garbage where ~valid)
    valid: torch.Tensor   # (P,) bool, a leading prefix


def capture_depth_batch(tri_soa: torch.Tensor, n_tris, poses5: torch.Tensor,
                        intr: CameraIntrinsics
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Depth frames for B 5-D poses (B, 5), rendered together (one K1
    launch on the card). Returns (zbufs (B, H, W), R (B, 3, 3), T (B, 3))."""
    R, T = get_camera_RT(poses5[:, :3], poses5[:, 3:])
    return render_depth_batch(tri_soa, n_tris, R, T, intr), R, T


def capture_depth(tri_soa: torch.Tensor, n_tris, pose5: torch.Tensor,
                  intr: CameraIntrinsics
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Render a depth frame for a 5-D pose. Returns (zbuf, R, T)."""
    zbuf, R, T = capture_depth_batch(tri_soa, n_tris, pose5[None], intr)
    return zbuf[0], R[0], T[0]


def stratified_applies(n_px: int, n_slots: int,
                       gathering_factor: float) -> bool:
    """Whether the stratified draw replaces the iid one: only when a
    stratum of ceil(n_px / n_slots) pixels keeps at most one point
    (``gathering_factor * group <= 1``), which bounds n_keep by the
    non-empty strata. 256x456 frames and 6144 slots give group 19."""
    group = -(-n_px // n_slots)
    return gathering_factor * group <= 1.0


def backproject_sample(zbuf: torch.Tensor, R: torch.Tensor, T: torch.Tensor,
                       intr: CameraIntrinsics, scores_u: torch.Tensor,
                       n_slots: int, gathering_factor: float = 0.05,
                       sensor_range: float = 70.0, znear_clamp: float = 0.5,
                       zfar_clamp: float = 750.0,
                       ranks_u: Optional[torch.Tensor] = None) -> FramePoints:
    """Random share of the valid depth pixels unprojected to world points.

    scores_u: (H*W,) uniform [0, 1) draws, one per pixel. The first
    ``n_keep = min(int(gathering_factor * n_valid), n_slots)`` slots are
    kept.

    * The iid draw (``ranks_u`` None): the n_slots smallest scores among
      valid pixels, valid ones first and ties to the lower pixel index, as
      ``lax.top_k`` orders them.
    * The stratified draw (``ranks_u`` (n_slots,) draws, the split key's
      second half; only where ``stratified_applies``): the image, padded to
      n_slots strata of ``group`` pixels with score 2.0, gives each stratum
      its smallest-scoring pixel (the first on ties), and the strata with a
      valid pixel are ranked by ``ranks_u`` with a stable argsort.
    """
    H, W = zbuf.shape
    n_px = H * W
    dev = zbuf.device
    mask = (zbuf > -1.0).reshape(-1)
    depth = torch.clamp(zbuf, znear_clamp, zfar_clamp).reshape(-1)
    valid = mask & (depth < sensor_range)
    n_valid = valid.sum().to(torch.float32)
    n_keep = torch.clamp((n_valid * gathering_factor).to(torch.int32),
                         max=n_slots)
    scores = torch.where(valid, scores_u.to(torch.float32),
                         torch.full_like(depth, 2.0))
    slot = torch.arange(n_slots, device=dev)
    if ranks_u is not None:
        group = -(-n_px // n_slots)
        padded = F.pad(scores, (0, n_slots * group - n_px), value=2.0)
        win_score, win = padded.view(n_slots, group).min(dim=1)
        idx0 = slot * group + win
        group_valid = win_score < 1.5
        rank = torch.where(group_valid, ranks_u.to(torch.float32),
                           torch.full_like(win_score, 2.0))
        order = torch.sort(rank, stable=True).indices
        idx = torch.clamp(idx0[order], max=n_px - 1)
        slot_valid = (slot < n_keep) & group_valid[order]
    else:
        idx = torch.sort(scores, stable=True).indices[:n_slots]
        slot_valid = (slot < n_keep) & valid[idx]

    d_view = intr.pixel_ray_dirs_view(dev).reshape(-1, 3)[idx]
    d_world = _mat3(d_view, R.T)
    eye = camera_center(R, T)
    pts = eye[None, :] + depth[idx][:, None] * d_world
    return FramePoints(points=pts, valid=slot_valid)


class PointBuffer:
    """Append-only fixed-capacity point cloud (the reference's full_pc).

    Mutable, unlike the JAX NamedTuple: ``append`` writes in place into a
    preallocated buffer, which saves a 24 MB copy per frame at the 2M
    default capacity. The storage has one scratch row past ``capacity`` that
    takes the rows an append drops. ``count`` stays a device tensor and is
    updated in place, so a CUDA graph replays appends into the same
    storage."""

    def __init__(self, capacity: int, device):
        self._storage = torch.zeros((capacity + 1, 3), dtype=torch.float32,
                                    device=device)
        self.count = torch.zeros((), dtype=torch.int32, device=device)

    @staticmethod
    def create(capacity: int, device) -> "PointBuffer":
        return PointBuffer(capacity, device)

    @property
    def capacity(self) -> int:
        return self._storage.shape[0] - 1

    @property
    def points(self) -> torch.Tensor:
        return self._storage[:-1]

    def valid_mask(self) -> torch.Tensor:
        return (torch.arange(self.capacity, device=self._storage.device)
                < self.count)

    def append(self, batch: FramePoints, prefix_valid: bool = True
               ) -> "PointBuffer":
        """Append the batch's valid points in order; rows past capacity are
        dropped. ``prefix_valid`` says the valid rows lead (every
        backproject_sample batch); otherwise they are first compacted to
        the front by a stable argsort, in their order."""
        points, valid = batch.points, batch.valid
        n_new = valid.sum().to(torch.int32)
        if not prefix_valid:
            order = torch.sort((~valid).to(torch.uint8), stable=True).indices
            points = points[order]
            valid = (torch.arange(points.shape[0], device=points.device)
                     < n_new)
        self._write(points.reshape(1, -1, 3), valid.reshape(1, -1),
                    n_new.reshape(1))
        return self

    def append_batches(self, points: torch.Tensor, valid: torch.Tensor
                       ) -> "PointBuffer":
        """Append B prefix-valid batches in order with one scatter: points
        (B, P, 3), valid (B, P). Batch b lands at count + the valid rows of
        batches before it, the layout of B ``append`` calls, and rows past
        capacity are dropped alike."""
        self._write(points, valid, valid.sum(dim=1).to(torch.int32))
        return self

    def _write(self, points: torch.Tensor, valid: torch.Tensor,
               counts: torch.Tensor) -> None:
        cap = self.capacity
        offsets = torch.cumsum(counts, 0) - counts
        slots = (self.count + offsets[:, None]
                 + torch.arange(points.shape[1], device=points.device))
        ok = valid & (slots < cap)
        slots = torch.where(ok, slots, torch.full_like(slots, cap))
        self._storage.index_copy_(0, slots.reshape(-1).long(),
                                  points.reshape(-1, 3).to(torch.float32))
        self.count.copy_(torch.clamp(self.count + counts.sum(), max=cap))
