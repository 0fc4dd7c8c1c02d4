"""Depth sensor: render -> mask -> backproject -> fixed-budget subsample.

Port of ``nextbestpath_tpu/sim/sensor.py`` (perfect-depth path): depth is
the rendered zbuf clamped to [znear, zfar], the mask is zbuf > -1, and a
random ``gathering_factor`` share of the valid pixels within
``sensor_range`` is unprojected to world points.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

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


def backproject_sample(zbuf: torch.Tensor, R: torch.Tensor, T: torch.Tensor,
                       intr: CameraIntrinsics, scores_u: torch.Tensor,
                       n_slots: int, gathering_factor: float = 0.05,
                       sensor_range: float = 70.0, znear_clamp: float = 0.5,
                       zfar_clamp: float = 750.0) -> FramePoints:
    """Random share of the valid depth pixels unprojected to world points.

    scores_u: (H*W,) uniform [0, 1) draws, one per pixel (the iid draw; the
    stratified draw of the JAX package is not ported yet). The n_slots
    smallest scores among valid pixels are taken, valid ones first and ties
    to the lower pixel index, as ``lax.top_k`` orders them; the first
    ``n_keep = min(int(gathering_factor * n_valid), n_slots)`` are kept.
    """
    H, W = zbuf.shape
    mask = (zbuf > -1.0).reshape(-1)
    depth = torch.clamp(zbuf, znear_clamp, zfar_clamp).reshape(-1)
    valid = mask & (depth < sensor_range)
    n_valid = valid.sum().to(torch.float32)
    n_keep = torch.clamp((n_valid * gathering_factor).to(torch.int32),
                         max=n_slots)
    scores = torch.where(valid, scores_u.to(torch.float32),
                         torch.full_like(depth, 2.0))
    idx = torch.sort(scores, stable=True).indices[:n_slots]
    slot = torch.arange(n_slots, device=zbuf.device)
    slot_valid = (slot < n_keep) & valid[idx]

    d_view = intr.pixel_ray_dirs_view(zbuf.device).reshape(-1, 3)[idx]
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
        dropped. Only the prefix-valid layout (every backproject_sample
        batch) is ported: ``prefix_valid=False`` raises."""
        if not prefix_valid:
            raise NotImplementedError("only prefix-valid batches are ported")
        cap = self.capacity
        slots = self.count + torch.arange(batch.points.shape[0],
                                          device=self._storage.device)
        ok = batch.valid & (slots < cap)
        slots = torch.where(ok, slots, torch.full_like(slots, cap))
        self._storage.index_copy_(0, slots.long(),
                                  batch.points.to(torch.float32))
        n_new = batch.valid.sum().to(torch.int32)
        self.count.copy_(torch.clamp(self.count + n_new, max=cap))
        return self
