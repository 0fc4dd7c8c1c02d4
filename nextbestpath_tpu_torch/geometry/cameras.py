"""FoV perspective camera math in the PyTorch3D conventions.

Port of ``nextbestpath_tpu/geometry/cameras.py``; the conventions are the
ones ``tests/test_cameras.py`` pins:

* row-vector world-to-view ``X_view = X_world @ R + T`` with ``T = -eye @ R``,
* look-at axes ``z = normalize(at - eye)``, ``x = normalize(cross(up, z))``,
  ``y = cross(z, x)``, ``up = (0, 1, 0)``; R's columns are the axes,
* view direction of a pose ``(x, y, z, elev, azim)``:
  ``(cos e sin a, sin e, cos e cos a)``,
* FoV projection ``x_proj = x_view / (tan(fov/2) * z_view)``,
* NDC pixel tables ``ndc_x[j] = W/m - 2 j/(m-1)``, ``m = min(H, W)``,
* depth is view-space z: pixel rays have ``d_z == 1``.

3x3 products are written out as elementwise f32 multiply-adds in a fixed
order, so that they round alike on the CPU and on the card (no BLAS, no
TF32).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

DEFAULT_FOV_DEGREES = 60.0


def _mat3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for (..., 3) @ (..., 3, 3), batch dims broadcast, summed in
    index order."""
    return ((a[..., 0:1] * b[..., 0, :] + a[..., 1:2] * b[..., 1, :])
            + a[..., 2:3] * b[..., 2, :])


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def camera_ray_from_pose_angles(elev_deg, azim_deg) -> torch.Tensor:
    """Unit view direction for pose angles (degrees). Shape (..., 3)."""
    e = torch.deg2rad(torch.as_tensor(elev_deg, dtype=torch.float32))
    a = torch.deg2rad(torch.as_tensor(azim_deg, dtype=torch.float32))
    return torch.stack([torch.cos(e) * torch.sin(a), torch.sin(e),
                        torch.cos(e) * torch.cos(a)], dim=-1)


def _normalize(v: torch.Tensor, eps: float) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=eps)


def look_at_rotation(eye: torch.Tensor, at: torch.Tensor,
                     up=(0.0, 1.0, 0.0)) -> torch.Tensor:
    """PyTorch3D look-at rotation. eye/at: (..., 3) -> R (..., 3, 3).

    As PyTorch3D: x is normalised with eps 1e-5 and replaced by
    normalize(cross(y, z)) only when every component of the normalised x is
    below 5e-3 (up parallel to z); y is computed before the replacement.
    """
    eye = eye.to(torch.float32)
    at = at.to(torch.float32)
    # Filled on the device: no host-to-device copy, which would sync.
    up_t = torch.stack([torch.full_like(eye[..., 0], float(u)) for u in up],
                       dim=-1)
    z_axis = _normalize(at - eye, 1e-12)
    x_axis = _normalize(_cross(up_t, z_axis), 1e-5)
    y_axis = _normalize(_cross(z_axis, x_axis), 1e-12)
    is_close = torch.all(torch.abs(x_axis) < 5e-3, dim=-1, keepdim=True)
    replacement = _normalize(_cross(y_axis, z_axis), 1e-12)
    x_axis = torch.where(is_close, replacement, x_axis)
    return torch.stack([x_axis, y_axis, z_axis], dim=-2).transpose(-1, -2)


def get_camera_RT(X_cam: torch.Tensor, V_cam: torch.Tensor):
    """R, T for camera centres X_cam (N, 3) and (elev, azim) degrees V_cam
    (N, 2)."""
    rays = camera_ray_from_pose_angles(V_cam[..., 0], V_cam[..., 1])
    R = look_at_rotation(X_cam, X_cam + rays)
    T = -_mat3(X_cam, R)
    return R, T


def ndc_tables(image_height: int, image_width: int, device=None):
    """Per-pixel NDC coordinate tables (ndc_x[H, W], ndc_y[H, W])."""
    m = min(image_height, image_width)
    jj = torch.arange(image_width, dtype=torch.float32, device=device)
    ii = torch.arange(image_height, dtype=torch.float32, device=device)
    ndc_x_row = image_width / m - (jj / (m - 1)) * 2.0
    ndc_y_col = image_height / m - (ii / (m - 1)) * 2.0
    ndc_x = ndc_x_row[None, :].expand(image_height, image_width)
    ndc_y = ndc_y_col[:, None].expand(image_height, image_width)
    return ndc_x, ndc_y


def ndc_bounds(image_height: int, image_width: int):
    """(min_x, max_x, min_y, max_y) of the NDC tables."""
    m = min(image_height, image_width)
    max_x = image_width / m
    min_x = image_width / m - 2.0 * (image_width - 1) / (m - 1)
    max_y = image_height / m
    min_y = image_height / m - 2.0 * (image_height - 1) / (m - 1)
    return min_x, max_x, min_y, max_y


@dataclasses.dataclass(frozen=True)
class CameraIntrinsics:
    """Static intrinsics shared by every camera in a run."""

    image_height: int = 256
    image_width: int = 456
    fov_degrees: float = DEFAULT_FOV_DEGREES
    znear: float = 1.0
    zfar: float = 750.0

    @property
    def tan_half_fov(self) -> float:
        return math.tan(math.radians(self.fov_degrees) / 2.0)

    def pixel_ray_dirs_view(self, device=None) -> torch.Tensor:
        """(H, W, 3) view-space ray directions with d_z == 1."""
        ndc_x, ndc_y = ndc_tables(self.image_height, self.image_width, device)
        t = self.tan_half_fov
        return torch.stack([ndc_x * t, ndc_y * t, torch.ones_like(ndc_x)],
                           dim=-1)


def world_to_view(points: torch.Tensor, R: torch.Tensor, T: torch.Tensor):
    return _mat3(points, R) + T


def view_to_world_dirs(dirs_view: torch.Tensor, R: torch.Tensor
                       ) -> torch.Tensor:
    """View-space directions -> world (the rotation only): d R^T."""
    return _mat3(dirs_view, R.T)


def project_points(points: torch.Tensor, R: torch.Tensor, T: torch.Tensor,
                   tan_half_fov: float) -> torch.Tensor:
    """World points -> (x_proj, y_proj, z_view)."""
    pv = world_to_view(points, R, T)
    z = pv[..., 2]
    safe_z = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    x = pv[..., 0] / (tan_half_fov * safe_z)
    y = pv[..., 1] / (tan_half_fov * safe_z)
    return torch.stack([x, y, z], dim=-1)


def unproject_depth(depth: torch.Tensor, R: torch.Tensor, T: torch.Tensor,
                    intr: CameraIntrinsics) -> torch.Tensor:
    """Depth map (H, W) of view-space z -> world points (H*W, 3)."""
    eye = camera_center(R, T)
    d_view = intr.pixel_ray_dirs_view(depth.device).reshape(-1, 3)
    d_world = _mat3(d_view, R.T)
    return eye[None, :] + depth.reshape(-1, 1) * d_world


def points_in_fov_mask(points: torch.Tensor, R: torch.Tensor,
                       T: torch.Tensor, intr: CameraIntrinsics,
                       fov_range: Optional[float] = None,
                       eye: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Points inside the frustum (NDC bounds, view z > 0) and range."""
    proj = project_points(points, R, T, intr.tan_half_fov)
    min_x, max_x, min_y, max_y = ndc_bounds(intr.image_height,
                                            intr.image_width)
    mask = ((proj[..., 0] >= min_x) & (proj[..., 0] <= max_x)
            & (proj[..., 1] >= min_y) & (proj[..., 1] <= max_y)
            & (proj[..., 2] > 0.0))
    if fov_range is not None:
        if eye is None:
            eye = camera_center(R, T)
        mask = mask & (torch.linalg.norm(points - eye, dim=-1) < fov_range)
    return mask


def camera_center(R: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """eye = -T @ R^T, for one camera or a batch (R (..., 3, 3))."""
    return _mat3(-T, R.transpose(-1, -2))
