"""Spherical/cartesian conversions with the reference's elev/azim convention.

Port of ``nextbestpath_tpu/geometry/spherical.py``:

    x = r * cos(elev) * sin(azim)
    y = r * sin(elev)
    z = r * cos(elev) * cos(azim)

elev in [-pi/2, pi/2], azim measured from +z toward +x.
"""

from __future__ import annotations

import math

import torch

_DEG = math.pi / 180.0


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def get_cartesian_coords(r, elev, azim, in_degrees: bool = False
                         ) -> torch.Tensor:
    """(r, elev, azim) -> (N, 3) cartesian. Inputs broadcastable to (N,)."""
    f = _DEG if in_degrees else 1.0
    e = _f32(elev) * f
    a = _f32(azim, e.device) * f
    r = _f32(r, e.device)
    pts = torch.stack([torch.cos(e) * torch.sin(a), torch.sin(e),
                       torch.cos(e) * torch.cos(a)], dim=-1)
    return (r.reshape(r.shape + (1,) * (pts.dim() - r.dim())) * pts
            ).reshape(-1, 3)


def get_spherical_coords(X: torch.Tensor):
    """(..., 3) cartesian -> (r, elev, azim), radians: elev clamped to
    +-pi/2, the azimuth's sign that of x (the reference's clamps)."""
    r = torch.linalg.norm(X, dim=-1)
    sin_e = torch.clamp(X[..., 1] / torch.clamp(r, min=1e-12), -1.0, 1.0)
    elev = torch.asin(sin_e)
    cos_e = torch.cos(elev)
    cos_a = torch.clamp(X[..., 2] / torch.clamp(r * cos_e, min=1e-12),
                        -1.0, 1.0)
    azim = torch.acos(cos_a)
    azim = torch.where(X[..., 0] < 0, -azim, azim)
    return r, elev, azim


def sample_cameras_on_sphere(n_x: int, radius: float, device=None
                             ) -> torch.Tensor:
    """Deterministic camera grid on a sphere: a sqrt(n_x) x sqrt(n_x) grid
    of thetas over +-0.9 pi and phis over +-0.9 * 2 pi. (n_x, 3)."""
    n_dim = int(math.isqrt(n_x))
    delta_theta = 0.9 * math.pi
    delta_phi = 0.9 * 2 * math.pi
    inc = torch.linspace(0.0, n_dim - 1.0, n_dim, dtype=torch.float32,
                         device=device)
    thetas = -delta_theta + inc * (2 * delta_theta / (n_dim - 1))
    phis = -delta_phi + inc * (2 * delta_phi / (n_dim - 1))
    tt = thetas[:, None]
    pp = phis[None, :]
    x = torch.cos(tt) * torch.sin(pp)
    y = torch.sin(tt) * torch.ones_like(pp)
    z = torch.cos(tt) * torch.cos(pp)
    return radius * torch.stack(
        [x.expand(n_dim, n_dim), y.expand(n_dim, n_dim),
         z.expand(n_dim, n_dim)], dim=-1).reshape(-1, 3)
