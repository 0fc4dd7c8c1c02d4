"""View-state vectors and view harmonics for the SCONE modules.

Port of ``nextbestpath_tpu/ops/view_state.py``:

* ``compute_view_state``: a point's binary grid over n_elev x n_azim
  discretised directions, marking where cameras have seen it from;
* ``compute_view_harmonics``: the view state projected onto the
  spherical-harmonics basis with the sin(polar) quadrature weights;
* ``view_space_permutation``: the direction grid rotated into a camera's
  view space;
* ``normalize_points_in_prediction_box``.

The binning takes Python's floor semantics (``torch.div(...,
rounding_mode="floor")`` and ``torch.remainder``, as ``jnp.floor_divide``
and ``jnp.mod``), so its bins equal the JAX package's.
"""

from __future__ import annotations

import math

import torch

from ..geometry.cameras import camera_center
from ..geometry.spherical import get_cartesian_coords, get_spherical_coords


def _direction_indices(rays: torch.Tensor, n_elev: int, n_azim: int,
                       symmetric_clamp: bool = False) -> torch.Tensor:
    """Ray directions binned into the flattened (n_elev, n_azim) grid.

    As the reference (and the JAX package), the elevation clamp is
    [-n_elev//2, n_elev-1] followed by a flat modulo, so near-vertical
    upward rays wrap to the bottom rows; ``symmetric_clamp=True`` clamps to
    +-n_elev//2 (the view-space variant)."""
    _, elev, azim = get_spherical_coords(rays)
    elev_step = math.pi / (n_elev + 1)
    azim_step = 2 * math.pi / n_azim

    idx_elev = torch.div(elev, elev_step, rounding_mode="floor")
    idx_azim = torch.div(azim, azim_step, rounding_mode="floor")
    idx_elev = torch.where(torch.remainder(elev, elev_step) > elev_step / 2.0,
                           idx_elev + 1, idx_elev)
    idx_azim = torch.where(torch.remainder(azim, azim_step) > azim_step / 2.0,
                           idx_azim + 1, idx_azim)
    hi = n_elev // 2 if symmetric_clamp else n_elev - 1
    idx_elev = torch.clamp(idx_elev, -(n_elev // 2), hi)
    idx_azim = torch.where(idx_azim > n_azim // 2,
                           torch.full_like(idx_azim, -(n_azim // 2)), idx_azim)
    idx_elev = idx_elev + n_elev // 2
    idx_azim = torch.where(idx_azim < 0, idx_azim + n_azim, idx_azim)
    indices = (idx_elev.to(torch.int32) * n_azim
               + idx_azim.to(torch.int32))
    return torch.remainder(indices, n_elev * n_azim).to(torch.int64)


def compute_view_state(pts: torch.Tensor, X_view: torch.Tensor,
                       n_elev: int = 7, n_azim: int = 14) -> torch.Tensor:
    """pts (B, N, >=3), X_view (V, 3) -> view state (B, N, n_elev*n_azim),
    1.0 in each bin some camera sees the point from."""
    rays = X_view[None, None, :, :] - pts[:, :, None, :3]
    idx = _direction_indices(rays, n_elev, n_azim)  # (B, N, V)
    B, N = idx.shape[:2]
    out = torch.zeros((B, N, n_elev * n_azim), dtype=torch.float32,
                      device=pts.device)
    return out.scatter_(-1, idx, 1.0)


def compute_view_harmonics(view_state: torch.Tensor,
                           base_harmonics: torch.Tensor,
                           h_polar: torch.Tensor,
                           n_elev: int = 7, n_azim: int = 14) -> torch.Tensor:
    """Spherical L2 projection of the view state (B, N, V) onto the
    harmonic basis (n_harm, V) -> (B, N, n_harm)."""
    polar_step = math.pi / (n_elev + 1)
    azim_step = 2 * math.pi / n_azim
    w = torch.sin(h_polar) * polar_step * azim_step  # (V,)
    return torch.matmul(view_state * w, base_harmonics.T)


def view_space_permutation(R: torch.Tensor, T: torch.Tensor,
                           n_elev: int = 7, n_azim: int = 14) -> torch.Tensor:
    """(V,) gather indices rotating a view state into a camera's view
    space; elevation clamped symmetrically, as the reference does here."""
    n_view = n_elev * n_azim
    elev = [-90.0 + (i + 1) / (n_elev + 1) * 180.0 for i in range(n_elev)
            for _ in range(n_azim)]
    azim = [360.0 * j / n_azim for _ in range(n_elev) for j in range(n_azim)]
    X_ref = get_cartesian_coords(torch.ones(n_view), elev, azim,
                                 in_degrees=True).to(R.device)
    eye = camera_center(R, T)
    world = torch.matmul(X_ref - T[None, :], R.T)  # inverse of X @ R + T
    dirs = world - eye[None, :]
    return _direction_indices(dirs, n_elev, n_azim, symmetric_clamp=True)


def normalize_points_in_prediction_box(points, box_center, box_diag):
    return (points - box_center) / box_diag
