"""Egocentric 2D projections for the NBP model inputs.

Port of the parts of ``nextbestpath_tpu/ops/scatter2d.py`` that the
planning rollout reaches: world -> egocentric 2D (translation only),
rounding into an image grid, and count images by scatter-add. Counts are
small integers in f32, so the order of the adds cannot change them.

Scatters take the valid prefix of a buffer (``points[:n]``) rather than a
mask over all of it.
"""

from __future__ import annotations

from typing import Tuple

import torch


def ego2d(points: torch.Tensor, cam_xyz: torch.Tensor) -> torch.Tensor:
    """World points (N, 3) -> egocentric 2D (N, 2) = (-(z - zc), -(x - xc))."""
    d = points - cam_xyz[None, :]
    return torch.stack([-d[:, 2], -d[:, 0]], dim=-1)


def img_coords(points_2d: torch.Tensor, grid_size: int,
               grid_range: Tuple[float, float]) -> torch.Tensor:
    """2D coords -> integer pixel (N, 2) int32: round((p - lo) * scale),
    half to even as jnp.round."""
    lo, hi = grid_range
    scale = grid_size / (hi - lo)
    return torch.round((points_2d - lo) * scale).to(torch.int32)


def height_bins(verts_min_y: float, verts_max_y: float, n_pieces: int = 4,
                device=None) -> torch.Tensor:
    """(n_pieces + 1,) height-bin boundaries between min+0.5 and max-0.5."""
    min_y = torch.tensor(verts_min_y, dtype=torch.float32, device=device) + 0.5
    max_y = torch.tensor(verts_max_y, dtype=torch.float32, device=device) - 0.5
    w = (max_y - min_y) / n_pieces
    return min_y + w * torch.arange(n_pieces + 1, dtype=torch.float32,
                                    device=device)


def bucketize_bins(y: torch.Tensor, y_bins: torch.Tensor) -> torch.Tensor:
    """torch.bucketize(y, y_bins[:-1]) - 1; -1 means below the first bin."""
    return torch.bucketize(y, y_bins[:-1].contiguous(),
                           right=False).to(torch.int32) - 1


def _in_img(ij: torch.Tensor, grid_size: int) -> torch.Tensor:
    return ((ij[:, 0] >= 0) & (ij[:, 0] < grid_size)
            & (ij[:, 1] >= 0) & (ij[:, 1] < grid_size))


def _scatter_add(shape, idx: Tuple[torch.Tensor, ...], ok: torch.Tensor
                 ) -> torch.Tensor:
    out = torch.zeros(shape, dtype=torch.float32, device=ok.device)
    sel = tuple(a[ok].long() for a in idx)
    out.index_put_(sel, torch.ones_like(sel[0], dtype=torch.float32),
                   accumulate=True)
    return out


def count_img(points: torch.Tensor, cam_xyz: torch.Tensor, grid_size: int,
              grid_range: Tuple[float, float],
              mask=None) -> torch.Tensor:
    """(S, S) count image of the points (those with mask, if given)."""
    ij = img_coords(ego2d(points, cam_xyz), grid_size, grid_range)
    ok = _in_img(ij, grid_size)
    if mask is not None:
        ok = ok & mask
    return _scatter_add((grid_size, grid_size), (ij[:, 0], ij[:, 1]), ok)


def binned_count_imgs(points: torch.Tensor, cam_xyz: torch.Tensor,
                      y_bins: torch.Tensor, n_pieces: int, grid_size: int,
                      grid_range: Tuple[float, float]) -> torch.Tensor:
    """(n_pieces, S, S) count images of the points split by height bin."""
    ij = img_coords(ego2d(points, cam_xyz), grid_size, grid_range)
    b = bucketize_bins(points[:, 1].contiguous(), y_bins)
    ok = _in_img(ij, grid_size) & (b >= 0) & (b < n_pieces)
    return _scatter_add((n_pieces, grid_size, grid_size),
                        (b, ij[:, 0], ij[:, 1]), ok)
