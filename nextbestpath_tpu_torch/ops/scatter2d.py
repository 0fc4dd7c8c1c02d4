"""Egocentric 2D projections for the NBP model inputs.

Port of ``nextbestpath_tpu/ops/scatter2d.py``: world -> egocentric 2D
(translation only), rounding into an image grid, and count images by
scatter-add (and ``scatter_mean_img``, a mean value a pixel). Counts are
small integers in f32, so the order of the adds cannot change them.

Scatters take a whole fixed-capacity buffer with its validity mask (for a
valid-prefix buffer, ``slot < count`` with the count on the device), in one
masked pass: nothing reads the count on the host, so a scatter never syncs.
The JAX package bounds its scatters by the count in chunks
(``_scatter_add``); a masked pass over the default 2M-slot buffer
reads about 24 MB, which the card does in microseconds.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def _scatter_add(shape: Tuple[int, int, int],
                 idx: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                 ok: torch.Tensor) -> torch.Tensor:
    """(C, S, S) counts: one ``index_add_`` of 1 at idx where ok, over the
    whole buffer in one masked pass (the JAX package's
    ``_count_bounded_add`` without its chunk loop, and no gather of the
    valid entries, which would sync on its size). The entries that are not
    ok go to a discard plane past the C channels, each at its own slot
    modulo S*S, so that they spread over S*S addresses instead of
    serialising on one."""
    c, h, w = shape
    plane = h * w
    ch, ii, jj = (a.long() for a in idx)
    flat = (ch * h + ii) * w + jj
    slot = torch.arange(ok.shape[0], device=ok.device)
    flat = torch.where(ok, flat, c * plane + torch.remainder(slot, plane))
    out = torch.zeros((c + 1) * plane, dtype=torch.float32, device=ok.device)
    out.index_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))
    return out[:c * plane].view(c, h, w)


def scatter_count_img(points_2d: torch.Tensor, valid: torch.Tensor,
                      grid_size: int, grid_range: Tuple[float, float],
                      count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(S, S) count image of 2D points, those outside the grid dropped;
    ``count`` (a prefix-compacted buffer's) keeps only the slots before it,
    which are the valid ones anyway."""
    ij = img_coords(points_2d, grid_size, grid_range)
    ok = valid & _in_img(ij, grid_size)
    if count is not None:
        ok = ok & (torch.arange(ok.shape[0], device=ok.device) < count)
    ij = ij.clamp(0, grid_size - 1)
    return _scatter_add((1, grid_size, grid_size),
                        (torch.zeros_like(ij[:, 0]), ij[:, 0], ij[:, 1]),
                        ok)[0]


def scatter_mean_img(points_2d: torch.Tensor, values: torch.Tensor,
                     valid: torch.Tensor, grid_size: int,
                     grid_range: Tuple[float, float]) -> torch.Tensor:
    """(S, S): each pixel the mean of the values of the points that land
    in it, 0 where none does (the reference's averaged-occupancy
    projection, map_points_to_grid_optimized_poster: the sums of values and
    of ones, divided where the count is positive)."""
    ij = img_coords(points_2d, grid_size, grid_range)
    ok = valid & _in_img(ij, grid_size)
    ij = ij.clamp(0, grid_size - 1)
    flat = (ij[:, 0].long() * grid_size + ij[:, 1].long())
    vals = torch.where(ok, values.reshape(-1).to(torch.float32),
                       torch.zeros((), device=ok.device))
    acc = torch.zeros(grid_size * grid_size, dtype=torch.float32,
                      device=ok.device).index_add_(0, flat, vals)
    cnt = torch.zeros_like(acc).index_add_(0, flat, ok.to(torch.float32))
    mean = torch.where(cnt > 0, acc / torch.clamp(cnt, min=1.0),
                       torch.zeros_like(acc))
    return mean.view(grid_size, grid_size)


def count_img(points: torch.Tensor, valid: torch.Tensor,
              cam_xyz: torch.Tensor, grid_size: int,
              grid_range: Tuple[float, float]) -> torch.Tensor:
    """(S, S) count image of the valid points."""
    ij = img_coords(ego2d(points, cam_xyz), grid_size, grid_range)
    ok = valid & _in_img(ij, grid_size)
    ij = ij.clamp(0, grid_size - 1)
    return _scatter_add((1, grid_size, grid_size),
                              (torch.zeros_like(ij[:, 0]), ij[:, 0],
                               ij[:, 1]), ok)[0]


def binned_count_imgs(points: torch.Tensor, valid: torch.Tensor,
                      cam_xyz: torch.Tensor, y_bins: torch.Tensor,
                      n_pieces: int, grid_size: int,
                      grid_range: Tuple[float, float]) -> torch.Tensor:
    """(n_pieces, S, S) count images of the valid points split by height
    bin."""
    ij = img_coords(ego2d(points, cam_xyz), grid_size, grid_range)
    b = bucketize_bins(points[:, 1].contiguous(), y_bins)
    ok = (valid & _in_img(ij, grid_size) & (b >= 0)
          & (b < n_pieces))
    ij = ij.clamp(0, grid_size - 1)
    return _scatter_add((n_pieces, grid_size, grid_size),
                              (b.clamp(0, n_pieces - 1), ij[:, 0], ij[:, 1]),
                              ok)


def plan_count_imgs(points: torch.Tensor, valid: torch.Tensor,
                    cam_xyz: torch.Tensor, y_bins: torch.Tensor,
                    band_center: torch.Tensor, n_pieces: int, grid_size: int,
                    grid_range: Tuple[float, float],
                    band_halfwidth: float = 0.1) -> torch.Tensor:
    """Every plan-phase count image of one buffer in one scatter,
    (n_pieces + 2, S, S):

    * ``[0:n_pieces]`` the height-binned images (binned_count_imgs),
    * ``[n_pieces]`` the valid in-image points whose bin falls outside
      [0, n_pieces), so that the full projection is the sum over
      ``[0:n_pieces + 1]``,
    * ``[n_pieces + 1]`` the height band |y - band_center| < band_halfwidth.

    Each point carries two entries, its bin (or overflow) channel and its
    band channel, interleaved point by point as the JAX package's
    ``plan_count_imgs`` does. Counts are small integers in f32, so the order
    of the adds cannot change them."""
    ij = img_coords(ego2d(points, cam_xyz), grid_size, grid_range)
    b = bucketize_bins(points[:, 1].contiguous(), y_bins)
    in_img = valid & _in_img(ij, grid_size)
    in_bin = (b >= 0) & (b < n_pieces)
    c1 = torch.where(in_bin, b.clamp(0, n_pieces - 1),
                     torch.full_like(b, n_pieces))
    y = points[:, 1]
    band = ((y < band_center + band_halfwidth)
            & (y > band_center - band_halfwidth))
    c2 = torch.full_like(c1, n_pieces + 1)
    ij = ij.clamp(0, grid_size - 1)

    def weave(a1, a2):
        return torch.stack([a1, a2], dim=1).reshape(-1)

    return _scatter_add(
        (n_pieces + 2, grid_size, grid_size),
        (weave(c1, c2), weave(ij[:, 0], ij[:, 0]), weave(ij[:, 1], ij[:, 1])),
        weave(in_img, in_img & band))
