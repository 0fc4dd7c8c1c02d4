"""Bilinear depth-map sampling and signed distances to depth surfaces.

Port of ``nextbestpath_tpu/ops/depth_sample.py``: project 3D points into
the camera, sample the depth map bilinearly at the projected normalised
coordinates (``grid_sample`` semantics, align_corners=False, border
padding, by the JAX package's own formula with the corners clamped to
W-2 and H-2), and return view z minus the sampled depth. Positive: the
point lies behind the observed surface (the space-carving signal).
"""

from __future__ import annotations

import torch

from ..geometry.cameras import CameraIntrinsics, project_points, world_to_view


def grid_sample_bilinear(img: torch.Tensor, gx: torch.Tensor,
                         gy: torch.Tensor) -> torch.Tensor:
    """img (H, W, C); gx/gy normalised coordinates in [-1, 1] (gx indexes
    the width, gy the height). Returns samples of gx's shape with C last:
    all channels from one set of corner indices."""
    H, W, C = img.shape
    u = ((gx + 1.0) * W - 1.0) / 2.0
    v = ((gy + 1.0) * H - 1.0) / 2.0
    # jnp.clip as minimum(maximum(.)): a tie splits the gradient (the
    # depth step differentiates through u and v).
    zero = u.new_zeros(())
    u = torch.minimum(torch.maximum(u, zero), zero + (W - 1.0))
    v = torch.minimum(torch.maximum(v, zero), zero + (H - 1.0))
    u0 = torch.clamp(torch.floor(u).to(torch.int64), 0, W - 2)
    v0 = torch.clamp(torch.floor(v).to(torch.int64), 0, H - 2)
    du = (u - u0)[..., None]
    dv = (v - v0)[..., None]
    # Rows of the flattened (H*W, C) image: index_select's backward is an
    # index_add, where advanced indexing's sorts the indices and sums each
    # run of duplicates serially (the cost volume repeats each feature
    # pixel hundreds of times).
    flat = img.reshape(H * W, C)
    base = v0 * W + u0

    def corner(off):
        rows = flat.index_select(0, (base + off).reshape(-1))
        return rows.reshape(*base.shape, C)

    i00, i01, i10, i11 = corner(0), corner(1), corner(W), corner(W + 1)
    return (i00 * (1 - du) * (1 - dv) + i01 * du * (1 - dv)
            + i10 * (1 - du) * dv + i11 * du * dv)


def signed_distance_to_depth(points: torch.Tensor, zbuf: torch.Tensor,
                             R: torch.Tensor, T: torch.Tensor,
                             intr: CameraIntrinsics) -> torch.Tensor:
    """(N,) signed distance of each point to the depth surface.

    Background pixels count as depth 1.1 * zfar, as the reference's; the
    sampling grid takes the reference's factor -min(H, W):
    gx = factor/W * x_proj, gy = factor/H * y_proj."""
    H, W = intr.image_height, intr.image_width
    depth = torch.where(zbuf > -1.0, zbuf,
                        torch.full_like(zbuf, 1.1 * intr.zfar))
    z = world_to_view(points, R, T)[..., 2]
    proj = project_points(points, R, T, intr.tan_half_fov)
    factor = -float(min(H, W))
    gx = factor / W * proj[..., 0]
    gy = factor / H * proj[..., 1]
    return z - grid_sample_bilinear(depth[..., None], gx, gy)[..., 0]
