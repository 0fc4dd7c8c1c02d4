"""Ground-truth 2D obstacle (layout) maps from mesh-plane sections.

Port of ``nextbestpath_tpu/ops/obstacle_map.py``: the triangles crossing
the camera's height plane give (x, z) segments, which are clipped to the
grid (Liang–Barsky), sampled by a DDA over ``MAX_STEPS`` steps, rounded to
pixels of the egocentric ``S x S`` grid

    row = round((-(z - cz) - lo) * S / (hi - lo))
    col = round((-(x - cx) - lo) * S / (hi - lo))

and marked by a scatter-max, then dilated 2x2 (the reference's ~2 px
stroke). The map is a binary training label, so it is held to the JAX one
pixel for pixel: every f32 operation keeps the JAX order (the clip, then
``r0 + dr * frac``, each op rounded alone), and ``torch.round``, like
``jnp.round``, rounds half to even, which decides a pixel at a tie.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

MAX_STEPS = 384  # max DDA steps a segment (the grid diagonal is 362 at S=256)

Grid = Tuple[float, float]


def _section_from_abc(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                      n_tris, y: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    F_ = a.shape[0]

    def edge_cross(p, q):
        dy = q[:, 1] - p[:, 1]
        small = torch.abs(dy) < 1e-12
        t = (y - p[:, 1]) / torch.where(small, torch.full_like(dy, 1e-12), dy)
        ok = ~small & (t >= 0.0) & (t <= 1.0)
        return p + t[:, None] * (q - p), ok

    p0, f0 = edge_cross(a, b)
    p1, f1 = edge_cross(b, c)
    p2, f2 = edge_cross(c, a)
    first = torch.where(f0[:, None], p0, torch.where(f1[:, None], p1, p2))
    second = torch.where((f0 & f2)[:, None], p2,
                         torch.where((f0 & f1)[:, None], p1, p2))
    n_cross = f0.int() + f1.int() + f2.int()
    valid = (n_cross >= 2) & (torch.arange(F_, device=a.device) < n_tris)
    # (x, z) by a strided slice: a list index would be a host tensor, which
    # a CUDA graph capture refuses.
    seg = torch.stack([first[:, 0::2], second[:, 0::2]], dim=1)
    return seg, valid


def plane_section_segments(tris: torch.Tensor, n_tris, y: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (F, 3, 3) triangles cut by the plane Y = y: segments (F, 2, 2)
    in (x, z) and valid (F,), one segment a triangle crossing the plane."""
    return _section_from_abc(tris[:, 0], tris[:, 1], tris[:, 2], n_tris, y)


def plane_section_segments_soa(tri_soa: torch.Tensor, n_tris,
                               y: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """plane_section_segments on the (9, F) SoA (v0, e1, e2)."""
    v0 = tri_soa[0:3].T
    return _section_from_abc(v0, v0 + tri_soa[3:6].T, v0 + tri_soa[6:9].T,
                             n_tris, y)


def rasterize_segments(segments: torch.Tensor, valid: torch.Tensor,
                       cam_x: torch.Tensor, cam_z: torch.Tensor,
                       grid_size: int = 256,
                       grid_range: Grid = (-40.0, 40.0)) -> torch.Tensor:
    """World (x, z) segments (F, 2, 2) -> binary (S, S) f32 image in the
    egocentric layout grid. Segments are clipped to the pixel-centre box
    [0, S-1] before the step count is taken, so a clipped chord is sampled
    at most 1 px apart."""
    lo, hi = grid_range
    scale = grid_size / (hi - lo)
    dev = segments.device
    r0 = (-(segments[:, 0, 1] - cam_z) - lo) * scale
    c0 = (-(segments[:, 0, 0] - cam_x) - lo) * scale
    r1 = (-(segments[:, 1, 1] - cam_z) - lo) * scale
    c1 = (-(segments[:, 1, 0] - cam_x) - lo) * scale
    dr = r1 - r0
    dc = c1 - c0

    lo_b, hi_b = 0.0, float(grid_size - 1)
    t0 = torch.zeros_like(dr)
    t1 = torch.ones_like(dr)
    reject = torch.zeros_like(valid)
    for p_k, q_k in ((-dr, r0 - lo_b), (dr, hi_b - r0),
                     (-dc, c0 - lo_b), (dc, hi_b - c0)):
        ratio = q_k / torch.where(torch.abs(p_k) < 1e-12,
                                  torch.full_like(p_k, 1e-12), p_k)
        t0 = torch.where(p_k < -1e-12, torch.maximum(t0, ratio), t0)
        t1 = torch.where(p_k > 1e-12, torch.minimum(t1, ratio), t1)
        reject = reject | ((torch.abs(p_k) <= 1e-12) & (q_k < 0.0))
    valid = valid & ~reject & (t0 <= t1)
    r0 = r0 + dr * t0
    c0 = c0 + dc * t0
    dr = dr * (t1 - t0)
    dc = dc * (t1 - t0)

    steps = torch.maximum(torch.abs(dr), torch.abs(dc))
    n_steps = torch.clamp(torch.ceil(steps).to(torch.int32), 1, MAX_STEPS - 1)
    inv = 1.0 / torch.clamp(n_steps.to(torch.float32), min=1.0)
    k = torch.arange(MAX_STEPS, dtype=torch.float32, device=dev)
    frac = k[None, :] * inv[:, None]
    rows = torch.round(r0[:, None] + dr[:, None] * frac).to(torch.int32)
    cols = torch.round(c0[:, None] + dc[:, None] * frac).to(torch.int32)
    step_ok = (valid[:, None]
               & (torch.arange(MAX_STEPS, device=dev)[None, :]
                  <= n_steps[:, None])
               & (rows >= 0) & (rows < grid_size)
               & (cols >= 0) & (cols < grid_size))
    flat = (rows.clamp(0, grid_size - 1).long() * grid_size
            + cols.clamp(0, grid_size - 1).long())
    img = torch.zeros(grid_size * grid_size, dtype=torch.float32, device=dev)
    img.scatter_reduce_(0, flat.reshape(-1),
                        step_ok.reshape(-1).to(torch.float32), reduce="amax")
    return img.reshape(grid_size, grid_size)


def dilate2(img: torch.Tensor) -> torch.Tensor:
    """2x2 max dilation, matplotlib's ~2 px stroke width."""
    return F.max_pool2d(F.pad(img[None, None], (0, 1, 0, 1)), 2,
                        stride=1)[0, 0]


def _layout(seg_valid, cam_pose5, grid_size, grid_range, stroke_dilation):
    img = rasterize_segments(*seg_valid, cam_pose5[0], cam_pose5[2],
                             grid_size=grid_size, grid_range=grid_range)
    return dilate2(img) if stroke_dilation else img


def gt_obstacle_map(tris: torch.Tensor, n_tris, cam_pose5: torch.Tensor,
                    grid_size: int = 256, grid_range: Grid = (-40.0, 40.0),
                    stroke_dilation: bool = True) -> torch.Tensor:
    """GT binary layout map (S, S) f32 at the camera's height."""
    return _layout(plane_section_segments(tris, n_tris, cam_pose5[1]),
                   cam_pose5, grid_size, grid_range, stroke_dilation)


def gt_obstacle_map_soa(tri_soa: torch.Tensor, n_tris,
                        cam_pose5: torch.Tensor, grid_size: int = 256,
                        grid_range: Grid = (-40.0, 40.0),
                        stroke_dilation: bool = True) -> torch.Tensor:
    """gt_obstacle_map from the shared (9, F) SoA buffer."""
    return _layout(plane_section_segments_soa(tri_soa, n_tris, cam_pose5[1]),
                   cam_pose5, grid_size, grid_range, stroke_dilation)
