"""The sensor and the pose lattice, in plain PyTorch.

Cameras follow the paper's (PyTorch3D's) conventions: a pose is (x, y, z,
elevation, azimuth) in degrees; the view direction is (cos e sin a,
sin e, cos e cos a); the look-at axes are z = the direction, x = up x z,
y = z x x with up = +y; a pixel (i, j) of an H x W frame with a field of
view f looks along ndc_x tan(f/2) x + ndc_y tan(f/2) y + z, with
ndc_x = W/m - 2j/(m-1), ndc_y = H/m - 2i/(m-1) and m = min(H, W), so
that a hit's ray parameter is its depth (view z). A frame's depth is the
nearest triangle hit with depth in (znear, zfar), -1 where there is
none (Moller-Trumbore, |det| > 1e-10).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

DET_EPS = 1e-10


def lattice_positions(origin, L: int, H: int, device) -> torch.Tensor:
    """(L, H, 3) f32 world positions of the pose lattice: spacing 3
    along x and z from the origin, at the origin's height."""
    o = torch.as_tensor(origin, dtype=torch.float32, device=device)
    il = torch.arange(L, dtype=torch.float32, device=device)
    ih = torch.arange(H, dtype=torch.float32, device=device)
    x = o[0] + 3.0 * il[:, None]
    z = o[2] + 3.0 * ih[None, :]
    return torch.stack([x.expand(L, H), o[1].expand(L, H), z.expand(L, H)],
                       dim=-1)


def poses5(positions: torch.Tensor, elev: float, azims: torch.Tensor,
           idx3: torch.Tensor) -> torch.Tensor:
    """(N, 5) f32 poses of lattice indices idx3 (N, 3) = (l, h, rot)."""
    idx3 = idx3.long()
    pos = positions[idx3[:, 0], idx3[:, 1]]
    e = torch.full((idx3.shape[0], 1), float(elev), dtype=torch.float32,
                   device=pos.device)
    return torch.cat([pos, e, azims[idx3[:, 2]][:, None]], dim=1)


def interpolate_move(old5: torch.Tensor, new5: torch.Tensor, n_steps: int,
                     n_azim: int) -> torch.Tensor:
    """(n_steps, 5): substeps 1..n_steps of the move old5 -> new5, linear
    in every coordinate, the azimuth the short way round between the
    first and the last azimuth, the last substep exactly new5."""
    out = []
    step_a = 360.0 / n_azim
    for s in range(1, n_steps + 1):
        frac = torch.full((), float(s), dtype=torch.float32,
                          device=old5.device) / n_steps
        pose = old5 + (new5 - old5) * frac
        oa, na = old5[4], new5[4]
        if s == n_steps:
            out.append(torch.cat([pose[:4], na.reshape(1)]))
            continue
        zero = torch.zeros_like(oa)
        hi = (oa < step_a / 2.0) & (na > 360.0 - 1.5 * step_a)
        lo = (na < step_a / 2.0) & (oa > 360.0 - 1.5 * step_a)
        off = torch.where(hi, zero - 360.0, torch.where(lo, zero + 360.0,
                                                        zero))
        out.append(torch.cat([pose[:4], (oa + ((na + off) - oa) * frac)
                              .reshape(1)]))
    return torch.stack(out)


def camera_axes(pose5: torch.Tensor, dtype=torch.float64
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(eye (N, 3), axes (N, 3, 3) with rows x, y, z) of poses (N, 5)."""
    p = pose5.to(dtype)
    e = torch.deg2rad(p[:, 3])
    a = torch.deg2rad(p[:, 4])
    z = torch.stack([torch.cos(e) * torch.sin(a), torch.sin(e),
                     torch.cos(e) * torch.cos(a)], dim=-1)
    z = z / torch.linalg.norm(z, dim=-1, keepdim=True)
    up = torch.zeros_like(z)
    up[:, 1] = 1.0
    x = torch.linalg.cross(up, z)
    x = x / torch.linalg.norm(x, dim=-1, keepdim=True)
    y = torch.linalg.cross(z, x)
    y = y / torch.linalg.norm(y, dim=-1, keepdim=True)
    return p[:, :3], torch.stack([x, y, z], dim=1)


def ndc(H: int, W: int, device, dtype=torch.float64):
    m = min(H, W)
    j = torch.arange(W, dtype=dtype, device=device)
    i = torch.arange(H, dtype=dtype, device=device)
    return W / m - 2.0 * j / (m - 1), H / m - 2.0 * i / (m - 1)


def pixel_dirs(axes: torch.Tensor, H: int, W: int, fov_deg: float
               ) -> torch.Tensor:
    """(N, H*W, 3) world directions of every pixel, view z = 1."""
    t = math.tan(math.radians(fov_deg) / 2.0)
    nx, ny = ndc(H, W, axes.device, axes.dtype)
    gx = (nx * t)[None, :].expand(H, W).reshape(-1)
    gy = (ny * t)[:, None].expand(H, W).reshape(-1)
    return (gx[None, :, None] * axes[:, None, 0]
            + gy[None, :, None] * axes[:, None, 1] + axes[:, None, 2])


def project(points: torch.Tensor, eye: torch.Tensor, axes: torch.Tensor,
            H: int, W: int, fov_deg: float):
    """The pixel (i, j) nearest each point's ray and whether it lies in
    the frame in front of the camera: (ij (P, 2) int64, inside (P,))."""
    t = math.tan(math.radians(fov_deg) / 2.0)
    m = min(H, W)
    d = points.to(axes.dtype) - eye
    xc, yc, zc = (d @ axes[0]), (d @ axes[1]), (d @ axes[2])
    safe = torch.where(zc.abs() < 1e-12, torch.full_like(zc, 1e-12), zc)
    j = (W / m - xc / (t * safe)) * (m - 1) / 2.0
    i = (H / m - yc / (t * safe)) * (m - 1) / 2.0
    ij = torch.stack([torch.round(i), torch.round(j)], dim=-1)
    inside = ((zc > 0) & (ij[:, 0] >= 0) & (ij[:, 0] < H)
              & (ij[:, 1] >= 0) & (ij[:, 1] < W))
    ij = torch.stack([ij[:, 0].clamp(0, H - 1), ij[:, 1].clamp(0, W - 1)], -1)
    return ij.long(), inside


def triangle_terms(tris: torch.Tensor, eye: torch.Tensor, dtype):
    """For rays from one eye: M (3, 3F) with d @ M = (det, u, v)
    numerators of every triangle, and t's numerator (F,)."""
    t = tris.to(dtype)
    v0, e1, e2 = t[:, 0], t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]
    s = eye.to(dtype)[None, :] - v0
    a = torch.linalg.cross(e2, e1)
    b = torch.linalg.cross(e2, s)
    q = torch.linalg.cross(s, e1)
    m = torch.cat([a, b, q], dim=0).T.contiguous()
    return m, (e2 * q).sum(-1)


def render(tris: torch.Tensor, eye: torch.Tensor, dirs: torch.Tensor,
           t_min: float, t_max: float, dtype=torch.float64,
           chunk: int = 8192):
    """((R,) depth of the nearest hit with t in (t_min, t_max) of rays
    eye + t d, in ``dtype``, -1 where none; (R,) the index of the hit
    triangle). tris (F, 3, 3)."""
    F = tris.shape[0]
    m, t_num = triangle_terms(tris, eye, dtype)
    out, hit = [], []
    for r0 in range(0, dirs.shape[0], chunk):
        d = dirs[r0:r0 + chunk].to(dtype)
        prod = d @ m
        det, u, v = prod[:, :F], prod[:, F:2 * F], prod[:, 2 * F:]
        neg = det < 0
        u = torch.where(neg, -u, u)
        v = torch.where(neg, -v, v)
        ad = det.abs()
        ok = (ad > DET_EPS) & (u >= 0) & (v >= 0) & (u + v <= ad)
        t = t_num[None, :] / torch.where(ok, det, torch.ones_like(det))
        ok = ok & (t > t_min) & (t < t_max)
        best, idx = torch.where(ok, t, torch.full_like(
            t, float("inf"))).min(1)
        out.append(torch.where(torch.isinf(best), torch.full_like(best, -1.0),
                               best))
        hit.append(idx)
    return torch.cat(out), torch.cat(hit)


def unit_normals(tris: torch.Tensor) -> torch.Tensor:
    """(F, 3) f64 unit normals of the triangles."""
    t = tris.to(torch.float64)
    n = torch.linalg.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])
    return n / torch.linalg.norm(n, dim=1, keepdim=True).clamp(min=1e-30)
