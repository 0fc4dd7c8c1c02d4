"""Ray-triangle geometry: plain PyTorch versions and the kernel dispatch.

Port of ``nextbestpath_tpu/ops/raytrace.py``. Semantics: Moller-Trumbore,
double-sided, with t measured along the unnormalised ray direction; for
depth rendering the view-space rays have d_z == 1, so t is view-space z,
and background pixels get -1. Triangles are a (9, F) SoA (v0, e1, e2).

The dispatching wrappers ``ray_hits_pinhole``, ``ray_hits`` and
``ray_hits_full`` take a kernel's plain version for CPU tensors and launch
the CUDA kernel (``kernels.py``) for CUDA tensors. The plain versions repeat
the kernels' arithmetic op for op (sums in index order, one rounding per op),
are chunked so that no intermediate holds more than ``_PAIRS`` ray-triangle
pairs, and loop over exactly the first ``n_tris`` triangles.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import kernels
from ..geometry.cameras import CameraIntrinsics, _mat3, camera_center

_DET_EPS = 1e-10
_INF = 3.4e38
_PAIRS = 1 << 22  # ray-triangle pairs per chunk of a plain version


def tris_to_soa(tris: torch.Tensor) -> torch.Tensor:
    """(F, 3, 3) triangles -> (9, F) SoA of (v0, e1=v1-v0, e2=v2-v0)."""
    v0 = tris[:, 0]
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    return torch.cat([v0.T, e1.T, e2.T], dim=0).to(torch.float32).contiguous()


def _n_valid(n_tris, f: int) -> int:
    return max(0, min(int(n_tris), f))


# ---------------------------------------------------------------------------
# Dense references over (F, 3, 3) triangles (the JAX package's ray_hits_ref)
# ---------------------------------------------------------------------------


def _moller_trumbore(o, d, v0, e1, e2):
    """o/d: (N, 1, 3); v0/e1/e2: (1, F, 3) -> (t, hit) of shape (N, F)."""
    p = torch.linalg.cross(d.expand(-1, e2.shape[1], -1),
                           e2.expand(d.shape[0], -1, -1))
    det = torch.sum(e1 * p, dim=-1)
    s = o - v0
    u = torch.sum(s * p, dim=-1)
    q = torch.linalg.cross(s, e1.expand(s.shape[0], -1, -1))
    v = torch.sum(d * q, dim=-1)
    t_scaled = torch.sum(e2 * q, dim=-1)
    sign = torch.sign(det)
    abs_det = torch.abs(det)
    valid = abs_det > _DET_EPS
    u_s = u * sign
    v_s = v * sign
    inside = (u_s >= 0) & (v_s >= 0) & (u_s + v_s <= abs_det)
    t = t_scaled / torch.where(valid, det, torch.ones_like(det))
    return t, valid & inside


def ray_hits_idx_ref(origins, dirs, tris, t_min: float = 1e-4,
                     t_max: float = _INF):
    """Dense reference: (t_nearest, n_hits, idx); idx -1 where no hit."""
    o = origins[:, None, :]
    d = dirs[:, None, :]
    v0 = tris[None, :, 0, :]
    e1 = (tris[:, 1] - tris[:, 0])[None]
    e2 = (tris[:, 2] - tris[:, 0])[None]
    t, hit = _moller_trumbore(o, d, v0, e1, e2)
    in_range = hit & (t > t_min) & (t < t_max)
    t_masked = torch.where(in_range, t, torch.full_like(t, _INF))
    t_near, idx = torch.min(t_masked, dim=-1)
    n_hits = in_range.sum(-1).to(torch.int32)
    idx = torch.where(t_near < _INF, idx, torch.full_like(idx, -1))
    return t_near, n_hits, idx.to(torch.int32)


def ray_hits_ref(origins, dirs, tris, t_min: float = 1e-4,
                 t_max: float = _INF):
    """Dense reference: (t_nearest (N,), n_hits (N,)); 3.4e38 for none."""
    t, n, _ = ray_hits_idx_ref(origins, dirs, tris, t_min, t_max)
    return t, n


# ---------------------------------------------------------------------------
# Plain versions of the kernels
# ---------------------------------------------------------------------------


def _dot3(a0, a1, a2, b0, b1, b2):
    return (a0 * b0 + a1 * b1) + a2 * b2


def _nearest(t, ok):
    """(R, C) pair results -> per-row (t_best, cnt, idx): the nearest hit
    time (3.4e38 for none), the hit count, and the lowest index among the
    nearest hits (-1 for none)."""
    t_chunk = torch.where(ok, t, torch.full_like(t, _INF))
    t_best = torch.amin(t_chunk, dim=1)
    lane = torch.arange(t.shape[1], dtype=torch.int32, device=t.device)
    idx = torch.where(t_chunk <= t_best[:, None], lane,
                      torch.full_like(lane, 2 ** 30)).amin(dim=1)
    idx = torch.where(t_best < _INF, idx, torch.full_like(idx, -1))
    return t_best, ok.sum(1).to(torch.int32), idx


def _empty_result(n: int, device):
    return (torch.full((n,), _INF, dtype=torch.float32, device=device),
            torch.zeros(n, dtype=torch.int32, device=device),
            torch.full((n,), -1, dtype=torch.int32, device=device))


def _cat(parts):
    return tuple(torch.cat([p[i] for p in parts]) for i in range(3))


def _hit_test(det, u, v, t_num, t_min, t_max):
    abs_det = torch.abs(det)
    valid = abs_det > _DET_EPS
    neg = det < 0
    u_s = torch.where(neg, -u, u)
    v_s = torch.where(neg, -v, v)
    inside = valid & (u_s >= 0) & (v_s >= 0) & (u_s + v_s <= abs_det)
    t = t_num / torch.where(valid, det, torch.ones_like(det))
    return t, inside & (t > t_min) & (t < t_max)


def ray_hits_pinhole_plain(dirs: torch.Tensor, ph_soa: torch.Tensor, n_tris,
                           t_min: float, t_max: float):
    """Plain version of K1: dirs (N, 3) against a (10, F) pinhole SoA, or B
    frames at once, dirs (B, N, 3) against (B, 10, F), one frame after the
    other. -> (t, cnt, idx) of shape (N,) or (B, N)."""
    if dirs.dim() == 3:
        frames = [ray_hits_pinhole_plain(d, ph, n_tris, t_min, t_max)
                  for d, ph in zip(dirs, ph_soa)]
        return tuple(torch.stack([fr[i] for fr in frames]) for i in range(3))
    n = dirs.shape[0]
    f = _n_valid(n_tris, ph_soa.shape[1])
    if f == 0 or n == 0:
        return _empty_result(n, dirs.device)
    soa = ph_soa[:, :f]
    rows = max(1, _PAIRS // f)
    out = []
    for r0 in range(0, n, rows):
        d = dirs[r0:r0 + rows]
        dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
        det = -_dot3(dx, dy, dz, soa[0], soa[1], soa[2])
        u = -_dot3(dx, dy, dz, soa[3], soa[4], soa[5])
        v = _dot3(dx, dy, dz, soa[6], soa[7], soa[8])
        t, ok = _hit_test(det, u, v, soa[9], t_min, t_max)
        out.append(_nearest(t, ok))
    return _cat(out)


def ray_hits_plain(origins: torch.Tensor, dirs: torch.Tensor,
                   soa: torch.Tensor, n_tris, t_min: float, t_max: float):
    """Plain version of K2 over a (9, F) SoA. -> (t, cnt, idx)."""
    n = dirs.shape[0]
    f = _n_valid(n_tris, soa.shape[1])
    if f == 0 or n == 0:
        return _empty_result(n, dirs.device)
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = soa[:, :f]
    rows = max(1, _PAIRS // f)
    out = []
    for r0 in range(0, n, rows):
        o = origins[r0:r0 + rows]
        d = dirs[r0:r0 + rows]
        ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
        dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = _dot3(e1x, e1y, e1z, px, py, pz)
        sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
        u = _dot3(sx, sy, sz, px, py, pz)
        qx = sy * e1z - sz * e1y
        qy = sz * e1x - sx * e1z
        qz = sx * e1y - sy * e1x
        v = _dot3(dx, dy, dz, qx, qy, qz)
        t_scaled = _dot3(e2x, e2y, e2z, qx, qy, qz)
        t, ok = _hit_test(det, u, v, t_scaled, t_min, t_max)
        out.append(_nearest(t, ok))
    return _cat(out)


# ---------------------------------------------------------------------------
# Dispatching wrappers
# ---------------------------------------------------------------------------


def pinhole_tri_soa(tri_soa: torch.Tensor, origin: torch.Tensor
                    ) -> torch.Tensor:
    """(9, F) SoA + shared origin (3,) -> (10, F) pinhole SoA [n; m2; m1;
    t_num] with n = e1 x e2, m2 = s x e2, m1 = s x e1, t_num = e2 . m1 and
    s = origin - v0. Origins (B, 3) give (B, 10, F), one SoA a frame, each
    bit-equal to its own single-origin call (the same elementwise ops)."""
    if origin.dim() == 1:
        return pinhole_tri_soa(tri_soa, origin[None])[0]
    v0 = tri_soa[0:3]
    e1 = tri_soa[3:6]
    e2 = tri_soa[6:9]
    s = origin.to(torch.float32)[:, :, None] - v0  # (B, 3, F)

    def cross(a, b):
        return torch.stack([a[..., 1, :] * b[..., 2, :]
                            - a[..., 2, :] * b[..., 1, :],
                            a[..., 2, :] * b[..., 0, :]
                            - a[..., 0, :] * b[..., 2, :],
                            a[..., 0, :] * b[..., 1, :]
                            - a[..., 1, :] * b[..., 0, :]], dim=-2)

    n = cross(e1, e2).expand(s.shape[0], -1, -1)
    m2 = cross(s, e2)
    m1 = cross(s, e1)
    t_num = _dot3(e2[0], e2[1], e2[2], m1[:, 0], m1[:, 1], m1[:, 2])[:, None]
    return torch.cat([n, m2, m1, t_num], dim=1).to(torch.float32).contiguous()


def ray_hits_pinhole(origin: torch.Tensor, dirs: torch.Tensor,
                     tri_soa: torch.Tensor, n_tris, t_min: float = 1e-4,
                     t_max: float = _INF):
    """ray_hits_full for rays sharing one origin (a camera frame).

    origin (3,) and dirs (N, 3), or B frames at once: origins (B, 3) and
    dirs (B, N, 3); tri_soa (9, F). Returns (t, n_hits, idx), each (N,) or
    (B, N). K1 (one launch for all frames) on CUDA tensors, its plain
    version on CPU tensors."""
    ph = pinhole_tri_soa(tri_soa, origin)
    dirs = dirs.to(torch.float32).contiguous()
    if dirs.device.type == "cpu":
        return ray_hits_pinhole_plain(dirs, ph, n_tris, t_min, t_max)
    if dirs.dim() == 2:
        out = kernels.ray_hits_pinhole(dirs[None], ph[None], n_tris, t_min,
                                       t_max)
        return tuple(x[0] for x in out)
    return kernels.ray_hits_pinhole(dirs, ph, n_tris, t_min, t_max)


def ray_hits_full(origins: torch.Tensor, dirs: torch.Tensor,
                  tri_soa: torch.Tensor, n_tris, t_min: float = 1e-4,
                  t_max: float = _INF):
    """(t, n_hits, idx) per ray; K2 on CUDA tensors, its plain version on
    CPU tensors."""
    origins = origins.to(torch.float32).contiguous()
    dirs = dirs.to(torch.float32).contiguous()
    tri_soa = tri_soa.to(torch.float32).contiguous()
    if dirs.device.type == "cpu":
        return ray_hits_plain(origins, dirs, tri_soa, n_tris, t_min, t_max)
    return kernels.ray_hits(origins, dirs, tri_soa, n_tris, t_min, t_max)


def ray_hits(origins: torch.Tensor, dirs: torch.Tensor,
             tri_soa: torch.Tensor, n_tris, t_min: float = 1e-4,
             t_max: float = _INF) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest-hit t (3.4e38 if none) and hit count per ray."""
    t, cnt, _ = ray_hits_full(origins, dirs, tri_soa, n_tris, t_min, t_max)
    return t, cnt


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def frame_rays(Rs: torch.Tensor, Ts: torch.Tensor, intr: CameraIntrinsics
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eyes (B, 3) and world pixel-ray directions (B, H*W, 3) of cameras Rs
    (B, 3, 3), Ts (B, 3): eye = -T @ R^T, d = d_view @ R^T, through the
    same products as one camera's, so each frame's rays are bit-equal to
    its own camera's."""
    Rt = Rs.transpose(-1, -2)
    d_view = intr.pixel_ray_dirs_view(Rs.device).reshape(1, -1, 3)
    return camera_center(Rs, Ts), _mat3(d_view, Rt[:, None])


def render_depth_batch(tri_soa: torch.Tensor, n_tris, Rs: torch.Tensor,
                       Ts: torch.Tensor, intr: CameraIntrinsics
                       ) -> torch.Tensor:
    """Depth frames (B, H, W) of view-space z for cameras Rs (B, 3, 3), Ts
    (B, 3); background -1. Hits nearer than intr.znear or beyond intr.zfar
    are ignored. One K1 launch renders all B frames on the card; each frame
    is bit-equal to render_depth of its own camera."""
    eye, d_world = frame_rays(Rs, Ts, intr)
    t, _, _ = ray_hits_pinhole(eye, d_world, tri_soa, n_tris,
                               t_min=float(intr.znear),
                               t_max=float(intr.zfar))
    zbuf = torch.where(t < _INF, t, torch.full_like(t, -1.0))
    return zbuf.reshape(-1, intr.image_height, intr.image_width)


def render_depth(tri_soa: torch.Tensor, n_tris, R: torch.Tensor,
                 T: torch.Tensor, intr: CameraIntrinsics) -> torch.Tensor:
    """Depth frame (H, W): render_depth_batch of one camera."""
    return render_depth_batch(tri_soa, n_tris, R[None], T[None], intr)[0]


def segments_hit_mesh(starts: torch.Tensor, ends: torch.Tensor,
                      tri_soa: torch.Tensor, n_tris) -> torch.Tensor:
    """True where the open segment (start, end) crosses the mesh."""
    t, _ = ray_hits(starts, ends - starts, tri_soa, n_tris, t_min=1e-6,
                    t_max=1.0)
    return t < 1.0


def inside_test_rays(points: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rays of the odd-parity inside test of N points: origins and
    directions (3N, 3), the points cast along +y, then +x, then +z, each
    axis tilted by a small fixed jitter so that axis-aligned edges are not
    hit exactly on a shared triangle edge."""
    n = points.shape[0]
    axes = torch.tensor([[3e-4, 1.0, 7e-4], [1.0, 3e-4, 7e-4],
                         [7e-4, 3e-4, 1.0]], dtype=torch.float32,
                        device=points.device)
    return points.repeat(3, 1), axes.repeat_interleave(n, dim=0)


def inside_from_counts(cnt: torch.Tensor) -> torch.Tensor:
    """(3N,) hit counts of inside_test_rays -> (N,) inside: odd along all
    three axes."""
    odd = ((cnt % 2) == 1).reshape(3, -1)
    return odd[0] & odd[1] & odd[2]


def points_inside_mesh(points: torch.Tensor, tri_soa: torch.Tensor,
                       n_tris) -> torch.Tensor:
    """Odd-parity inside test along +y, +x and +z (inside_test_rays)."""
    origins, dirs = inside_test_rays(points)
    _, cnt = ray_hits(origins, dirs, tri_soa, n_tris, t_min=1e-6)
    return inside_from_counts(cnt)
