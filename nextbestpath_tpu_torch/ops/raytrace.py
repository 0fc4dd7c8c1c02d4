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

from typing import Optional, Tuple

import torch

from .. import kernels
from ..geometry.cameras import CameraIntrinsics, _cross, _mat3, camera_center

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


def ray_hits_pinhole_scenes_plain(dirs: torch.Tensor, ph_soa: torch.Tensor,
                                  n_tris: torch.Tensor, t_min: float,
                                  t_max: float):
    """Plain version of K1's scene axis: frame b, dirs (B, N, 3) against
    ph_soa (B, 10, F), stops at its own count n_tris[b] ((B,) int). ->
    (t, cnt, idx), each (B, N), frame b's row that of its own call."""
    frames = [ray_hits_pinhole_plain(d, ph, int(n), t_min, t_max)
              for d, ph, n in zip(dirs, ph_soa, n_tris.tolist())]
    return tuple(torch.stack([fr[i] for fr in frames]) for i in range(3))


# ---------------------------------------------------------------------------
# K1's cull (csrc/raytrace.cu), modelled in PyTorch
# ---------------------------------------------------------------------------

K1_TILE_W, K1_TILE_H = 16, 8  # a block's pixel tile
_CULL_MARGIN = 2.0 ** -21
_CULL_TINY = 2.0 ** -120


def pinhole_ray_boxes(dirs: torch.Tensor, width: int):
    """The ray boxes of K1's blocks: dirs (B, N, 3), each frame a row-major
    image ``width`` wide -> (lo, hi) (B, K, 3) and the rays of each block in
    the frame (K,), block k the 8 x 16 pixel tile k (row-major over the
    tiles), K the tiles of a frame. A tile's threads past the frame's edge
    cast its nearest ray, as the kernel's do; a NaN component is passed
    over, as fminf and fmaxf pass over it."""
    b, n = dirs.shape[0], dirs.shape[1]
    dev = dirs.device
    h = n // width
    ty, tx = -(-h // K1_TILE_H), -(-width // K1_TILE_W)
    rows = torch.clamp(torch.arange(ty * K1_TILE_H, device=dev), max=h - 1)
    cols = torch.clamp(torch.arange(tx * K1_TILE_W, device=dev), max=width - 1)
    img = dirs.reshape(b, h, width, 3)[:, rows][:, :, cols]
    tiles = img.reshape(b, ty, K1_TILE_H, tx, K1_TILE_W, 3).permute(
        0, 1, 3, 2, 4, 5).reshape(b, ty * tx, K1_TILE_H * K1_TILE_W, 3)
    in_r = torch.clamp(h - torch.arange(ty, device=dev) * K1_TILE_H,
                       max=K1_TILE_H)
    in_c = torch.clamp(width - torch.arange(tx, device=dev) * K1_TILE_W,
                       max=K1_TILE_W)
    rays = (in_r[:, None] * in_c[None, :]).reshape(-1)
    nan = torch.isnan(tiles)
    lo = torch.where(nan, torch.full_like(tiles, float("inf")), tiles).amin(2)
    hi = torch.where(nan, torch.full_like(tiles, -float("inf")), tiles).amax(2)
    return lo, hi, rays


def _up(x):
    return torch.nextafter(x, torch.full_like(x, float("inf")))


def _down(x):
    return torch.nextafter(x, torch.full_like(x, -float("inf")))


def pinhole_cull_keep(ph_soa: torch.Tensor, lo: torch.Tensor,
                      hi: torch.Tensor) -> torch.Tensor:
    """K1's cull: ph_soa (B, 10, F), ray boxes lo, hi (B, K, 3) -> (B, K, F)
    bool, False where the folded triangle fails the pair test for every
    direction of block k's box (csrc/raytrace.cu's note). Each rounding the
    kernel directs (round up, round down) is taken here as the nearest
    float's neighbour in that direction, a bound at least as loose, so a
    triangle this drops the kernel drops too."""
    t_num = ph_soa[:, 9]
    sg = torch.where(t_num > 0, 1.0, torch.where(t_num < 0, -1.0, 0.0))
    sg = sg.to(torch.float32)[:, None, None, :]  # (B, 1, 1, F)
    w = ph_soa[:, None, :9, :]                    # (B, 1, 9, F)
    n = w[:, :, 0:3] * -sg
    m2 = w[:, :, 3:6] * -sg
    m1 = w[:, :, 6:9] * sg
    lo = lo[:, :, :, None]                        # (B, K, 3, 1)
    hi = hi[:, :, :, None]
    mag = torch.maximum(lo.abs(), hi.abs())

    def box_max(v):
        p = torch.maximum(_up(lo * v), _up(hi * v))
        return _up(_up(p[:, :, 0] + p[:, :, 1]) + p[:, :, 2])

    def box_min(v):
        p = torch.minimum(_down(lo * v), _down(hi * v))
        return _down(_down(p[:, :, 0] + p[:, :, 1]) + p[:, :, 2])

    mags = _up(mag * _up(_up(n.abs() + m2.abs()) + m1.abs()))
    s = torch.zeros_like(mags[:, :, 0])
    for i in range(3):
        s = _up(s + mags[:, :, i])
    m = _up(_up(_CULL_MARGIN * s) + _CULL_TINY)
    eps = torch.tensor(_DET_EPS, dtype=torch.float32)
    no_det = _up(box_max(n) + m) <= eps
    no_u = _up(box_max(m2) + m) < 0
    no_v = _up(box_max(m1) + m) < 0
    no_sum = _down(box_min((m2 + m1) - n) - m) > 0
    box_ok = (torch.isfinite(lo) & torch.isfinite(hi)).all(2)  # (B, K, 1)
    return ~(box_ok & torch.isfinite(s) & (no_det | no_u | no_v | no_sum))


def pinhole_tested_share(dirs: torch.Tensor, ph_soa: torch.Tensor, n_tris,
                         width: int) -> float:
    """The share of a K1 launch's (ray, triangle) pairs that its blocks
    test after the cull (``pinhole_cull_keep``, the kernel's test or
    looser): dirs (B, N, 3) in frames ``width`` wide, ph_soa (B, 10, F),
    n_tris one count or (B,) counts. Each block's surviving triangles times
    its rays in the frame, over N times the counts."""
    b = dirs.shape[0]
    counts = (n_tris.reshape(-1).tolist() if isinstance(n_tris, torch.Tensor)
              else [n_tris])
    counts = [_n_valid(c, ph_soa.shape[2]) for c in counts]
    counts = counts * b if len(counts) == 1 else counts
    tested = 0
    for k in range(b):
        lo, hi, rays = pinhole_ray_boxes(dirs[k:k + 1], width)
        keep = pinhole_cull_keep(ph_soa[k:k + 1, :, :counts[k]], lo, hi)
        tested += int((keep[0].sum(1) * rays).sum())
    total = dirs.shape[1] * sum(counts)
    return tested / total if total else 0.0


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
                     t_max: float = _INF, width: Optional[int] = None):
    """ray_hits_full for rays sharing one origin (a camera frame).

    origin (3,) and dirs (N, 3), or B frames at once: origins (B, 3) and
    dirs (B, N, 3); tri_soa (9, F). Returns (t, n_hits, idx), each (N,) or
    (B, N). K1 (one launch for all frames) on CUDA tensors, its plain
    version on CPU tensors. ``width``: the rays are a row-major image that
    wide, which K1 casts in pixel tiles (``kernels.ray_hits_pinhole``);
    None takes the N rays as one row. The result does not depend on it."""
    ph = pinhole_tri_soa(tri_soa, origin)
    dirs = dirs.to(torch.float32).contiguous()
    if dirs.device.type == "cpu":
        return ray_hits_pinhole_plain(dirs, ph, n_tris, t_min, t_max)
    width = dirs.shape[-2] if width is None else width
    if dirs.dim() == 2:
        out = kernels.ray_hits_pinhole(dirs[None], ph[None], n_tris, t_min,
                                       t_max, width)
        return tuple(x[0] for x in out)
    return kernels.ray_hits_pinhole(dirs, ph, n_tris, t_min, t_max, width)


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
                               t_max=float(intr.zfar),
                               width=intr.image_width)
    zbuf = torch.where(t < _INF, t, torch.full_like(t, -1.0))
    return zbuf.reshape(-1, intr.image_height, intr.image_width)


def render_depth_scenes(tri_soas: torch.Tensor, n_tris: torch.Tensor,
                        Rs: torch.Tensor, Ts: torch.Tensor,
                        intr: CameraIntrinsics) -> torch.Tensor:
    """Depth frames (B, K, H, W) of K cameras in each of B scenes: tri_soas
    (B, 9, F) padded to one F, n_tris (B,) int32, Rs (B, K, 3, 3), Ts
    (B, K, 3). One K1 launch renders all B * K frames on the card, each
    frame stopping at its scene's count (``ray_hits_pinhole_scenes``); each
    frame is bit-equal to render_depth_batch of its own scene."""
    B, K = Rs.shape[:2]
    eye, d_world = frame_rays(Rs.reshape(B * K, 3, 3), Ts.reshape(B * K, 3),
                              intr)
    ph = torch.cat([pinhole_tri_soa(tri_soas[b], eye[b * K:(b + 1) * K])
                    for b in range(B)])
    counts = n_tris.reshape(B).to(torch.int32).repeat_interleave(K)
    d_world = d_world.contiguous()
    zn, zf = float(intr.znear), float(intr.zfar)
    if d_world.device.type == "cpu":
        t, _, _ = ray_hits_pinhole_scenes_plain(d_world, ph, counts, zn, zf)
    else:
        t, _, _ = kernels.ray_hits_pinhole_scenes(d_world, ph,
                                                  counts.contiguous(), zn, zf,
                                                  intr.image_width)
    zbuf = torch.where(t < _INF, t, torch.full_like(t, -1.0))
    return zbuf.reshape(B, K, intr.image_height, intr.image_width)


def render_depth(tri_soa: torch.Tensor, n_tris, R: torch.Tensor,
                 T: torch.Tensor, intr: CameraIntrinsics) -> torch.Tensor:
    """Depth frame (H, W): render_depth_batch of one camera."""
    return render_depth_batch(tri_soa, n_tris, R[None], T[None], intr)[0]


def render_rgbd(tri_soa: torch.Tensor, n_tris, R: torch.Tensor,
                T: torch.Tensor, intr: CameraIntrinsics,
                tri_colors: Optional[torch.Tensor] = None,
                ambient: float = 0.85, base_gray: float = 0.8
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rgb (H, W, 3), zbuf (H, W)) of camera (R, T): render_depth's frame
    and a colour frame shaded from the same K1 launch's nearest-triangle
    index. A hit pixel takes its triangle's colour (``tri_colors[idx]``,
    else ``base_gray``) times the headlight Lambert term ``ambient + (1 -
    ambient) |n . d|``, with n the triangle's unit e1 x e2 normal and d the
    unit pixel ray; background pixels are black."""
    eye, d_world = frame_rays(R[None], T[None], intr)
    eye, d_world = eye[0], d_world[0]
    t, _, idx = ray_hits_pinhole(eye, d_world, tri_soa, n_tris,
                                 t_min=float(intr.znear),
                                 t_max=float(intr.zfar),
                                 width=intr.image_width)
    hit = t < _INF
    idx_c = torch.clamp(idx.long(), 0, tri_soa.shape[1] - 1)
    e1 = tri_soa[3:6][:, idx_c].T
    e2 = tri_soa[6:9][:, idx_c].T
    n = _cross(e1, e2)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                        min=1e-12)
    d_n = d_world / torch.clamp(torch.linalg.norm(d_world, dim=-1,
                                                  keepdim=True), min=1e-12)
    lambert = torch.abs((n * d_n).sum(dim=-1))
    shade = ambient + (1.0 - ambient) * lambert
    if tri_colors is not None:
        color = tri_colors.to(torch.float32)[idx_c]
    else:
        color = torch.full(idx_c.shape + (3,), base_gray, dtype=torch.float32,
                           device=idx_c.device)
    rgb = torch.where(hit[:, None], color * shade[:, None],
                      torch.zeros_like(color))
    zbuf = torch.where(hit, t, torch.full_like(t, -1.0))
    H, W = intr.image_height, intr.image_width
    return rgb.reshape(H, W, 3), zbuf.reshape(H, W)


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
