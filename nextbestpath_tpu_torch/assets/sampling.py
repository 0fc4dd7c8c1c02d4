"""Mesh surface sampling (host-side, numpy).

Replaces PyTorch3D-based area-weighted sampling
(``sample_points_on_mesh_surface``, macarons/utility/utils.py:1287-1456) used
to build the GT surface point cloud (get_scene_gt_surface,
macarons_utils.py:612-637).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def face_areas(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    a = verts[faces[:, 0]]
    b = verts[faces[:, 1]]
    c = verts[faces[:, 2]]
    return 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)


def sample_points_on_mesh_surface(
    verts: np.ndarray,
    faces: np.ndarray,
    n_points: int,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Uniform area-weighted surface samples, (n_points, 3) f32."""
    rng = rng or np.random.default_rng(0)
    areas = face_areas(verts, faces)
    total = areas.sum()
    if total <= 0 or len(faces) == 0:
        return np.zeros((0, 3), dtype=np.float32)
    probs = areas / total
    face_idx = rng.choice(len(faces), size=n_points, p=probs)
    u = rng.random(n_points)
    v = rng.random(n_points)
    su = np.sqrt(u)
    w0 = 1.0 - su
    w1 = su * (1.0 - v)
    w2 = su * v
    tri = verts[faces[face_idx]]  # (n, 3, 3)
    pts = w0[:, None] * tri[:, 0] + w1[:, None] * tri[:, 1] + w2[:, None] * tri[:, 2]
    return pts.astype(np.float32)


def filter_faces_in_bbox(verts: np.ndarray, faces: np.ndarray,
                         x_min: np.ndarray, x_max: np.ndarray) -> np.ndarray:
    """Faces whose three vertices all lie inside [x_min, x_max].

    Reference: get_scene_gt_surface (macarons_utils.py:612-637).
    """
    inside = np.all((verts >= x_min) & (verts <= x_max), axis=-1)
    keep = inside[faces].all(axis=-1)
    return faces[keep]


def grid_capacity_cap(points: np.ndarray, x_min: np.ndarray, x_max: np.ndarray,
                      grid_dims: Tuple[int, int, int], capacity: int,
                      rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Per-cell random capacity cap, mirroring Scene.fill_cells on a fresh
    scene (Cell.fill keeps a random subset of at most `capacity` points per
    cell — macarons_utils.py:3000-3028)."""
    rng = rng or np.random.default_rng(0)
    span = np.maximum(x_max - x_min, 1e-6)
    dims = np.asarray(grid_dims)
    idx = np.clip(((points - x_min) / span * dims).astype(np.int64), 0, dims - 1)
    flat = (idx[:, 0] * dims[1] + idx[:, 1]) * dims[2] + idx[:, 2]
    keep = np.zeros(len(points), dtype=bool)
    order = rng.permutation(len(points))
    flat_shuffled = flat[order]
    # Stable per-cell counting over a random permutation == random subset.
    seen: dict = {}
    for pos, cell in zip(order, flat_shuffled):
        c = seen.get(cell, 0)
        if c < capacity:
            keep[pos] = True
            seen[cell] = c + 1
    return points[keep]
