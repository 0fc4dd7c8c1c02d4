"""Procedural ShapeNet stand-in objects.

A copy of ``nextbestpath_tpu/assets/objects.py`` (numpy only).

The reference pretrains SconeOcc/SconeVis on ShapeNet meshes viewed from
sphere cameras (macarons/trainers/pretrain_scone_occ.py, scone_utils.py:741
get_cameras_on_sphere) and evaluates object NBV the same way
(macarons/testers/shapenet.py). ShapeNet is not vendored; procgen SCENES are
closed interiors, so sphere cameras outside them only ever see the outer
shell — a degenerate stand-in. This module generates closed EXTERIOR
meshes instead: a subdivided octahedron sphere whose vertices are displaced
by a smooth positive radial field (random Gaussian bumps on the direction
sphere) and anisotropically scaled. The result is an embedded closed
2-manifold (radius stays positive, displacement is smooth), so the
odd-parity inside test and occlusion ray casts behave exactly as they do
for ShapeNet-style watertight objects.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


def _octasphere(subdiv: int) -> Tuple[np.ndarray, np.ndarray]:
    """Unit sphere triangulation: octahedron + midpoint subdivision."""
    verts = [
        (1.0, 0.0, 0.0), (-1.0, 0.0, 0.0),
        (0.0, 1.0, 0.0), (0.0, -1.0, 0.0),
        (0.0, 0.0, 1.0), (0.0, 0.0, -1.0),
    ]
    faces = [
        (0, 2, 4), (2, 1, 4), (1, 3, 4), (3, 0, 4),
        (2, 0, 5), (1, 2, 5), (3, 1, 5), (0, 3, 5),
    ]
    verts = [np.asarray(v, np.float64) for v in verts]
    cache: Dict[Tuple[int, int], int] = {}

    def midpoint(i: int, j: int) -> int:
        key = (min(i, j), max(i, j))
        if key not in cache:
            m = verts[i] + verts[j]
            m = m / np.linalg.norm(m)
            verts.append(m)
            cache[key] = len(verts) - 1
        return cache[key]

    for _ in range(subdiv):
        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (ab, b, bc), (ca, bc, c),
                          (ab, bc, ca)]
        faces = new_faces
    return (np.asarray(verts, np.float32),
            np.asarray(faces, np.int32))


@dataclasses.dataclass
class ObjectAssets:
    """Minimal asset bundle for object-level pretraining / NBV."""

    name: str
    verts: np.ndarray       # (V, 3)
    faces: np.ndarray       # (F, 3)
    tris: np.ndarray        # (F, 3, 3)
    n_tris: int
    gt_surface: np.ndarray  # (N, 3)
    x_min: np.ndarray       # (3,) bbox
    x_max: np.ndarray


FAMILIES = ("blob", "superquadric", "sq_bumps", "gouged")


def _bump_field(verts: np.ndarray, rng: np.random.Generator, n_bumps: int,
                amp_lo: float, amp_hi: float) -> np.ndarray:
    """Smooth radial displacement field: random Gaussian bumps on S^2."""
    centers = rng.normal(size=(n_bumps, 3))
    centers /= np.linalg.norm(centers, axis=-1, keepdims=True)
    amps = rng.uniform(amp_lo, amp_hi, size=n_bumps)
    sharp = rng.uniform(0.08, 0.35, size=n_bumps)
    dots = verts @ centers.T  # (V, K)
    return (amps[None, :] * np.exp(-(1.0 - dots) / sharp[None, :])).sum(-1)


def _superquadric_radius(verts: np.ndarray,
                         rng: np.random.Generator) -> np.ndarray:
    """Exact radial distance of the superellipsoid |x/a|^p+|y/b|^p+|z/c|^p=1
    along each unit direction: r(v) = (sum |v_i/s_i|^p)^(-1/p). Low p gives
    pointy octahedral shapes, high p boxes/cylinders — the sharp-edged,
    man-made-object statistics the smooth blobs lack."""
    p = float(np.exp(rng.uniform(np.log(0.9), np.log(8.0))))
    axes = rng.uniform(0.5, 1.4, size=3)
    s = (np.abs(verts / axes[None, :]) ** p).sum(-1)
    return s ** (-1.0 / p)


def generate_object(seed: int = 0, subdiv: int = 3, n_bumps: int = 6,
                    base_radius: float = 1.0,
                    n_gt_surface_points: int = 2048,
                    family: str = "blob") -> ObjectAssets:
    """Random closed star-shaped object (see module docstring).

    Every family defines a strictly positive radius field r(v) over unit
    directions v, then anisotropic axis scaling — smooth-or-piecewise-smooth,
    strictly positive, hence an embedded closed surface whose inside/outside
    parity is exact. Families (the ShapeNet-category-diversity stand-in,
    reference pretrains over many categories, pretrain_scone_occ.py:248):

    * ``blob`` — Gaussian bumps, r = clip(1 + bumps(-0.35, 0.6), 0.35).
    * ``superquadric`` — superellipsoid radius (boxes/cylinders/octahedra).
    * ``sq_bumps`` — superquadric modulated by mild bumps (dented boxes).
    * ``gouged`` — bumps biased negative (deep concavities, amp -0.7..0.3).
    """
    rng = np.random.default_rng(seed)
    verts, faces = _octasphere(subdiv)

    if family == "blob":
        # Blob keeps its original 0.35 floor so same-seed blob objects are
        # bit-identical to earlier pretraining sets (the shared 0.25 floor
        # below only binds for the newer concave families).
        r = np.clip(1.0 + _bump_field(verts, rng, n_bumps, -0.35, 0.6),
                    0.35, None)
    elif family == "superquadric":
        r = _superquadric_radius(verts, rng)
    elif family == "sq_bumps":
        r = _superquadric_radius(verts, rng) * (
            1.0 + _bump_field(verts, rng, n_bumps, -0.2, 0.25))
    elif family == "gouged":
        r = 1.0 + _bump_field(verts, rng, n_bumps, -0.7, 0.3)
    else:
        raise ValueError(f"unknown object family {family!r}")
    r = np.clip(r, 0.25, None) * base_radius
    scale = rng.uniform(0.6, 1.4, size=3)
    v_out = (verts * r[:, None]) * scale[None, :]

    tris = v_out[faces].astype(np.float32)
    from .sampling import sample_points_on_mesh_surface

    gt = sample_points_on_mesh_surface(
        v_out.astype(np.float32), faces, n_gt_surface_points, rng=rng)
    if isinstance(gt, tuple):
        gt = gt[0]
    return ObjectAssets(
        name=f"procobj_{seed}",
        verts=v_out.astype(np.float32), faces=faces,
        tris=tris, n_tris=len(faces),
        gt_surface=np.asarray(gt, np.float32),
        x_min=v_out.min(axis=0).astype(np.float32),
        x_max=v_out.max(axis=0).astype(np.float32),
    )


def cameras_on_sphere(n: int, radius: float, center: np.ndarray,
                      rng: np.random.Generator) -> np.ndarray:
    """Random cameras on a sphere (get_cameras_on_sphere analog,
    scone_utils.py:741; elevation limited to +-60 deg like the reference)."""
    elev = rng.uniform(-60.0, 60.0, n)
    azim = rng.uniform(0.0, 360.0, n)
    e = np.deg2rad(elev)
    a = np.deg2rad(azim)
    dirs = np.stack([np.cos(e) * np.sin(a), np.sin(e), np.cos(e) * np.cos(a)],
                    axis=-1)
    return (np.asarray(center)[None] + radius * dirs).astype(np.float32)


def pose5_toward(pos: np.ndarray, target: np.ndarray) -> np.ndarray:
    """5-D pose at ``pos`` looking at ``target`` (elev/azim convention of
    geometry.cameras.camera_ray_from_pose_angles)."""
    d = np.asarray(target, np.float64) - np.asarray(pos, np.float64)
    d = d / max(np.linalg.norm(d), 1e-9)
    elev = np.degrees(np.arcsin(np.clip(d[1], -1.0, 1.0)))
    azim = np.degrees(np.arctan2(d[0], d[2]))
    return np.asarray([pos[0], pos[1], pos[2], elev, azim], np.float32)
