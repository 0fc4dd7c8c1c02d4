"""Procedural AiMDoom-like indoor scenes.

The AiMDoom dataset (reference README.md:63-80) is not vendored with the
reference repo, so the framework ships a procedural generator producing
scenes with the same structural properties:

* a closed 2-manifold triangle mesh bounding the *navigable air volume*
  (so the reference's odd-parity inside test — check_camera_in_mesh,
  next_best_path/utility/long_term_utils.py:158-170 — identifies navigable
  positions),
* Doom-style floorplans: mazes of corridors/rooms with thick walls, flat
  floor and ceiling,
* a per-scene ``settings.json``-equivalent pinning the scene bbox and the
  camera pose lattice exactly like the reference's Settings schema
  (macarons/utility/macarons_utils.py:2152-2184).

Generation is voxel-based: a (2n+1, 2m+1) plan grid alternates cell interiors
(odd indices) and wall slabs (even indices); a maze (recursive backtracker)
decides which wall slabs open into corridors. Boundary faces between air and
solid become quads -> triangles, wound so normals face *into* the air volume.

Four difficulty levels mirror AiMDoom simple/normal/hard/insane via maze size.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from ..config import Settings

DIFFICULTY_GRID = {
    "simple": 4,
    "normal": 6,
    "hard": 9,
    "insane": 13,
}

# World-scale dimensions (post scene_scale_factor=10 units).
CELL_SIZE = 12.0   # interior cell width -> 4 camera-lattice steps of 3 units
WALL_THICKNESS = 1.5
WALL_HEIGHT = 9.0
FLOOR_Y = 0.0


def _maze_edges(n: int, m: int, rng: np.random.Generator,
                loop_fraction: float = 0.15):
    """Recursive-backtracker maze over an n x m cell grid.

    Returns two boolean arrays: open_x[n-1, m] (wall between (i,j)-(i+1,j)
    removed) and open_z[n, m-1]. A fraction of extra walls is removed to
    create loops (Doom maps are not perfect mazes).
    """
    open_x = np.zeros((max(n - 1, 0), m), dtype=bool)
    open_z = np.zeros((n, max(m - 1, 0)), dtype=bool)
    visited = np.zeros((n, m), dtype=bool)
    stack = [(rng.integers(n), rng.integers(m))]
    visited[stack[0]] = True
    while stack:
        i, j = stack[-1]
        neighbors = []
        if i + 1 < n and not visited[i + 1, j]:
            neighbors.append((i + 1, j, "x", i, j))
        if i - 1 >= 0 and not visited[i - 1, j]:
            neighbors.append((i - 1, j, "x", i - 1, j))
        if j + 1 < m and not visited[i, j + 1]:
            neighbors.append((i, j + 1, "z", i, j))
        if j - 1 >= 0 and not visited[i, j - 1]:
            neighbors.append((i, j - 1, "z", i, j - 1))
        if not neighbors:
            stack.pop()
            continue
        ni, nj, axis, wi, wj = neighbors[rng.integers(len(neighbors))]
        if axis == "x":
            open_x[wi, wj] = True
        else:
            open_z[wi, wj] = True
        visited[ni, nj] = True
        stack.append((ni, nj))
    # Open extra walls for loops.
    for arr in (open_x, open_z):
        closed = np.argwhere(~arr)
        k = int(loop_fraction * len(closed))
        if k > 0:
            picks = closed[rng.choice(len(closed), size=k, replace=False)]
            arr[tuple(picks.T)] = True
    return open_x, open_z


def _plan_air_grid(n: int, m: int, rng: np.random.Generator) -> np.ndarray:
    """(2n+1, 2m+1) boolean air occupancy of the plan grid."""
    open_x, open_z = _maze_edges(n, m, rng)
    G = np.zeros((2 * n + 1, 2 * m + 1), dtype=bool)
    G[1::2, 1::2] = True  # cell interiors
    for (i, j) in np.argwhere(open_x):
        G[2 * i + 2, 2 * j + 1] = True
    for (i, j) in np.argwhere(open_z):
        G[2 * i + 1, 2 * j + 2] = True
    return G


def _grid_coords(n_cells: int) -> np.ndarray:
    """Nonuniform plan-grid coordinates: wall, cell, wall, cell, ..., wall."""
    xs = [0.0]
    for k in range(2 * n_cells + 1):
        xs.append(xs[-1] + (WALL_THICKNESS if k % 2 == 0 else CELL_SIZE))
    return np.asarray(xs, dtype=np.float64)


def _extract_boundary_mesh(G: np.ndarray, xs: np.ndarray, zs: np.ndarray,
                           y0: float, y1: float):
    """Triangles bounding the air volume defined by plan grid G extruded
    from y0 to y1. Winding is consistent but normals point INTO THE SOLID
    (see module docstring: all consumers are orientation-agnostic)."""
    verts: Dict[Tuple[float, float, float], int] = {}
    faces = []

    def vid(p):
        key = (round(p[0], 6), round(p[1], 6), round(p[2], 6))
        if key not in verts:
            verts[key] = len(verts)
        return verts[key]

    def quad(p0, p1, p2, p3):
        a, b, c, d = vid(p0), vid(p1), vid(p2), vid(p3)
        faces.append((a, b, c))
        faces.append((a, c, d))

    ni, nj = G.shape
    for i in range(ni):
        for j in range(nj):
            if not G[i, j]:
                continue
            x0, x1 = xs[i], xs[i + 1]
            z0, z1 = zs[j], zs[j + 1]
            # floor (normal -y, into the solid)
            quad((x0, y0, z0), (x1, y0, z0), (x1, y0, z1), (x0, y0, z1))
            # ceiling (normal +y, into the solid)
            quad((x0, y1, z0), (x0, y1, z1), (x1, y1, z1), (x1, y1, z0))
            # -x wall
            if i == 0 or not G[i - 1, j]:
                quad((x0, y0, z0), (x0, y0, z1), (x0, y1, z1), (x0, y1, z0))
            # +x wall
            if i == ni - 1 or not G[i + 1, j]:
                quad((x1, y0, z0), (x1, y1, z0), (x1, y1, z1), (x1, y0, z1))
            # -z wall
            if j == 0 or not G[i, j - 1]:
                quad((x0, y0, z0), (x0, y1, z0), (x1, y1, z0), (x1, y0, z0))
            # +z wall
            if j == nj - 1 or not G[i, j + 1]:
                quad((x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1))

    v = np.zeros((len(verts), 3), dtype=np.float32)
    for key, idx in verts.items():
        v[idx] = key
    f = np.asarray(faces, dtype=np.int32)
    return v, f


@dataclasses.dataclass
class GeneratedScene:
    name: str
    verts: np.ndarray          # (V, 3) f32, world scale (scale factor applied)
    faces: np.ndarray          # (F, 3) i32
    settings: Settings         # world-scale settings
    air_grid: np.ndarray       # plan occupancy (debug/tests)
    start_cam_idx: np.ndarray  # (5,) int


def generate_scene(difficulty: str = "simple", seed: int = 0,
                   scene_scale_factor: float = 10.0,
                   name: Optional[str] = None) -> GeneratedScene:
    """Generate a world-scale scene + settings for a difficulty level.

    The generated coordinates are already in world scale (the equivalent of
    the reference's OBJ-units x scene_scale_factor).
    """
    n = DIFFICULTY_GRID[difficulty.lower()]
    rng = np.random.default_rng(seed)
    G = _plan_air_grid(n, n, rng)
    xs = _grid_coords(n)
    zs = _grid_coords(n)
    verts, faces = _extract_boundary_mesh(G, xs, zs, FLOOR_Y, FLOOR_Y + WALL_HEIGHT)

    x_min = np.array([verts[:, 0].min(), verts[:, 1].min(), verts[:, 2].min()],
                     dtype=np.float32)
    x_max = np.array([verts[:, 0].max(), verts[:, 1].max(), verts[:, 2].max()],
                     dtype=np.float32)

    # Camera pose lattice: x = x_min[0] + 3*i (reference Camera.__init__
    # macarons_utils.py:2316-2321), y fixed at x_min[1] + 3.3.
    # Offset the lattice origin so poses start inside the first cell.
    cam_x_min = x_min + np.array([WALL_THICKNESS + 1.0, 0.0, WALL_THICKNESS + 1.0],
                                 dtype=np.float32)
    cam_x_max = x_max
    pose_l = int((cam_x_max[0] - cam_x_min[0]) // 3.0) + 1
    pose_h = int((cam_x_max[2] - cam_x_min[2]) // 3.0) + 1

    # Start pose: center of the first maze cell, elevation index 2 (0 deg).
    cx = xs[1] + CELL_SIZE / 2.0
    cz = zs[1] + CELL_SIZE / 2.0
    i_l = int(round((cx - cam_x_min[0]) / 3.0))
    i_h = int(round((cz - cam_x_min[2]) / 3.0))
    start = np.array([i_l, 0, i_h, 2, 0], dtype=np.int64)

    sname = name or f"procgen_{difficulty}_{seed}"
    settings = Settings.from_dict(
        {
            "scene": {
                "x_min": (x_min / scene_scale_factor).tolist(),
                "x_max": (x_max / scene_scale_factor).tolist(),
                "grid_l": 5,
                "grid_w": 2,
                "grid_h": 5,
                "cell_capacity": 2000,
                "cell_resolution": 0.05,
            },
            "camera": {
                "x_min": (cam_x_min / scene_scale_factor).tolist(),
                "x_max": (cam_x_max / scene_scale_factor).tolist(),
                "pose_l": pose_l,
                "pose_w": 1,
                "pose_h": pose_h,
                "pose_n_theta": 5,
                "pose_n_azim": 8,
                "start_positions": [start.tolist()],
                "contrast_factor": 1.0,
            },
        },
        scene_scale_factor=scene_scale_factor,
    )
    return GeneratedScene(name=sname, verts=verts, faces=faces, settings=settings,
                          air_grid=G, start_cam_idx=start)
