"""Per-scene static planner tables (port of
``nextbestpath_tpu/sim/tables.py``): whether each lattice position is inside
the navigable volume, and whether each lattice edge's segment crosses the
mesh. Both are cast once per scene with kernel K2."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.raytrace import points_inside_mesh, segments_hit_mesh
from ..planning.grid_paths import DIRS, _off_grid, lattice_positions


class SceneTables(NamedTuple):
    positions: torch.Tensor        # (L, H, 3) lattice world positions
    inside: torch.Tensor           # (L, H) bool: inside the air volume
    gt_edge_blocked: torch.Tensor  # (4, L, H) bool: segment crosses mesh


def build_scene_tables(tri_soa: torch.Tensor, n_tris,
                       pose_origin: torch.Tensor, L: int, H: int
                       ) -> SceneTables:
    positions = lattice_positions(pose_origin, L, H)
    flat = positions.reshape(-1, 3)
    inside = points_inside_mesh(flat, tri_soa, n_tris).reshape(L, H)
    blocked = []
    for dl, dh in DIRS:
        step = torch.tensor([3.0 * dl, 0.0, 3.0 * dh], dtype=torch.float32,
                            device=positions.device)
        dst = (positions + step).reshape(-1, 3)
        hit = segments_hit_mesh(flat, dst, tri_soa, n_tris).reshape(L, H)
        blocked.append(hit | _off_grid(L, H, dl, dh, positions.device))
    return SceneTables(positions=positions, inside=inside,
                       gt_edge_blocked=torch.stack(blocked))
