"""Per-scene static planner tables (port of
``nextbestpath_tpu/sim/tables.py``): whether each lattice position is inside
the navigable volume, and whether each lattice edge's segment crosses the
mesh. Both are cast once per scene in one launch of kernel K2."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..ops.raytrace import inside_from_counts, inside_test_rays, ray_hits_full
from ..planning.grid_paths import DIRS, _off_grid, lattice_positions


class SceneTables(NamedTuple):
    positions: torch.Tensor        # (L, H, 3) lattice world positions
    inside: torch.Tensor           # (L, H) bool: inside the air volume
    gt_edge_blocked: torch.Tensor  # (4, L, H) bool: segment crosses mesh


def table_rays(positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Origins and directions (7 L H, 3) of a lattice's tables: the 3 L H
    inside-test rays (points_inside_mesh), then the 4 L H edge segments,
    direction by direction, each built by the same ops as in
    segments_hit_mesh."""
    flat = positions.reshape(-1, 3)
    in_o, in_d = inside_test_rays(flat)
    edge_d = []
    for dl, dh in DIRS:
        step = torch.tensor([3.0 * dl, 0.0, 3.0 * dh], dtype=torch.float32,
                            device=positions.device)
        edge_d.append((positions + step).reshape(-1, 3) - flat)
    return (torch.cat([in_o, flat.repeat(len(DIRS), 1)]),
            torch.cat([in_d, *edge_d]))


def build_scene_tables(tri_soa: torch.Tensor, n_tris,
                       pose_origin: torch.Tensor, L: int, H: int
                       ) -> SceneTables:
    """table_rays cast in one ray_hits_full call, t in (1e-6, 3.4e38). A
    segment is blocked where its nearest hit has t < 1, which is where
    segments_hit_mesh's cast with t_max = 1 finds a hit."""
    positions = lattice_positions(pose_origin, L, H)
    dev = positions.device
    n = L * H
    origins, dirs = table_rays(positions)
    t, cnt, _ = ray_hits_full(origins, dirs, tri_soa, n_tris, t_min=1e-6)
    inside = inside_from_counts(cnt[:3 * n]).reshape(L, H)
    hit = (t[3 * n:] < 1.0).reshape(len(DIRS), L, H)
    off = torch.stack([_off_grid(L, H, dl, dh, dev) for dl, dh in DIRS])
    return SceneTables(positions=positions, inside=inside,
                       gt_edge_blocked=hit | off)
