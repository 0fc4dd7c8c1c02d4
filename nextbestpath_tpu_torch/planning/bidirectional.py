"""Bidirectional shortest-path planner with point-cloud edges.

Port of ``nextbestpath_tpu/planning/bidirectional.py`` (the reference's
``generate_Bidirectional_Dijkstra_path``, long_term_utils.py:175-254): the
pose lattice searched from both ends with unit-cost edges, an edge
traversable iff its move segment stays at least 0.2 world units from every
reconstructed point.

Every lattice edge is tested at once (``pc_edge_blocked``: the 4 L H
segments against the N points as one (4 L H, N) distance reduction, taken
in chunks of the points so that the largest lattice against a 2M-point
buffer fits), then the search, a few hundred unit-cost nodes, is a host
BFS meeting in the middle (``bidirectional_grid_path``, a copy of the JAX
package's). Edges are symmetric, so it returns the reference's optimal
paths.
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops.pc_collision import segment_point_distances
from .grid_paths import DIRS

# Segment-point pairs of one chunk of pc_edge_blocked: about 16 bytes of
# each of five temporaries a pair.
CHUNK_PAIRS = 1 << 23


def pc_edge_blocked(positions: torch.Tensor, points: torch.Tensor,
                    valid: torch.Tensor, threshold: float = 0.2,
                    chunk_pairs: int = CHUNK_PAIRS) -> torch.Tensor:
    """(4, L, H) bool: the unit move (dir, l, h) passes within
    ``threshold`` of a valid point, or leaves the grid."""
    L, H = positions.shape[0], positions.shape[1]
    dev = positions.device
    dirs = torch.tensor(DIRS, dtype=torch.long, device=dev)
    ll = torch.arange(L, device=dev)[None, :, None]
    hh = torch.arange(H, device=dev)[None, None, :]
    nl = ll + dirs[:, 0, None, None]
    nh = hh + dirs[:, 1, None, None]
    in_grid = (nl >= 0) & (nl < L) & (nh >= 0) & (nh < H)
    a = positions.expand(4, L, H, 3).reshape(-1, 3)
    b = positions[nl.clamp(0, L - 1), nh.clamp(0, H - 1)].reshape(-1, 3)
    n_edges = a.shape[0]
    dmin = torch.full((n_edges,), float("inf"), dtype=points.dtype,
                      device=dev)
    step = max(1, chunk_pairs // n_edges)
    inf = torch.tensor(float("inf"), dtype=points.dtype, device=dev)
    for s in range(0, points.shape[0], step):
        d = segment_point_distances(points[s:s + step], a, b)
        d = torch.where(valid[s:s + step][None, :], d, inf)
        dmin = torch.minimum(dmin, d.min(dim=1).values)
    return (~in_grid) | (dmin < threshold).reshape(4, L, H)


def bidirectional_grid_path(blocked: np.ndarray,
                            start: Tuple[int, int],
                            goal: Tuple[int, int],
                            ) -> Optional[List[Tuple[int, int]]]:
    """Bidirectional unit-cost search over the lattice; the node list
    start..goal (inclusive), or None where the reference prints "No valid
    path found!". ``blocked``: a (4, L, H) edge mask (pc_edge_blocked, or
    any other edge source)."""
    blocked = np.asarray(blocked)
    L, H = blocked.shape[1], blocked.shape[2]
    start, goal = tuple(start), tuple(goal)
    if start == goal:
        return [start]

    parents = [{start: None}, {goal: None}]
    frontiers = [deque([start]), deque([goal])]
    meet = None
    while frontiers[0] and frontiers[1] and meet is None:
        # Expand the smaller frontier (standard bidirectional BFS).
        side = 0 if len(frontiers[0]) <= len(frontiers[1]) else 1
        for _ in range(len(frontiers[side])):
            node = frontiers[side].popleft()
            for d, (dl, dh) in enumerate(DIRS):
                if blocked[d, node[0], node[1]]:
                    continue
                nxt = (node[0] + dl, node[1] + dh)
                if not (0 <= nxt[0] < L and 0 <= nxt[1] < H):
                    continue
                if nxt in parents[side]:
                    continue
                parents[side][nxt] = node
                if nxt in parents[1 - side]:
                    meet = nxt
                    break
                frontiers[side].append(nxt)
            if meet is not None:
                break
    if meet is None:
        return None

    fwd = []
    cur: Optional[Tuple[int, int]] = meet
    while cur is not None:
        fwd.append(cur)
        cur = parents[0][cur]
    fwd.reverse()
    cur = parents[1][meet]
    while cur is not None:
        fwd.append(cur)
        cur = parents[1][cur]
    return fwd


def bidirectional_path_positions(positions: torch.Tensor,
                                 points: torch.Tensor, valid: torch.Tensor,
                                 start: Tuple[int, int],
                                 goal: Tuple[int, int],
                                 threshold: float = 0.2
                                 ) -> Optional[np.ndarray]:
    """Plan on point-cloud edges and return the world positions of the
    moves, the start excluded (the reference's ``real_move_path[1:]``)."""
    blocked = pc_edge_blocked(positions, points, valid,
                              threshold=threshold).cpu().numpy()
    path = bidirectional_grid_path(blocked, start, goal)
    if path is None or len(path) < 2:
        return None
    pos = positions.cpu().numpy()
    return np.asarray([pos[l, h] for (l, h) in path[1:]])
