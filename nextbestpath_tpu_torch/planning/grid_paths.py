"""Shortest paths on the camera pose lattice.

Port of ``nextbestpath_tpu/planning/grid_paths.py``. Edges have unit cost on
a 4-connected (i_l, i_h) grid, so one Bellman-Ford field from the current
node gives the distance to every node; the path is walked back from the
goal with neighbour preference in DIRS order (+x, -x, +z, -z), as the
reference's Dijkstra breaks ties.

The distance field and the path walk take and return tensors on one
device; on the card they are the kernels ``nbp_bfs_field`` and
``nbp_extract_path`` (``csrc/plan.cu``), with no host sync, and on the CPU
their plain versions. ``bfs_distance_field_scenes`` and
``extract_path_scenes`` do the same for B lattices at once (one launch
each). Each takes an optional ``skip`` flag (one a scene, a bool tensor on
the inputs' device): where it is set the result is defined at once and no
search runs, the field all INF and the path all -1, of length 0 and
unreachable. The scan's planning attempts pass their "done" flags, whose
results they discard.

Edge memos: 0 unknown (use the layout test), 1 known passable, 2 known
collision.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import kernels
from ..ops.scatter2d import ego2d, img_coords
from .bresenham import bresenham_obstacle_count

INF = 2 ** 20

DIRS = ((1, 0), (-1, 0), (0, 1), (0, -1))

EDGE_UNKNOWN = 0
EDGE_PASSABLE = 1
EDGE_COLLISION = 2


def lattice_positions(pose_origin: torch.Tensor, L: int, H: int
                      ) -> torch.Tensor:
    """(L, H, 3) world positions of the pose lattice (spacing 3)."""
    dev = pose_origin.device
    il = torch.arange(L, dtype=torch.float32, device=dev)
    ih = torch.arange(H, dtype=torch.float32, device=dev)
    x = pose_origin[0] + 3.0 * il[:, None]
    z = pose_origin[2] + 3.0 * ih[None, :]
    y = pose_origin[1].expand(L, H)
    return torch.stack([x.expand(L, H), y, z.expand(L, H)], dim=-1)


def _off_grid(L: int, H: int, dl: int, dh: int, device) -> torch.Tensor:
    il = torch.arange(L, device=device)[:, None]
    ih = torch.arange(H, device=device)[None, :]
    return (il + dl < 0) | (il + dl >= L) | (ih + dh < 0) | (ih + dh >= H)


def layout_edge_blocked(positions: torch.Tensor, cam_xyz: torch.Tensor,
                        layout_image: torch.Tensor, L: int, H: int,
                        layout_size: int = 256,
                        grid_range: Tuple[float, float] = (-40.0, 40.0)
                        ) -> torch.Tensor:
    """(4, L, H) edge-blocked mask from the fused layout image: blocked when
    an endpoint projects outside the image, the Bresenham line crosses >= 2
    obstacle pixels, or the edge leaves the grid. All four directions'
    lines are walked in one batch."""
    dev = positions.device
    p2 = ego2d(positions.reshape(-1, 3), cam_xyz)
    px = img_coords(p2, layout_size, grid_range).reshape(L, H, 2)
    in_img = ((px[..., 0] >= 0) & (px[..., 0] < layout_size)
              & (px[..., 1] >= 0) & (px[..., 1] < layout_size))
    dst = torch.stack([torch.roll(px, shifts=(-dl, -dh), dims=(0, 1))
                       for dl, dh in DIRS])                 # (4, L, H, 2)
    dst_in = torch.stack([torch.roll(in_img, shifts=(-dl, -dh), dims=(0, 1))
                          for dl, dh in DIRS])
    src = px.expand(4, L, H, 2)
    hi = layout_size - 1
    count = bresenham_obstacle_count(
        src[..., 0].clamp(0, hi).reshape(-1), src[..., 1].clamp(0, hi).reshape(-1),
        dst[..., 0].clamp(0, hi).reshape(-1), dst[..., 1].clamp(0, hi).reshape(-1),
        layout_image).reshape(4, L, H)
    off = torch.stack([_off_grid(L, H, dl, dh, dev) for dl, dh in DIRS])
    return (~in_img)[None] | (~dst_in) | (count >= 2) | off


def apply_edge_memo(layout_blocked: torch.Tensor, edge_memo: torch.Tensor
                    ) -> torch.Tensor:
    """Passable memos override the layout test; collisions always block."""
    return torch.where(edge_memo == EDGE_PASSABLE,
                       torch.zeros_like(layout_blocked),
                       torch.where(edge_memo == EDGE_COLLISION,
                                   torch.ones_like(layout_blocked),
                                   layout_blocked))


_SWEEPS_PER_CHECK = 4  # relaxation sweeps between change tests


def _start_mask(start_lh: torch.Tensor, L: int, H: int) -> torch.Tensor:
    il = torch.arange(L, device=start_lh.device)[:, None]
    ih = torch.arange(H, device=start_lh.device)[None, :]
    return (il == start_lh[0]) & (ih == start_lh[1])


def _gather_index(i: int, n: int) -> int:
    """The element a JAX gather reads at index i of an axis of n: a
    negative index counts from the end, then the index is clamped."""
    return min(max(i + n if i < 0 else i, 0), n - 1)


def _skipped(skip) -> bool:
    """Whether a skip flag (a bool tensor or None) is set; reads it on the
    host."""
    return skip is not None and bool(skip)


def bfs_distance_field_plain(blocked: torch.Tensor, start_lh: torch.Tensor,
                             L: int, H: int, skip=None) -> torch.Tensor:
    """Plain version of ``nbp_bfs_field``: relaxation sweeps run to the
    fixpoint (at most L*H sweeps: a maze path can wind through most of the
    grid), the change test taken every few sweeps; sweeps past the
    fixpoint change nothing. The test reads the tensors on the host, so on
    CUDA tensors it syncs every few sweeps. ``skip`` set: all INF."""
    dev = blocked.device
    if _skipped(skip):
        return torch.full((L, H), INF, dtype=torch.int32, device=dev)
    dist = torch.where(_start_mask(start_lh, L, H),
                       torch.zeros((L, H), dtype=torch.int32, device=dev),
                       torch.full((L, H), INF, dtype=torch.int32, device=dev))
    # Incoming edge to (i, j) from (i, j) - DIRS[d] uses blocked[d] at the
    # source; roll wraps, so sources off the grid are masked explicitly.
    bad = torch.stack([
        torch.roll(blocked[d], shifts=(dl, dh), dims=(0, 1))
        | _off_grid(L, H, -dl, -dh, dev)
        for d, (dl, dh) in enumerate(DIRS)])
    inf = torch.full_like(dist, INF)
    it = 0
    while it < L * H:
        prev = dist
        for _ in range(_SWEEPS_PER_CHECK):
            for d, (dl, dh) in enumerate(DIRS):
                cand = torch.where(
                    bad[d], inf, torch.roll(dist, shifts=(dl, dh),
                                            dims=(0, 1)) + 1)
                dist = torch.minimum(dist, cand)
        it += _SWEEPS_PER_CHECK
        if not bool((dist < prev).any()):
            break
    return dist


def bfs_distance_field(blocked: torch.Tensor, start_lh: torch.Tensor,
                       L: int, H: int, skip=None) -> torch.Tensor:
    """(L, H) int32 unit-cost distances from start_lh ((2,) int64 on the
    device; INF unreachable). blocked[d, i, j]: edge (i, j) -> (i, j) +
    DIRS[d] impassable; ``skip`` (a 0-d bool on the device, or None) set:
    all INF. The kernel ``nbp_bfs_field`` on CUDA tensors (no sync), its
    plain version on CPU tensors."""
    start_lh = torch.as_tensor(start_lh, device=blocked.device)
    if blocked.device.type == "cpu":
        return bfs_distance_field_plain(blocked, start_lh, L, H, skip)
    return kernels.bfs_field(blocked.contiguous(),
                             start_lh.to(torch.int64).contiguous(), skip)


def extract_path_plain(dist: torch.Tensor, blocked: torch.Tensor,
                       goal_lh: torch.Tensor, L: int, H: int,
                       max_len: int = 96, skip=None):
    """Plain version of ``nbp_extract_path``: the walk back from the goal
    as a scalar loop on the host (it reads the inputs to the host, so on
    CUDA tensors it syncs); the outputs on the inputs' device. ``skip``
    set: path all -1, length 0, unreachable."""
    dev = dist.device
    if _skipped(skip):
        return (torch.full((max_len, 2), -1, dtype=torch.int32, device=dev),
                torch.tensor(0, dtype=torch.int32, device=dev),
                torch.tensor(False, device=dev))
    d_np = dist.cpu().numpy()
    b_np = blocked.cpu().numpy()
    goal = (int(goal_lh[0]), int(goal_lh[1]))
    goal_dist = int(d_np[_gather_index(goal[0], L), _gather_index(goal[1], H)])
    reachable = goal_dist < INF
    path_len = min(goal_dist, max_len)
    limit = goal_dist if reachable else 0
    rev = [[-1, -1] for _ in range(max_len)]
    node = goal
    d = goal_dist
    for it in range(limit):
        rev[it % max_len] = [node[0], node[1]]
        best = node
        if d > 0:
            for k, (dl, dh) in enumerate(DIRS):
                pl, ph = node[0] - dl, node[1] - dh
                if not (0 <= pl < L and 0 <= ph < H):
                    continue
                if not b_np[k, pl, ph] and d_np[pl, ph] == d - 1:
                    best = (pl, ph)
                    break
        node = best
        d = max(d - 1, 0)
    gd = goal_dist if reachable else 1
    path = [rev[(gd - 1 - j) % max_len] if j < path_len else [-1, -1]
            for j in range(max_len)]
    return (torch.tensor(path, dtype=torch.int32, device=dev),
            torch.tensor(path_len, dtype=torch.int32, device=dev),
            torch.tensor(reachable, device=dev))


def extract_path(dist: torch.Tensor, blocked: torch.Tensor,
                 goal_lh: torch.Tensor, L: int, H: int, max_len: int = 96,
                 skip=None):
    """Walk from the goal back to the start along decreasing distances,
    preferring predecessors in DIRS order.

    Returns (path (max_len, 2) int32 start->goal without the start node, -1
    past the length; path_len 0-d int32; reachable 0-d bool), on the
    inputs' device. When the goal is further than max_len the max_len nodes
    nearest the START are kept (a circular buffer of max_len nodes), so
    path[0] is always adjacent to the start. A goal off the lattice is
    taken as the JAX function takes it: its distance read where a JAX
    gather reads (a negative index from the end, then clamped), the walk
    begun at the goal itself, which it leaves only for a predecessor on the
    lattice. ``skip`` (a 0-d bool on the
    device, or None) set: path all -1, length 0, unreachable. The kernel
    ``nbp_extract_path`` on CUDA tensors (no sync), its plain version on CPU
    tensors."""
    goal_lh = torch.as_tensor(goal_lh, device=dist.device)
    if dist.device.type == "cpu":
        return extract_path_plain(dist, blocked, goal_lh, L, H, max_len, skip)
    path, meta = kernels.extract_path(dist.contiguous(), blocked.contiguous(),
                                      goal_lh.to(torch.int64).contiguous(),
                                      max_len, skip)
    return path, meta[0], meta[1] != 0


def _scene_flags(skip, n_b: int):
    """A scene's skip flag each: skip's rows, or None for every scene."""
    return [None] * n_b if skip is None else list(skip.reshape(n_b))


def bfs_distance_field_scenes_plain(blocked: torch.Tensor,
                                    start_lh: torch.Tensor, L: int, H: int,
                                    skip=None) -> torch.Tensor:
    """Plain version of ``nbp_bfs_field``'s scene axis: blocked
    (B, 4, L, H), start_lh (B, 2), skip (B,) or None -> (B, L, H), each
    scene's own field."""
    return torch.stack([
        bfs_distance_field_plain(b, s, L, H, k)
        for b, s, k in zip(blocked, start_lh,
                           _scene_flags(skip, blocked.shape[0]))])


def bfs_distance_field_scenes(blocked: torch.Tensor, start_lh: torch.Tensor,
                              L: int, H: int, skip=None) -> torch.Tensor:
    """``bfs_distance_field`` of B lattices: blocked (B, 4, L, H) bool,
    start_lh (B, 2), skip (B,) bool or None -> (B, L, H) int32. One
    ``nbp_bfs_field`` launch on CUDA tensors, its plain version on CPU
    tensors."""
    if blocked.device.type == "cpu":
        return bfs_distance_field_scenes_plain(blocked, start_lh, L, H, skip)
    return kernels.bfs_field_scenes(blocked.contiguous(),
                                    start_lh.to(torch.int64).contiguous(),
                                    skip)


def extract_path_scenes_plain(dist: torch.Tensor, blocked: torch.Tensor,
                              goal_lh: torch.Tensor, L: int, H: int,
                              max_len: int = 96, skip=None):
    """Plain version of ``nbp_extract_path``'s scene axis: each scene's
    own walk, stacked."""
    outs = [extract_path_plain(d, b, g, L, H, max_len, k)
            for d, b, g, k in zip(dist, blocked, goal_lh,
                                  _scene_flags(skip, dist.shape[0]))]
    return tuple(torch.stack([o[i] for o in outs]) for i in range(3))


def extract_path_scenes(dist: torch.Tensor, blocked: torch.Tensor,
                        goal_lh: torch.Tensor, L: int, H: int,
                        max_len: int = 96, skip=None):
    """``extract_path`` of B lattices: dist (B, L, H), blocked (B, 4, L, H),
    goal_lh (B, 2), skip (B,) bool or None -> (path (B, max_len, 2) int32,
    path_len (B,) int32, reachable (B,) bool). One ``nbp_extract_path``
    launch on CUDA tensors, its plain version on CPU tensors."""
    if dist.device.type == "cpu":
        return extract_path_scenes_plain(dist, blocked, goal_lh, L, H,
                                         max_len, skip)
    path, meta = kernels.extract_path_scenes(
        dist.contiguous(), blocked.contiguous(),
        goal_lh.to(torch.int64).contiguous(), max_len, skip)
    return path, meta[:, 0], meta[:, 1] != 0


def pick_orientations(path: torch.Tensor, path_valid: torch.Tensor,
                      value_map: torch.Tensor, positions: torch.Tensor,
                      cam_xyz: torch.Tensor, visited_rot: torch.Tensor,
                      rand_u: torch.Tensor, n_azim: int = 8,
                      value_map_size: int = 64,
                      grid_range: Tuple[float, float] = (-40.0, 40.0)
                      ) -> torch.Tensor:
    """Per-waypoint orientation: inside the value map, the best-ranked
    orientation not yet visited at that position (the best if all were);
    outside, a random unvisited one from the uniform draws rand_u
    (max_len, n_azim)."""
    L, H = positions.shape[:2]
    pl = path[:, 0].clamp(0, L - 1).long()
    ph = path[:, 1].clamp(0, H - 1).long()
    p2 = ego2d(positions[pl, ph], cam_xyz)
    pix = img_coords(p2, value_map_size, grid_range)
    in_map = ((pix[:, 0] >= 0) & (pix[:, 0] < value_map_size)
              & (pix[:, 1] >= 0) & (pix[:, 1] < value_map_size))
    pixc = pix.clamp(0, value_map_size - 1).long()
    gains = value_map[pixc[:, 0], pixc[:, 1], :]
    visited = visited_rot[pl, ph, :]
    order = torch.argsort(-gains, dim=-1, stable=True)
    ranked_free = ~torch.gather(visited, -1, order)
    first_free = torch.argmax(ranked_free.to(torch.int8), dim=-1)
    any_free = ranked_free.any(-1)
    pick = torch.where(any_free, first_free, torch.zeros_like(first_free))
    best_rot = torch.gather(order, -1, pick[:, None])[:, 0]
    rand_scores = rand_u.to(torch.float32) + visited.to(torch.float32) * 10.0
    rand_rot = torch.argmin(rand_scores, dim=-1)
    rot = torch.where(in_map, best_rot, rand_rot)
    return torch.where(path_valid, rot, torch.zeros_like(rot)).to(torch.int32)
