"""Segment-against-point-cloud collision predicates.

Port of ``nextbestpath_tpu/ops/pc_collision.py`` (the reference's
long_term_utils.py ``line_segment_intersects_point_cloud_region`` and
``predict_collision_with_occupancy_field``): one vectorised point-to-
segment distance over a fixed-capacity masked buffer, and a reduction a
predicate. ``segment_point_distances`` also takes E segments at once, (E,
3) endpoints giving (E, N) distances, for ``planning/bidirectional.py``.
"""

from __future__ import annotations

import torch


def segment_point_distances(points: torch.Tensor, a: torch.Tensor,
                            b: torch.Tensor) -> torch.Tensor:
    """Distance from each point (N, 3) to segment a-b: (N,) for a, b (3,),
    (E, N) for a, b (E, 3). Points whose projection parameter lies in [0,
    1] take the perpendicular distance, the others the nearer endpoint's;
    a degenerate segment (|b - a| ~ 0) gives the distance to a."""
    line = b - a
    len_sq = torch.clamp((line * line).sum(dim=-1), min=1e-12)
    to_a = points - a[..., None, :]
    t = (to_a * line[..., None, :]).sum(dim=-1) / len_sq[..., None]
    closest = a[..., None, :] + t[..., None] * line[..., None, :]
    d_perp = torch.linalg.norm(points - closest, dim=-1)
    d_ends = torch.minimum(torch.linalg.norm(to_a, dim=-1),
                           torch.linalg.norm(points - b[..., None, :], dim=-1))
    return torch.where((t >= 0.0) & (t <= 1.0), d_perp, d_ends)


def segment_intersects_point_cloud(points: torch.Tensor, valid: torch.Tensor,
                                   a: torch.Tensor, b: torch.Tensor,
                                   threshold: float = 0.2) -> torch.Tensor:
    """True when any valid point lies within ``threshold`` of segment a-b
    (the reference's fixed 0.2 world units by default)."""
    d = segment_point_distances(points, a, b)
    return (valid & (d < threshold)).any()


def collision_with_occupancy_field(points: torch.Tensor,
                                   occ_probs: torch.Tensor,
                                   valid: torch.Tensor,
                                   a: torch.Tensor, b: torch.Tensor,
                                   threshold_distance: float = 1.0,
                                   prob_threshold: float = 0.9,
                                   min_count: int = 5) -> torch.Tensor:
    """True when at least ``min_count`` valid points within
    ``threshold_distance`` of the segment have occupancy probability above
    ``prob_threshold`` (the reference's constants by default)."""
    d = segment_point_distances(points, a, b)
    close = valid & (d < threshold_distance)
    hits = (close & (occ_probs.reshape(-1) > prob_threshold)).sum()
    return hits >= min_count
