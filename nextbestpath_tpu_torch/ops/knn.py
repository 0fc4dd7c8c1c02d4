"""Brute-force k-nearest neighbours for point clouds.

Port of ``nextbestpath_tpu/ops/knn.py`` (the pytorch3d ``knn_points``
stand-in of SconeOcc's local transformers): squared distances by the
expanded form q^2 + p^2 - 2 q.p with an f32 matmul, then the k smallest
by a stable sort, so ties go to the lower index as ``lax.top_k`` breaks
them (``torch.topk`` guarantees no order). Point counts are a few
thousand at most.
"""

from __future__ import annotations

import torch


def knn_indices(query: torch.Tensor, points: torch.Tensor, k: int
                ) -> torch.Tensor:
    """Indices of the k nearest points of each query, (B, Nq, k).

    query (B, Nq, 3); points (B, Np, 3)."""
    q2 = (query * query).sum(dim=-1)
    p2 = (points * points).sum(dim=-1)
    cross = torch.matmul(query, points.transpose(-1, -2))
    d2 = q2[..., :, None] + p2[..., None, :] - 2.0 * cross
    return torch.sort(d2, dim=-1, stable=True).indices[..., :k]


def gather_rows(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values (B, N, F) gathered at idx (B, Nq, k) -> (B, Nq, k, F)."""
    B = values.shape[0]
    return values[torch.arange(B, device=values.device)[:, None, None], idx]


def knn_points(query: torch.Tensor, points: torch.Tensor, k: int):
    """(neighbours (B, Nq, k, 3), indices (B, Nq, k))."""
    idx = knn_indices(query, points, k)
    return gather_rows(points, idx), idx
