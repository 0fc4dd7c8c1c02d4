"""The coverage metric, in plain PyTorch: the share of the scene's GT
points that lie within 1.0 of a point of the stride sample of the
reconstructed cloud.

The sample is the paper's fast sampler: from the draws ``start`` in
[0, max(count, 1)) and ``stride_half`` in [1, max(count // 2, 2)), slot
k of the sample is (start + (2 stride_half + 1) k) mod max(count, 1), in
32-bit integer arithmetic, for k < count; the sample has 2 G slots
rounded up to 8192 (2048 for small clouds), capped by the capacity.
Distances are taken brute force over every (GT point, sample) pair.
"""

from __future__ import annotations

import torch


def n_sample_for(n_gt: int, capacity: int, weight: int = 2) -> int:
    raw = n_gt * weight
    chunk = 8192 if (raw >= 8192 and capacity >= 8192) else 2048
    n = ((raw + chunk - 1) // chunk) * chunk
    if n > capacity:
        n = max((capacity // chunk) * chunk, chunk)
    return n


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    return torch.remainder(x + 2 ** 31, 2 ** 32) - 2 ** 31


def stride_sample(start: int, stride_half: int, count: int, n_sample: int,
                  device):
    """(slots (n_sample,), valid (n_sample,)) of the stride sample."""
    k = torch.arange(n_sample, dtype=torch.int64, device=device)
    raw = _wrap32(int(start) + _wrap32((2 * int(stride_half) + 1) * k))
    return torch.remainder(raw, max(int(count), 1)), k < int(count)


def min_dists(gt: torch.Tensor, pts: torch.Tensor, dtype=torch.float64,
              chunk: int = 1024) -> torch.Tensor:
    """(G,) distance from each GT point to the nearest of pts, in dtype."""
    g = gt.to(dtype)
    p = pts.to(dtype)
    out = []
    for g0 in range(0, g.shape[0], chunk):
        gc = g[g0:g0 + chunk]
        d2 = ((gc[:, None, 0] - p[None, :, 0]) ** 2
              + (gc[:, None, 1] - p[None, :, 1]) ** 2
              + (gc[:, None, 2] - p[None, :, 2]) ** 2)
        out.append(torch.sqrt(d2.amin(1)))
    return torch.cat(out)


def coverage(gt: torch.Tensor, gt_valid: torch.Tensor, cloud: torch.Tensor,
             count: int, start: int, stride_half: int, n_sample: int,
             threshold: float = 1.0, dtype=torch.float64) -> float:
    """The share of the valid GT points covered by the stride sample of
    cloud[:count]; 0 for an empty cloud."""
    if count <= 0:
        return 0.0
    slots, valid = stride_sample(start, stride_half, count, n_sample,
                                 cloud.device)
    sample = cloud[slots[valid]]
    d = min_dists(gt[gt_valid], sample, dtype=dtype)
    return float((d < threshold).to(torch.float64).mean())
