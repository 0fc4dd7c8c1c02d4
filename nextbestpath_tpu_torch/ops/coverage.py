"""Coverage metric over fixed-capacity point buffers.

Port of ``nextbestpath_tpu/ops/coverage.py`` (the parts the rollouts run):
the share of GT points with a reconstructed point within the threshold,
against a random subsample of the cloud, and its AUC. Two samplers, as the
JAX package's: the stride subsample (``fast_sampling=True``, the scan and
the ``shared_rng`` host rollout) and the exact random permutation by a
stable argsort over the whole capacity (``subsample_buffer``, the legacy
host rollout and the random walk).

``min_dists`` launches kernel K3 (``csrc/coverage.cu``) for CUDA tensors and
takes its plain version, ``min_sq_dists_plain``, for CPU tensors. Both take
squared distances from the f32 differences, summed in index order.
``coverage_percentage_scenes`` is the stride metric of B scenes with one K3
launch on a scene axis (``min_sq_dists_scenes_plain`` on the CPU).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import kernels

_S_SENTINEL = 1e9  # invalid sampled slots are moved here (d^2 ~ 3e18 < inf)
_NO_SAMPLE = 1e30
_PAIRS = 1 << 22   # (GT, sample) pairs per chunk of the plain version


def masked_min_dists(gt: torch.Tensor, pts: torch.Tensor,
                     pts_valid: torch.Tensor) -> torch.Tensor:
    """Dense reference: min Euclidean distance from each GT point to the
    valid pts, (G,), from f32 differences; 1e15 where none is valid."""
    s = torch.where(pts_valid[:, None], pts, torch.full_like(pts, _S_SENTINEL))
    return torch.sqrt(torch.clamp(
        min_sq_dists_plain(gt, s.contiguous(), pts.shape[0]), min=0.0))


def min_sq_dists_plain(g: torch.Tensor, s: torch.Tensor, s_count
                       ) -> torch.Tensor:
    """Plain version of K3: (G,) min over the first s_count rows of s of
    (dx*dx + dy*dy) + dz*dz; 1e30 when s_count is 0."""
    n = max(0, min(int(s_count), s.shape[0]))
    best = torch.full((g.shape[0],), _NO_SAMPLE, dtype=torch.float32,
                      device=g.device)
    if n == 0:
        return best
    s = s[:n]
    g_rows = max(1, min(g.shape[0], 4096))
    s_cols = max(1, _PAIRS // g_rows)
    for g0 in range(0, g.shape[0], g_rows):
        gc = g[g0:g0 + g_rows]
        b = best[g0:g0 + g_rows]
        for s0 in range(0, n, s_cols):
            sc = s[s0:s0 + s_cols]
            dx = gc[:, 0:1] - sc[:, 0]
            dy = gc[:, 1:2] - sc[:, 1]
            dz = gc[:, 2:3] - sc[:, 2]
            d2 = (dx * dx + dy * dy) + dz * dz
            b = torch.minimum(b, d2.amin(dim=1))
        best[g0:g0 + g_rows] = b
    return best


def min_sq_dists_scenes_plain(g: torch.Tensor, s: torch.Tensor,
                              s_counts: torch.Tensor) -> torch.Tensor:
    """Plain version of K3's scene axis: g (B, G, 3), s (B, S, 3), s_counts
    (B,) -> (B, G), row b ``min_sq_dists_plain`` of scene b."""
    return torch.stack([min_sq_dists_plain(gb, sb, int(c)) for gb, sb, c
                        in zip(g, s, s_counts.tolist())])


def min_sq_dists_scenes(g: torch.Tensor, s: torch.Tensor,
                        s_counts: torch.Tensor) -> torch.Tensor:
    """K3 on a scene axis: g (B, G, 3), s (B, S, 3) f32, s_counts (B,)
    int32 -> (B, G), one launch for CUDA tensors, the plain version for CPU
    tensors."""
    if g.device.type == "cpu":
        return min_sq_dists_scenes_plain(g, s, s_counts)
    return kernels.min_sq_dists_scenes(g, s, s_counts)


def min_dists(gt: torch.Tensor, pts: torch.Tensor, pts_valid: torch.Tensor,
              s_count=None) -> torch.Tensor:
    """Min ||gt_i - pts_j|| over the valid pts, (G,).

    s_count bounds the loop to the valid prefix (pass a device tensor to
    avoid a host sync). K3 on CUDA tensors, its plain version on CPU."""
    s = torch.where(pts_valid[:, None], pts.to(torch.float32),
                    torch.full_like(pts, _S_SENTINEL, dtype=torch.float32))
    s = s.contiguous()
    g = gt.to(torch.float32).contiguous()
    if s_count is None:
        s_count = pts.shape[0]
    if g.device.type == "cpu":
        d2 = min_sq_dists_plain(g, s, s_count)
    else:
        d2 = kernels.min_sq_dists(g, s, s_count)
    return torch.sqrt(torch.clamp(d2, min=0.0))


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the value int32 arithmetic would have wrapped to."""
    return torch.remainder(x + 2 ** 31, 2 ** 32) - 2 ** 31


def stride_subsample(start: torch.Tensor, stride_half: torch.Tensor,
                     count: torch.Tensor, n_sample: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random start + large odd stride modulo count over the valid prefix.

    start in [0, max(count, 1)), stride_half in [1, max(count // 2, 2)) are
    the random draws; stride = 2 * stride_half + 1. The index arithmetic
    wraps as the JAX package's int32 arithmetic does."""
    dev = count.device
    c = torch.clamp(count.long(), min=1)
    stride = 2 * stride_half.long() + 1
    k = torch.arange(n_sample, dtype=torch.int64, device=dev)
    raw = _wrap_int32(start.long() + _wrap_int32(stride * k))
    idx = torch.remainder(raw, c)
    valid = k < count.long()
    return idx, valid


def n_sample_for(n_gt: int, capacity: int, weight: int = 2) -> int:
    """Subsample size: weight * n_gt rounded up to the chunk the JAX
    package's metric uses (8192, or 2048 for small problems)."""
    raw = n_gt * weight
    chunk = 8192 if (raw >= 8192 and capacity >= 8192) else 2048
    n_sample = ((raw + chunk - 1) // chunk) * chunk
    if n_sample > capacity:
        n_sample = max((capacity // chunk) * chunk, chunk)
    return n_sample


def subsample_buffer(scores_u: torch.Tensor, count: torch.Tensor,
                     n_sample: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random subset without replacement of the buffer's valid prefix.

    scores_u: (C,) uniform draws, one a slot of the whole capacity. Invalid
    slots score 2.0 and a stable argsort keeps the n_sample smallest, ties
    to the lower slot, as ``jnp.argsort``; uniform f32 draws do tie at a
    2M capacity. Returns (indices, valid): when count <= n_sample every
    valid slot is taken once, and the valid ones lead."""
    slots = torch.arange(scores_u.shape[0], device=scores_u.device)
    scores = torch.where(slots < count, scores_u.to(torch.float32),
                         torch.full_like(scores_u, 2.0, dtype=torch.float32))
    idx = torch.sort(scores, stable=True).indices[:n_sample]
    return idx, idx < count


def _coverage_of_sample(gt: torch.Tensor, pts: torch.Tensor,
                        count: torch.Tensor, idx: torch.Tensor,
                        valid: torch.Tensor, threshold: float,
                        gt_valid: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    # Both samplers put their valid slots in a leading prefix, so the count
    # bounds K3's inner loop. K3 gives padded GT rows a distance too; the
    # mask drops them after it.
    dmin = min_dists(gt, pts[idx], valid, s_count=count)
    close = (dmin < threshold).to(torch.float32)
    if gt_valid is None:
        cov = close.sum() / max(gt.shape[0], 1)
    else:
        close = close * gt_valid
        cov = close.sum() / torch.clamp(gt_valid.sum(), min=1)
    return torch.where(count > 0, cov, torch.zeros_like(cov))


def coverage_percentage(gt: torch.Tensor, pts: torch.Tensor,
                        count: torch.Tensor, start: torch.Tensor,
                        stride_half: torch.Tensor, threshold: float = 1.0,
                        weight: int = 2,
                        gt_valid: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Share of GT points within ``threshold`` of the stride subsample of
    the buffer (the JAX package's ``fast_sampling=True``); 0 when the
    buffer is empty. Returns a 0-d f32 tensor on the buffer's device.

    gt_valid (G,) bool masks padded GT rows (a scene padded to a common
    G): they leave the numerator, and the denominator is the valid count.
    The sample's size follows the padded G, as the JAX package's does."""
    n_sample = n_sample_for(gt.shape[0], pts.shape[0], weight)
    idx, valid = stride_subsample(start, stride_half, count, n_sample)
    return _coverage_of_sample(gt, pts, count, idx, valid, threshold,
                               gt_valid)


def coverage_percentage_scenes(gt: torch.Tensor, pts: torch.Tensor,
                               counts: torch.Tensor, starts: torch.Tensor,
                               stride_halves: torch.Tensor,
                               gt_valid: torch.Tensor, threshold: float = 1.0,
                               weight: int = 2) -> torch.Tensor:
    """``coverage_percentage`` of B scenes at once: gt (B, G, 3) and gt_valid
    (B, G) padded to one G, buffers pts (B, C, 3) with counts (B,) int32,
    the draws starts and stride_halves (B,). The B stride samples go to one
    K3 launch on a scene axis (its plain version on the CPU). Returns (B,)
    f32, entry b bit-equal to scene b's own call with its gt_valid."""
    n_sample = n_sample_for(gt.shape[1], pts.shape[1], weight)
    samples = []
    for b in range(gt.shape[0]):
        idx, valid = stride_subsample(starts[b], stride_halves[b], counts[b],
                                      n_sample)
        p = pts[b][idx].to(torch.float32)
        samples.append(torch.where(valid[:, None], p,
                                   torch.full_like(p, _S_SENTINEL)))
    s = torch.stack(samples).contiguous()
    g = gt.to(torch.float32).contiguous()
    d2 = min_sq_dists_scenes(g, s, counts.to(torch.int32).contiguous())
    dmin = torch.sqrt(torch.clamp(d2, min=0.0))
    close = (dmin < threshold).to(torch.float32) * gt_valid
    cov = close.sum(dim=1) / torch.clamp(gt_valid.sum(dim=1), min=1)
    return torch.where(counts > 0, cov, torch.zeros_like(cov))


def coverage_percentage_exact(gt: torch.Tensor, pts: torch.Tensor,
                              count: torch.Tensor, scores_u: torch.Tensor,
                              threshold: float = 1.0, weight: int = 2
                              ) -> torch.Tensor:
    """``coverage_percentage`` over the exact random-permutation subsample
    (``subsample_buffer`` with ``scores_u``, (C,) draws; the JAX package's
    default ``fast_sampling=False``)."""
    n_sample = n_sample_for(gt.shape[0], pts.shape[0], weight)
    idx, valid = subsample_buffer(scores_u, count, n_sample)
    return _coverage_of_sample(gt, pts, count, idx, valid, threshold)


def compute_auc(y, dx: float = 1.0 / 40.0) -> float:
    """Trapezoid AUC + half the first sample."""
    y = np.asarray(y, dtype=np.float64)
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    return float(trapezoid(y, dx=dx) + y[0] * dx / 2.0)
