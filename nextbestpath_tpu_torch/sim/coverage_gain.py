"""Predicted coverage gain of candidate cameras over the proxy field.

Port of ``nextbestpath_tpu/sim/coverage_gain.py`` (the reference's
predict_coverage_gain_for_single_camera): a candidate keeps the proxy
points in its range-limited frustum whose occupancy exceeds ``min_occ``,
samples seq_len tokens weighted by occupancy, normalises them into the
prediction box, runs SconeVis, and weights the mean visibility toward the
candidate by the in-frustum proxy volume (the sum of the occupancy
probabilities).

The C candidates go through one batched SconeVis call, as the JAX
package's ``vmap``. The token sample is ``jax.random.categorical``'s:
the argmax over the points of Gumbel noise (n_sample, P) plus the
log-probabilities, the noise a candidate served by the caller. On a card
every candidate's log-probabilities come at once as (C, P)
(``candidate_logits``) and one launch of the hand-written kernel G2
(``kernels.gumbel_argmax``) takes all C argmaxes, each noise tensor read
where it lies; on the CPU ``sample_proxy_points``, the plain version, runs
a candidate at a time. The run record counts the candidates drawn
(``token_draws``) and those the kernel drew (``kernel_draws``).
"""

from __future__ import annotations

from typing import Sequence

import torch

from .. import kernels
from ..geometry.cameras import CameraIntrinsics, get_camera_RT, points_in_fov_mask
from ..models.scone import SconeVis, coverage_gain
from ..ops.view_state import normalize_points_in_prediction_box
from ..utils.timing import count, span


def candidate_logits(occ_probs: torch.Tensor, masks: torch.Tensor,
                     min_occ: float = 0.1, use_occ_to_sample: bool = True
                     ) -> torch.Tensor:
    """Log-probabilities (C, P) of the occupancy-weighted draw of each of
    C candidates, from occupancies (P, 1) and masks (C, P) of the points
    that may be taken; uniform over all points for a candidate where none
    may. A candidate's total is its row's sum in the batch, which on a
    card may round an ulp apart from that row's sum alone."""
    occ = occ_probs[:, 0]
    w = occ if use_occ_to_sample else torch.ones_like(occ)
    w = torch.where((occ > min_occ) & masks, w, torch.zeros_like(w))
    total = w.sum(dim=1, keepdim=True)
    probs = torch.where(total > 0, w / torch.clamp(total, min=1e-12),
                        torch.full_like(w, 1.0 / w.shape[1]))
    return torch.log(torch.clamp(probs, min=1e-12))


def sample_proxy_points(noise: torch.Tensor, occ_probs: torch.Tensor,
                        weights_mask: torch.Tensor, min_occ: float = 0.1,
                        use_occ_to_sample: bool = True) -> torch.Tensor:
    """Occupancy-weighted categorical sample of proxy tokens, with
    replacement: (n_sample,) indices from Gumbel noise (n_sample, P),
    occupancies (P, 1) and a mask (P,) of the points that may be taken.
    Uniform over all points when none may. The plain version of one
    candidate's draw."""
    logits = candidate_logits(occ_probs, weights_mask[None], min_occ,
                              use_occ_to_sample)[0]
    return torch.argmax(noise + logits[None, :], dim=-1)


@torch.no_grad()
def predict_coverage_gain(noise: Sequence[torch.Tensor], scone_vis: SconeVis,
                          proxy_points: torch.Tensor,
                          occ_probs: torch.Tensor,
                          view_harmonics: torch.Tensor,
                          candidate_pose5: torch.Tensor,
                          intr: CameraIntrinsics, box_min: torch.Tensor,
                          box_max: torch.Tensor, sensor_range: float = 70.0,
                          min_occ: float = 0.1,
                          use_occ_to_sample: bool = True) -> torch.Tensor:
    """(C,) predicted coverage gains, weighted by the in-frustum volume; -1
    for a candidate that sees no proxy point. noise: a candidate's Gumbel
    noise (seq_len, P), C of them; proxy_points (P, 3), occ_probs (P, 1),
    view_harmonics (P, n_harm), candidate_pose5 (C, 5)."""
    box_diag = torch.linalg.norm(box_max - box_min)
    R, T = get_camera_RT(candidate_pose5[:, :3], candidate_pose5[:, 3:])
    C = candidate_pose5.shape[0]
    with span("sample"):
        # Each candidate's mask, (C, P): the per-point arithmetic of one
        # camera's, broadcast over the C cameras.
        in_fov = points_in_fov_mask(proxy_points[None], R[:, None],
                                    T[:, None], intr, fov_range=sensor_range)
        occ = occ_probs[:, 0]
        fov_volume = torch.where(in_fov, occ, torch.zeros_like(occ)).sum(1)
        if proxy_points.is_cuda:
            idx = kernels.gumbel_argmax(noise, candidate_logits(
                occ_probs, in_fov, min_occ, use_occ_to_sample))  # (C, n)
            count("kernel_draws", C)
        else:
            idx = torch.stack([sample_proxy_points(noise[c], occ_probs,
                                                   in_fov[c], min_occ,
                                                   use_occ_to_sample)
                               for c in range(C)])
        count("token_draws", C)
    with span("scone_vis"):
        tokens = proxy_points[idx]                              # (C, n, 3)
        center = (tokens.amax(dim=1) + tokens.amin(dim=1)) / 2.0
        pts4 = torch.cat([normalize_points_in_prediction_box(
            tokens, center[:, None], box_diag), occ_probs[idx]], dim=-1)
        h = scone_vis(pts4, view_harmonics=view_harmonics[idx])
        cam = normalize_points_in_prediction_box(
            candidate_pose5[:, None, :3], center[:, None], box_diag)
        # Candidate c's gain toward its own camera: coverage_gain of cloud
        # c with the one camera c.
        gain = coverage_gain(pts4[..., :3], h, cam)[:, 0]
    has_any = in_fov.sum(dim=1) > 0
    return torch.where(has_any, gain * fov_volume,
                       torch.full_like(gain, -1.0))
