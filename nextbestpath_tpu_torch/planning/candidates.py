"""Vectorised candidate-goal scoring (port of
``nextbestpath_tpu/planning/candidates.py``): test-time scoring, and the
training collection's scoring with its Boltzmann-sampled first
candidate."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..ops.scatter2d import ego2d, img_coords

NEG = -1e30


def _project_lattice(positions: torch.Tensor, cam_xyz: torch.Tensor,
                     grid_size: int, grid_range: Tuple[float, float]):
    L, H = positions.shape[:2]
    p2 = ego2d(positions.reshape(-1, 3), cam_xyz)
    pix = img_coords(p2, grid_size, grid_range).reshape(L, H, 2)
    in_img = ((pix[..., 0] >= 0) & (pix[..., 0] < grid_size)
              & (pix[..., 1] >= 0) & (pix[..., 1] < grid_size))
    return pix.clamp(0, grid_size - 1).long(), in_img


def region_has_observation(proj256: torch.Tensor, size: int = 10
                           ) -> torch.Tensor:
    """(S, S) bool: some pixel == 1 within the (2*size+1)^2 box."""
    ones = (proj256 == 1.0).to(torch.float32)[None, None]
    k = 2 * size + 1
    window = F.max_pool2d(ones, k, stride=1, padding=size)
    return window[0, 0] > 0.0


def score_candidates_test(positions: torch.Tensor, cam_xyz: torch.Tensor,
                          value_map: torch.Tensor, proj256: torch.Tensor,
                          banned_positions: torch.Tensor,
                          value_map_size: int = 64, layout_size: int = 256,
                          grid_range: Tuple[float, float] = (-40.0, 40.0)
                          ) -> torch.Tensor:
    """(L, H) scores: best orientation's value - 10 * pc-density penalty;
    NEG where the candidate falls outside either map, sees no observation
    within 10 pixels, or is banned. value_map is (S, S, 8) NHWC."""
    pix64, in64 = _project_lattice(positions, cam_xyz, value_map_size,
                                   grid_range)
    pix256, in256 = _project_lattice(positions, cam_xyz, layout_size,
                                     grid_range)
    max_gain = value_map.amax(dim=-1)
    value = max_gain[pix64[..., 0], pix64[..., 1]]
    sel = proj256[pix256[..., 0], pix256[..., 1]]
    near_obs = region_has_observation(proj256)[pix256[..., 0],
                                               pix256[..., 1]]
    ok = in64 & in256 & near_obs & ~banned_positions
    return torch.where(ok, value - 10.0 * sel, torch.full_like(value, NEG))


def score_candidates_train(positions: torch.Tensor, cam_xyz: torch.Tensor,
                           value_map: torch.Tensor, current_lh,
                           value_map_size: int = 64,
                           grid_range: Tuple[float, float] = (-40.0, 40.0)
                           ) -> torch.Tensor:
    """(L, H) training-collection scores: the best orientation's value for
    every position inside the value map except the current one (index
    ``current_lh`` (l, h): host ints, or a device tensor, which is compared
    and never read on the host); NEG elsewhere."""
    L, H = positions.shape[:2]
    pix64, in64 = _project_lattice(positions, cam_xyz, value_map_size,
                                   grid_range)
    value = value_map.amax(dim=-1)[pix64[..., 0], pix64[..., 1]]
    cell = torch.arange(L * H, device=positions.device).view(L, H)
    is_current = cell == current_lh[0] * H + current_lh[1]
    return torch.where(in64 & ~is_current, value,
                       torch.full_like(value, NEG))


def boltzmann_first(scores: torch.Tensor, gumbel: torch.Tensor,
                    beta: float = 0.5) -> torch.Tensor:
    """Flat index of the Boltzmann-sampled first candidate: a draw from
    softmax(score / beta) over the admissible scores, taken as
    ``jax.random.categorical`` takes it, argmax(gumbel + logits) with the
    Gumbel noise ``gumbel`` (L*H,) given (ties to the lower index)."""
    flat = scores.reshape(-1)
    logits = torch.where(flat > NEG / 2, flat / beta,
                         torch.full_like(flat, -float("inf")))
    return torch.argmax(gumbel.to(logits.device) + logits)
