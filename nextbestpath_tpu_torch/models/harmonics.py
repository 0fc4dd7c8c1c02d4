"""Real (tesseral) spherical harmonics up to rank 8 (64 coefficients).

Port of ``nextbestpath_tpu/models/harmonics.py``: associated Legendre
functions with the Condon-Shortley phase by the (l, m) recursion, and the
normalisation sqrt((2l+1)/4pi) * sqrt(2/pochhammer(l-|m|+1, 2|m|)) for
m != 0. Degrees and orders are Python ints, so the recursion unrolls.

theta is the POLAR angle (callers convert elevation by
theta = -elev + pi/2).
"""

from __future__ import annotations

import math
from functools import reduce
from operator import mul
from typing import Dict, Tuple

import torch


def _semifactorial(x: int) -> float:
    return float(reduce(mul, range(x, 1, -2), 1.0))


def _pochhammer(x: int, k: int) -> float:
    return float(reduce(mul, range(x + 1, x + k), float(x)))


def _lpmv(l: int, m: int, x: torch.Tensor,
          cache: Dict[Tuple[int, int], torch.Tensor]) -> torch.Tensor:
    """Associated Legendre P_l^m(x) with Condon-Shortley phase, m >= 0."""
    key = (l, m)
    if key in cache:
        return cache[key]
    if l == 0:
        y = torch.ones_like(x)
    elif m == l:
        y = ((-1) ** m) * _semifactorial(2 * m - 1) * torch.pow(
            torch.clamp(1.0 - x * x, min=0.0), m / 2.0)
    else:
        y = ((2 * l - 1) / (l - m)) * x * _lpmv(l - 1, m, x, cache)
        if l - m > 1:
            y = y - ((l + m - 1) / (l - m)) * _lpmv(l - 2, m, x, cache)
    cache[key] = y
    return y


def spherical_harmonics(l: int, theta: torch.Tensor, phi: torch.Tensor
                        ) -> torch.Tensor:
    """All 2l+1 components Y_{l,m}, m = -l..l, stacked on the last axis."""
    cos_t = torch.cos(theta)
    cache: Dict[Tuple[int, int], torch.Tensor] = {}
    outs = []
    for m in range(-l, l + 1):
        m_abs = abs(m)
        N = math.sqrt((2 * l + 1) / (4 * math.pi))
        leg = _lpmv(l, m_abs, cos_t, cache)
        if m == 0:
            outs.append(N * leg)
        else:
            trig = torch.cos(m * phi) if m > 0 else torch.sin(m_abs * phi)
            N = N * math.sqrt(2.0 / _pochhammer(l - m_abs + 1, 2 * m_abs))
            outs.append(N * leg * trig)
    return torch.stack(outs, dim=-1)


def harmonics_up_to_rank(max_rank: int, theta: torch.Tensor,
                         phi: torch.Tensor) -> torch.Tensor:
    """Concatenated Y_{l,m} for l < max_rank: (..., max_rank^2)."""
    return torch.cat([spherical_harmonics(l, theta, phi)
                      for l in range(max_rank)], dim=-1)


def base_view_harmonics(n_elev: int = 7, n_azim: int = 14, max_rank: int = 8,
                        device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n_harmonics, n_elev*n_azim) harmonics of the discretised view
    directions, and their polar angles (n_elev*n_azim,)."""
    elev_step = math.pi / (n_elev + 1)
    azim_step = 2 * math.pi / n_azim
    elev = torch.tensor([-math.pi / 2 + (i + 1) * elev_step
                         for i in range(n_elev) for _ in range(n_azim)],
                        dtype=torch.float32, device=device)
    azim = torch.tensor([j * azim_step - math.pi
                         for _ in range(n_elev) for j in range(n_azim)],
                        dtype=torch.float32, device=device)
    polar = -elev + math.pi / 2.0
    h = harmonics_up_to_rank(max_rank, polar, azim)
    return h.T, polar
