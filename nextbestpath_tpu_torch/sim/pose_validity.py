"""Camera-pose validity queries over the pose lattice.

Port of ``nextbestpath_tpu/sim/pose_validity.py`` (the reference's Camera
predicates, macarons_utils.py): ``is_fov_empty`` (no mesh point in the
pose's frustum within 5 zfar), ``check_if_pose_is_occupied`` (whose return
the reference hard-wires to False), ``check_if_pose_is_valid``,
``get_random_valid_pose`` and ``sample_valid_poses_in_a_certain_range``.

The validity of every lattice pose is one batched computation
(``lattice_validity_mask``: ``points_in_fov_mask`` vectorised over the
cameras, ``batch_size`` cameras a chunk as the JAX package's ``lax.map``),
after which a random valid pose is one Gumbel argmax over the mask. Draws
come from a provider (``draws.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..geometry.cameras import (CameraIntrinsics, get_camera_RT,
                                points_in_fov_mask)


def fov_nonempty_mask(points: torch.Tensor, points_valid: torch.Tensor,
                      X_cams: torch.Tensor, V_cams: torch.Tensor,
                      intr: CameraIntrinsics, fov_range: float,
                      batch_size: int = 64) -> torch.Tensor:
    """(M,) bool: camera m (centre X_cams[m], (elev, azim) V_cams[m]) sees
    at least one valid point; ``batch_size`` cameras a chunk bound the
    (cameras x points) working set."""
    def in_fov(R, T):
        return points_in_fov_mask(points, R, T, intr, fov_range)

    out = []
    for s in range(0, X_cams.shape[0], batch_size):
        R, T = get_camera_RT(X_cams[s:s + batch_size],
                             V_cams[s:s + batch_size])
        out.append((torch.vmap(in_fov)(R, T) & points_valid).any(dim=-1))
    return torch.cat(out)


def check_if_pose_is_occupied(*_args, reference_behavior: bool = True,
                              occupied: Optional[torch.Tensor] = None,
                              idx: Optional[Tuple[int, int]] = None):
    """The reference computes an occupancy and returns the constant False
    (macarons_utils.py:2713), so every pose is free; with
    ``reference_behavior=False`` and an (L, H) ``occupied`` mask, the
    honest lookup."""
    if reference_behavior or occupied is None or idx is None:
        return torch.tensor(False)
    return occupied[idx[0], idx[1]]


def lattice_validity_mask(positions: torch.Tensor, azims: torch.Tensor,
                          elev_deg: float, mesh_points: torch.Tensor,
                          mesh_valid: torch.Tensor, intr: CameraIntrinsics,
                          zfar: float,
                          proxy_points: Optional[torch.Tensor] = None,
                          proxy_valid: Optional[torch.Tensor] = None,
                          batch_size: int = 64) -> torch.Tensor:
    """(L, H, A) bool: pose (l, h, a) sees a mesh point within 5 zfar
    (never occupied, as the reference), and with ``proxy_points`` also a
    proxy point (get_random_valid_pose's extra test)."""
    L, H = positions.shape[0], positions.shape[1]
    A = azims.shape[0]
    X = positions.reshape(-1, 3).repeat_interleave(A, dim=0)
    az = azims.repeat(L * H)
    V = torch.stack([torch.full_like(az, elev_deg), az], dim=-1)
    ok = fov_nonempty_mask(mesh_points, mesh_valid, X, V, intr, 5.0 * zfar,
                           batch_size=batch_size)
    if proxy_points is not None:
        pv = (proxy_valid if proxy_valid is not None else torch.ones(
            proxy_points.shape[0], dtype=torch.bool,
            device=proxy_points.device))
        ok = ok & fov_nonempty_mask(proxy_points, pv, X, V, intr, 5.0 * zfar,
                                    batch_size=batch_size)
    return ok.reshape(L, H, A)


def random_valid_pose(draws, valid_mask: torch.Tensor,
                      role: str = "pose") -> torch.Tensor:
    """(3,) int32 (l, h, a), uniform over the valid poses: the argmax of
    the mask's logits plus Gumbel noise (``categorical``). With no valid
    pose (where the reference would loop forever) it is uniform over the
    lattice; the caller checks ``valid_mask.any()``."""
    L, H, A = valid_mask.shape
    flat = valid_mask.reshape(-1)
    any_valid = flat.any()
    logits = torch.where(flat | ~any_valid, 0.0, float("-inf"))
    i = torch.argmax(logits + draws.gumbel(role, (flat.shape[0],)))
    return torch.stack([i // (H * A), (i // A) % H, i % A]).to(torch.int32)


def sample_valid_poses_in_range(draws, valid_mask: torch.Tensor,
                                cur_lh: torch.Tensor, range_value: int,
                                keep_frac: float = 0.2,
                                role: str = "range") -> torch.Tensor:
    """(L, H, A) bool: the valid poses within the L1 ball of
    ``range_value`` lattice steps around ``cur_lh``, the current position
    excluded, each kept where its uniform draw is below ``keep_frac`` (the
    reference's draw of a fifth of the candidates, order-independent)."""
    L, H, A = valid_mask.shape
    dev = valid_mask.device
    ll = torch.arange(L, device=dev)[:, None]
    hh = torch.arange(H, device=dev)[None, :]
    l1 = torch.abs(ll - cur_lh[0]) + torch.abs(hh - cur_lh[1])
    in_range = (l1 <= range_value) & (l1 > 0)
    keep = draws.uniform(role, (L, H, A)) < keep_frac
    return valid_mask & in_range[:, :, None] & keep
