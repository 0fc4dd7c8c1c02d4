"""Proxy-point occupancy field (the MACARONS volumetric state).

Port of ``nextbestpath_tpu/sim/proxy.py``:

* uniform proxy samples in the scene's box with a predicted probability
  and a pseudo-GT occupancy by space carving (the share of frames that saw
  the point behind the depth surface, at least ``score_threshold``);
* each point's view-state direction grid;
* out-of-field flags;
* the camera collision test against occupied proxies near the
  interpolated move (``camera_collides``).

``ProxyField`` is a small class of tensors; ``carve_with_frame`` returns a
new one, as the JAX function does.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..geometry.cameras import CameraIntrinsics, points_in_fov_mask
from ..ops.depth_sample import signed_distance_to_depth
from ..ops.view_state import compute_view_state


@dataclasses.dataclass
class ProxyField:
    points: torch.Tensor           # (P, 3)
    proba: torch.Tensor            # (P, 1) predicted occupancy
    supervision_occ: torch.Tensor  # (P, 1) carving pseudo-GT
    view_states: torch.Tensor      # (P, n_elev*n_azim)
    n_inside_fov: torch.Tensor     # (P, 1)
    n_behind_depth: torch.Tensor   # (P, 1)
    out_of_field: torch.Tensor     # (P, 1)
    distance_between_points: torch.Tensor  # 0-d

    @staticmethod
    def create(u: torch.Tensor, x_min: torch.Tensor, x_max: torch.Tensor,
               n_elev: int = 7, n_azim: int = 14,
               default_proba: float = 0.5) -> "ProxyField":
        """A field of u.shape[0] points at x_min + (x_max - x_min) * u, u
        (P, 3) uniform draws."""
        n_points = u.shape[0]
        dev = u.device

        def full(cols, value):
            return torch.full((n_points, cols), value, dtype=torch.float32,
                              device=dev)

        pts = x_min + (x_max - x_min) * u
        volume = torch.prod(x_max - x_min)
        radius = torch.pow(3.0 * (volume / n_points) / (4.0 * math.pi),
                           1.0 / 3.0)
        return ProxyField(
            points=pts, proba=full(1, default_proba),
            supervision_occ=full(1, 1.0),
            view_states=full(n_elev * n_azim, 0.0),
            n_inside_fov=full(1, 0.0), n_behind_depth=full(1, 0.0),
            out_of_field=full(1, 1.0),
            distance_between_points=2.0 * radius)


def carve_with_frame(field: ProxyField, zbuf: torch.Tensor, R: torch.Tensor,
                     T: torch.Tensor, X_cam: torch.Tensor,
                     intr: CameraIntrinsics, score_threshold: float = 0.95,
                     carving_tolerance: float = 10.0,
                     n_elev: int = 7, n_azim: int = 14,
                     sensor_range: float = 70.0) -> ProxyField:
    """One frame's carving, view-state and out-of-field update: the points
    in the range-limited frustum count the frame, and those behind the
    depth (within the tolerance) count as behind; a point near the surface
    adds the camera's direction to its view state."""
    fov_mask = points_in_fov_mask(field.points, R, T, intr,
                                  fov_range=sensor_range)
    sgn = signed_distance_to_depth(field.points, zbuf, R, T, intr)

    m = fov_mask[:, None]
    mf = m.to(torch.float32)
    n_inside = field.n_inside_fov + mf
    behind = (sgn[:, None] >= -carving_tolerance).to(torch.float32)
    n_behind = field.n_behind_depth + behind * mf
    sup = torch.where(
        m, ((n_behind / torch.clamp(n_inside, min=1.0)) >= score_threshold)
        .to(torch.float32), field.supervision_occ)

    near_surface = sgn < 3.0 * field.distance_between_points
    update = fov_mask & near_surface
    vs_new = compute_view_state(field.points[None], X_cam.reshape(-1, 3),
                                n_elev, n_azim)[0]
    view_states = torch.where(
        update[:, None], torch.clamp(field.view_states + vs_new, max=1.0),
        field.view_states)
    oof = torch.where(m, torch.zeros_like(field.out_of_field),
                      field.out_of_field)
    return dataclasses.replace(
        field, supervision_occ=sup, view_states=view_states,
        n_inside_fov=n_inside, n_behind_depth=n_behind, out_of_field=oof)


def camera_collides(field: ProxyField, x_from: torch.Tensor,
                    x_to: torch.Tensor, x_min: torch.Tensor,
                    x_max: torch.Tensor, oof_collides: bool = False,
                    collision_n_threshold: int = 6,
                    n_interpolation_steps: int = 4) -> torch.Tensor:
    """True (0-d bool) if moving from x_from to x_to passes near more than
    collision_n_threshold occupied proxies."""
    in_bbox = torch.all((x_to >= x_min) & (x_to <= x_max))
    t = torch.linspace(0.0, 1.0, n_interpolation_steps,
                       device=x_from.device)[:, None]
    ray = x_from[None, :] + t * (x_to - x_from)[None, :]
    d2 = ((field.points[:, None, :] - ray[None, :, :]) ** 2).sum(dim=-1)
    dist = torch.sqrt(d2.amin(dim=-1))
    dist_mask = dist < field.distance_between_points
    carved = field.supervision_occ[:, 0] > 0.0
    oof = field.out_of_field[:, 0] > 0.0
    if oof_collides:
        hit = (carved | oof) & dist_mask
    else:
        hit = (carved & ~oof) & dist_mask
    return in_bbox & (hit.sum() > collision_n_threshold)
