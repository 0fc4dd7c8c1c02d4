"""Object-level next-best-view evaluation (the ShapeNet tester analog).

Port of ``nextbestpath_tpu/eval/object_nbv.py``: from one view of an
object, greedily take the candidate camera on a sphere with the largest
predicted coverage gain (SconeVis) and track the true surface coverage
after each view. Ground-truth visibility comes from kernel K2: a surface
point is seen when the segment from the camera to it hits the mesh
nowhere before it. Every choice draws from ``np.random.default_rng(seed)``
as the JAX function does, so the two pick the same views.
"""

from __future__ import annotations

from typing import List, Tuple, Union

import numpy as np
import torch

from ..assets.objects import cameras_on_sphere
from ..device import DeviceLike, resolve_device
from ..models.harmonics import base_view_harmonics
from ..models.scone import SconeVis, coverage_gain
from ..ops.raytrace import ray_hits, tris_to_soa
from ..ops.view_state import compute_view_harmonics, compute_view_state


def visible_mask_batched(surface: np.ndarray, cams: np.ndarray,
                         tri_soa: torch.Tensor, n_tris) -> np.ndarray:
    """(C, N) visibility of the surface points from each camera: the
    segment camera -> point must not hit the mesh strictly before the
    point. One K2 launch for C * N rays on the card."""
    C, N = len(cams), len(surface)
    origins = np.repeat(np.asarray(cams, np.float32), N, axis=0)
    dirs = np.tile(surface, (C, 1)) - origins
    dev = tri_soa.device
    t, _ = ray_hits(torch.from_numpy(origins).to(dev),
                    torch.from_numpy(dirs).to(dev), tri_soa, n_tris,
                    t_min=1e-4, t_max=0.999)
    return (t >= 0.999).reshape(C, N).cpu().numpy()


def visible_mask(surface: np.ndarray, cam: np.ndarray, tri_soa: torch.Tensor,
                 n_tris) -> np.ndarray:
    """Surface points visible (unoccluded) from cam."""
    return visible_mask_batched(surface, np.asarray(cam)[None], tri_soa,
                                n_tris)[0]


def _bounds(assets):
    """The box of SceneAssets (settings) or ObjectAssets (x_min/x_max)."""
    settings = getattr(assets, "settings", None)
    if settings is not None:
        return settings.scene.x_min, settings.scene.x_max
    return assets.x_min, assets.x_max


@torch.inference_mode()
def object_nbv_rollout(assets, scone_vis: SconeVis, n_views: int = 10,
                       n_candidates: int = 32, n_tokens: int = 512,
                       seed: int = 0, n_elev: int = 7, n_azim: int = 14,
                       verbose: bool = False, device: DeviceLike = "cuda",
                       return_views: bool = False
                       ) -> Union[List[float], Tuple[List[float], List[int]]]:
    """Greedy NBV over sphere candidates; returns the coverage curve (and,
    with ``return_views``, the chosen candidates' indices in order)."""
    dev = resolve_device(device)
    scone_vis = scone_vis.to(dev).eval()
    rng = np.random.default_rng(seed)
    tri_soa = tris_to_soa(torch.from_numpy(np.asarray(assets.tris)).to(dev))
    n_tris = assets.n_tris
    surface = assets.gt_surface[
        rng.permutation(len(assets.gt_surface))[:2048]]
    lo, hi = _bounds(assets)
    center = (lo + hi) / 2.0
    diag = float(np.linalg.norm(hi - lo))

    def norm(q):
        return (q - center) / diag

    def to_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    cands = cameras_on_sphere(n_candidates, 0.7 * diag, center, rng)
    base_h, h_polar = base_view_harmonics(n_elev, n_azim, 8, device=dev)

    chosen = [int(rng.integers(n_candidates))]
    covered = visible_mask(surface, cands[chosen[0]], tri_soa, n_tris)
    curve = [float(covered.mean())]

    for step in range(n_views - 1):
        if len(chosen) >= n_candidates:
            # Every candidate taken: the curve is saturated.
            curve.append(curve[-1])
            continue
        # Tokens: observed surface points (the covered set), occupancy 1.
        obs = surface[covered] if covered.any() else surface[:1]
        idx = rng.integers(0, len(obs), n_tokens)
        tokens = obs[idx]
        vs = compute_view_state(to_dev(tokens)[None], to_dev(cands[chosen]),
                                n_elev, n_azim)
        vh = compute_view_harmonics(vs, base_h, h_polar, n_elev, n_azim)
        pts4 = torch.cat([to_dev(norm(tokens)),
                          torch.ones((n_tokens, 1), device=dev)], dim=-1)[None]
        h = scone_vis(pts4, view_harmonics=vh)
        remaining = [c for c in range(n_candidates) if c not in chosen]
        gains = coverage_gain(pts4[..., :3], h,
                              to_dev(norm(cands[remaining]))[None])[0]
        best = remaining[int(torch.argmax(gains))]
        chosen.append(best)
        covered = covered | visible_mask(surface, cands[best], tri_soa,
                                         n_tris)
        curve.append(float(covered.mean()))
        if verbose:
            print(f"view {step + 2}: coverage {curve[-1]:.4f}")
    return (curve, chosen) if return_views else curve
