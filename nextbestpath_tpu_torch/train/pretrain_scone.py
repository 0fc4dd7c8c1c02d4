"""SCONE pretraining on PyTorch: occupancy and visibility.

Port of ``nextbestpath_tpu/train/pretrain_scone.py`` (the reference's
pretrain_scone_occ.py and pretrain_scone_vis.py). A sample
(``PretrainSample``) is a partial point cloud, query points with their
occupancy and view harmonics, and candidate cameras with their coverage:

* ``make_pretrain_sample``: a procedural object (``assets/objects.py``,
  the ShapeNet stand-in) viewed from sphere cameras; depth frames from
  kernel K1 (``capture_depth``), occupancy by the parity test and the
  candidates' coverage by visibility rays, both kernel K2;
* ``make_interior_sample``: a procgen scene interior, a walklet of lattice
  moves checked by K2 (``segments_hit_mesh``), sight-carved occupancy (K2
  ``ray_hits``) and fov-restricted coverage (``visible_fov_fraction``).

``pretrain_scone_occ`` fits SconeOcc's occupancy (MSE) and
``pretrain_scone_vis`` SconeVis's coverage gains (a coverage-distribution
loss, default ``uncentered_l1``, which the online trainer also uses), each
with optax's Adam over all its parameters on batches drawn from the set
staged on the device once. On the card the steps and the view harmonics
run in full f32 (TF32 off).

Draws: numpy's ``default_rng(seed)`` serves a sample's host choices in the
JAX package's order, and a provider (``draws.py``) its pixel scores, one
``view`` draw a view (``step`` the view). A pretrainer's step takes one
``begin_group``: ``idx`` (``randint`` of the batch's sample indices), then
for SconeOcc its permutations (role ``occ``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..assets.objects import (FAMILIES, cameras_on_sphere, generate_object,
                              pose5_toward)
from ..device import DeviceLike, full_f32, resolve_device
from ..draws import TorchDraws
from ..eval.object_nbv import visible_mask_batched
from ..geometry.cameras import (CameraIntrinsics, get_camera_RT,
                                points_in_fov_mask)
from ..models.harmonics import base_view_harmonics
from ..models.macarons import Adam, adam_step_
from ..models.scone import SconeOcc, SconeVis, coverage_gain
from ..ops.raytrace import (points_inside_mesh, ray_hits, segments_hit_mesh,
                            tris_to_soa)
from ..ops.view_state import compute_view_harmonics, compute_view_state
from ..planning.grid_paths import DIRS, lattice_positions
from ..sim.sensor import backproject_sample, capture_depth


def kl_div_ce(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """KL(softmax(y) || softmax(x)), batchmean."""
    logp = torch.log_softmax(x, dim=1)
    q = torch.softmax(y, dim=1)
    return (q * (torch.log(torch.clamp(q, min=1e-12)) - logp)).sum() / x.shape[0]


def normalized_l1(x: torch.Tensor, y: torch.Tensor,
                  eps: float = 1e-7) -> torch.Tensor:
    """Std-normalised L1 between coverage distributions (population std)."""
    nx = (x - x.mean(dim=1, keepdim=True)) / (
        x.std(dim=1, keepdim=True, unbiased=False) + eps)
    ny = (y - y.mean(dim=1, keepdim=True)) / (
        y.std(dim=1, keepdim=True, unbiased=False) + eps)
    return torch.abs(nx - ny).mean()


def uncentered_l1(x: torch.Tensor, y: torch.Tensor,
                  eps: float = 1e-7) -> torch.Tensor:
    """Mean-normalised L1 (the default coverage loss)."""
    nx = x / (x.mean(dim=1, keepdim=True) + eps)
    ny = y / (y.mean(dim=1, keepdim=True) + eps)
    return torch.abs(nx - ny).mean()


COV_LOSSES = {"kl_divergence": kl_div_ce, "l1": normalized_l1,
              "uncentered_l1": uncentered_l1}


@dataclasses.dataclass
class PretrainSample:
    partial_pc: np.ndarray       # (N, 3) normalized
    query_x: np.ndarray          # (M, 3) normalized
    query_occ: np.ndarray        # (M, 1)
    view_harmonics: np.ndarray   # (M, n_harmonics)
    candidate_cams: np.ndarray   # (C, 3) normalized
    gt_coverage: np.ndarray      # (C,)


def _partial_cloud(soa: torch.Tensor, n_tris: int, poses5: List[np.ndarray],
                   intr: CameraIntrinsics, draws, n_partial: int,
                   sensor_range: float) -> np.ndarray:
    """Each pose's depth frame (K1) backprojected with gathering factor
    0.2 and its ``view`` scores; the valid points of all views, (P, 3)."""
    dev = soa.device
    parts = []
    n_px = intr.image_height * intr.image_width
    for v, p5 in enumerate(poses5):
        zbuf, R, T = capture_depth(soa, n_tris, torch.from_numpy(
            np.asarray(p5, np.float32)).to(dev), intr)
        batch = backproject_sample(zbuf, R, T, intr,
                                   draws.uniform("view", (n_px,), step=v),
                                   n_partial, gathering_factor=0.2,
                                   sensor_range=sensor_range)
        parts.append(batch.points[batch.valid].cpu().numpy())
    return np.concatenate(parts, axis=0) if parts else np.zeros((0, 3))


def _fixed_size(partial: np.ndarray, n_partial: int,
                rng: np.random.Generator) -> np.ndarray:
    """A random n_partial subset, or every point padded by random repeats."""
    if len(partial) >= n_partial:
        return partial[rng.permutation(len(partial))[:n_partial]]
    pad = rng.integers(0, max(len(partial), 1), n_partial - len(partial))
    return (np.concatenate([partial, partial[pad]]) if len(partial)
            else np.zeros((n_partial, 3), np.float32))


def _view_harmonics(queries: np.ndarray, cams: np.ndarray, n_elev: int,
                    n_azim: int, dev) -> np.ndarray:
    base_h, h_polar = base_view_harmonics(n_elev, n_azim, 8, device=dev)
    vs = compute_view_state(torch.from_numpy(queries).to(dev)[None],
                            torch.from_numpy(np.asarray(cams, np.float32)
                                             ).to(dev), n_elev, n_azim)
    with full_f32():
        vh = compute_view_harmonics(vs, base_h, h_polar, n_elev, n_azim)
    return vh[0].cpu().numpy()


def make_pretrain_sample(seed: int, n_partial: int = 1024, n_query: int = 512,
                         n_candidates: int = 16, n_views: int = 3,
                         n_elev: int = 7, n_azim: int = 14,
                         intr: Optional[CameraIntrinsics] = None,
                         draws=None, device: DeviceLike = "cuda"
                         ) -> PretrainSample:
    """One supervised sample from a procedural object of family ``seed %
    4``, seen from ``n_views`` sphere cameras at 0.7 of its diagonal: the
    fused partial cloud, ``n_query`` box queries with their parity
    occupancy (the objects are solids) and view harmonics, and the visible
    share of 512 GT surface points from each of ``n_candidates`` sphere
    cameras. ``draws``: the views' pixel scores (default a ``TorchDraws``
    seeded ``seed``)."""
    dev = resolve_device(device)
    draws = draws if draws is not None else TorchDraws(seed, dev)
    rng = np.random.default_rng(seed)
    assets = generate_object(seed, family=FAMILIES[seed % len(FAMILIES)])
    soa = tris_to_soa(torch.from_numpy(assets.tris).to(dev))
    n_tris = assets.n_tris
    intr = intr or CameraIntrinsics(image_height=64, image_width=114)

    lo, hi = assets.x_min, assets.x_max
    center = (lo + hi) / 2.0
    diag = float(np.linalg.norm(hi - lo))

    view_cams = cameras_on_sphere(n_views, 0.7 * diag, center, rng)
    partial = _partial_cloud(soa, n_tris,
                             [pose5_toward(c, center) for c in view_cams],
                             intr, draws, n_partial, 200.0)
    partial = _fixed_size(partial, n_partial, rng)

    queries = rng.uniform(lo, hi, size=(n_query, 3)).astype(np.float32)
    occ = points_inside_mesh(torch.from_numpy(queries).to(dev), soa, n_tris)
    occ = occ.cpu().numpy().astype(np.float32)[:, None]
    vh = _view_harmonics(queries, view_cams, n_elev, n_azim, dev)

    cands = cameras_on_sphere(n_candidates, 0.7 * diag, center, rng)
    gt_pts = assets.gt_surface[rng.permutation(len(assets.gt_surface))[:512]]
    gt_cov = visible_mask_batched(gt_pts, cands, soa, n_tris).mean(axis=1)

    def norm(q):
        return (q - center) / diag

    return PretrainSample(
        partial_pc=norm(partial).astype(np.float32),
        query_x=norm(queries).astype(np.float32),
        query_occ=occ,
        view_harmonics=vh.astype(np.float32),
        candidate_cams=norm(cands).astype(np.float32),
        gt_coverage=np.asarray(gt_cov, np.float32),
    )


_FIELDS = ("partial_pc", "query_x", "view_harmonics", "query_occ",
           "candidate_cams", "gt_coverage")


def _stack_samples(samples: List[PretrainSample], device
                   ) -> Tuple[torch.Tensor, ...]:
    """The whole set on the device once, a leading sample axis: (pc, x,
    view harmonics, occupancy, candidate cameras, coverage). A step
    gathers its batch there."""
    return tuple(torch.from_numpy(np.stack([getattr(s, f) for s in samples])
                                  ).to(device) for f in _FIELDS)


def _pretrain_setup(samples, seed, batch, device, draws):
    dev = resolve_device(device)
    samples = samples or [make_pretrain_sample(seed + i, device=dev)
                          for i in range(4)]
    batch = max(1, min(batch, len(samples)))
    draws = draws if draws is not None else TorchDraws(seed, dev)
    return dev, samples, batch, draws


def pretrain_scone_occ(n_steps: int = 100, lr: float = 1e-4, seed: int = 0,
                       samples: Optional[List[PretrainSample]] = None,
                       batch: int = 4, verbose: bool = True,
                       model: Optional[SconeOcc] = None, draws=None,
                       device: DeviceLike = "cuda"):
    """Supervised occupancy pretraining: each step draws ``batch`` samples
    uniformly from the staged set, predicts their queries' occupancy and
    takes an Adam step on the MSE. ``model``: the initial SconeOcc (default
    one seeded ``seed``, ``seq_len = min(2048, N)``), trained in place.
    Returns (model, losses)."""
    dev, samples, batch, draws = _pretrain_setup(samples, seed, batch,
                                                 device, draws)
    if model is None:
        torch.manual_seed(seed)
        model = SconeOcc(seq_len=min(2048, samples[0].partial_pc.shape[0]))
    model = model.to(dev)
    tx = Adam(lr)
    opt_state = tx.init(dict(model.named_parameters()))
    pc_a, x_a, vh_a, occ_a, _, _ = _stack_samples(samples, dev)
    losses = []
    for i in range(n_steps):
        draws.begin_group("step")
        idx = draws.randint("idx", 0, pc_a.shape[0], shape=(batch,))
        with full_f32():
            pred = model(pc_a[idx], x_a[idx], vh_a[idx], draws=draws,
                         role="occ")
            loss = torch.mean((pred - occ_a[idx]) ** 2)
            opt_state = adam_step_(model, loss, tx, opt_state)
        losses.append(float(loss.detach()))
        if verbose and i % 10 == 0:
            print(f"occ step {i}: mse {losses[-1]:.4f}", flush=True)
    return model, losses


def pretrain_scone_vis(n_steps: int = 100, lr: float = 1e-4, seed: int = 0,
                       cov_loss: str = "uncentered_l1",
                       samples: Optional[List[PretrainSample]] = None,
                       batch: int = 4, verbose: bool = True,
                       model: Optional[SconeVis] = None, draws=None,
                       device: DeviceLike = "cuda"):
    """Visibility-gain pretraining: SconeVis's harmonics at the queries
    (their occupancy as the fourth coordinate) give each candidate camera
    a coverage gain, fitted to the measured coverage with ``cov_loss``.
    Batched and staged as ``pretrain_scone_occ``. Returns (model,
    losses)."""
    dev, samples, batch, draws = _pretrain_setup(samples, seed, batch,
                                                 device, draws)
    if model is None:
        torch.manual_seed(seed)
        model = SconeVis()
    model = model.to(dev)
    loss_fn_cov = COV_LOSSES[cov_loss]
    tx = Adam(lr)
    opt_state = tx.init(dict(model.named_parameters()))
    _, x_a, vh_a, occ_a, cams_a, cov_a = _stack_samples(samples, dev)
    losses = []
    for i in range(n_steps):
        draws.begin_group("step")
        idx = draws.randint("idx", 0, x_a.shape[0], shape=(batch,))
        pts = torch.cat([x_a[idx], occ_a[idx]], dim=-1)
        with full_f32():
            h = model(pts, view_harmonics=vh_a[idx])
            pred = coverage_gain(pts[..., :3], h, cams_a[idx])
            loss = loss_fn_cov(pred[..., None], cov_a[idx][..., None])
            opt_state = adam_step_(model, loss, tx, opt_state)
        losses.append(float(loss.detach()))
        if verbose and i % 10 == 0:
            print(f"vis step {i}: {cov_loss} {losses[-1]:.4f}", flush=True)
    return model, losses


# Interior-domain samples: MACARONS deploys into enclosed scene interiors,
# so these samples come from procgen interiors with rollout-like capture: a
# short lattice walklet of interior cameras, sight-carved occupancy (free
# iff visible from some walklet camera, the fixpoint of the online carving
# supervision) and candidates at interior lattice positions with
# fov-restricted coverage. Normalisation is the deployment's: the
# walklet's centre and the scene box's diagonal.

_SCENE_CACHE: dict = {}
_INTERIOR_DIFFS = ("simple", "normal", "hard", "insane")


def _interior_scene(seed: int, device):
    """The packed procgen scene of ``seed`` and its SoA on ``device``
    (cached: packing renders and samples the GT surface, and several
    samples share a scene)."""
    key = (seed, str(device))
    if key not in _SCENE_CACHE:
        from ..assets import generate_scene, pack_generated_scene
        from ..config import default_params

        diff = _INTERIOR_DIFFS[seed % len(_INTERIOR_DIFFS)]
        p = default_params(n_gt_surface_points=4096)
        assets = pack_generated_scene(generate_scene(diff, seed=1000 + seed),
                                      params=p)
        soa = tris_to_soa(torch.from_numpy(assets.tris).to(device))
        _SCENE_CACHE[key] = (assets, soa)
    return _SCENE_CACHE[key]


def _walklet(positions: np.ndarray, start, n_moves: int, soa, n_tris,
             rng: np.random.Generator):
    """Cells of a walklet from ``start``: each move tries the lattice
    directions in a random order and takes the first in the grid whose
    segment does not cross the mesh (one K2 launch a try), else stays."""
    L, H = positions.shape[:2]
    dev = soa.device
    cur = (int(start[0]), int(start[1]))
    cells = [cur]
    for _ in range(n_moves):
        for d in rng.permutation(len(DIRS)):
            dl, dh = DIRS[d]
            nl, nh = cur[0] + dl, cur[1] + dh
            if not (0 <= nl < L and 0 <= nh < H):
                continue
            a = torch.from_numpy(positions[cur][None].astype(np.float32))
            b = torch.from_numpy(positions[nl, nh][None].astype(np.float32))
            if not bool(segments_hit_mesh(a.to(dev), b.to(dev), soa,
                                          n_tris)[0]):
                cur = (nl, nh)
                break
        cells.append(cur)
    return cells


def _unoccluded(origins_of: np.ndarray, targets: np.ndarray, soa, n_tris
                ) -> np.ndarray:
    """(C, N): the segment from each of C origins to each of N targets
    does not hit the mesh before t = 0.999 (one K2 launch)."""
    C, N = len(origins_of), len(targets)
    origins = np.repeat(origins_of, N, axis=0)
    dirs = np.tile(targets, (C, 1)) - origins
    dev = soa.device
    t, _ = ray_hits(torch.from_numpy(origins).to(dev),
                    torch.from_numpy(dirs).to(dev), soa, n_tris,
                    t_min=1e-4, t_max=0.999)
    return (t >= 0.999).reshape(C, N).cpu().numpy()


def make_interior_sample(seed: int, n_partial: int = 1024, n_query: int = 512,
                         n_candidates: int = 16, n_views: int = 4,
                         n_elev: int = 7, n_azim: int = 14,
                         scenes: int = 8,
                         intr: Optional[CameraIntrinsics] = None,
                         draws=None, device: DeviceLike = "cuda"
                         ) -> PretrainSample:
    """One supervised sample from the interior of procgen scene ``seed %
    scenes``: a walklet of ``n_views`` cameras from the start pose with
    random azimuths, their fused partial cloud, ``n_query`` queries in a
    box around the walklet with sight-carved occupancy and view harmonics,
    and ``n_candidates`` interior lattice cameras near the walklet with the
    share of 512 GT surface points each sees unoccluded and in its fov.
    ``draws``: the views' pixel scores (default a ``TorchDraws`` seeded
    ``seed``)."""
    dev = resolve_device(device)
    draws = draws if draws is not None else TorchDraws(seed, dev)
    rng = np.random.default_rng(seed)
    assets, soa = _interior_scene(seed % scenes, dev)
    n_tris = assets.n_tris
    intr = intr or CameraIntrinsics(image_height=64, image_width=114)
    positions = lattice_positions(torch.from_numpy(assets.pose_origin),
                                  assets.pose_l, assets.pose_h).numpy()
    elev2 = float(assets.elevations_deg[2])

    start = assets.start_cam_idx
    cells = _walklet(positions, (start[0], start[2]), n_views - 1, soa,
                     n_tris, rng)
    poses, cams = [], []
    for cell in cells:
        pos = positions[cell]
        azim = float(rng.integers(0, 8) * 45.0)
        poses.append(np.asarray([pos[0], pos[1], pos[2], elev2, azim],
                                np.float32))
        cams.append(pos.astype(np.float32))
    cams_np = np.stack(cams)
    partial = _partial_cloud(soa, n_tris, poses, intr, draws, n_partial, 70.0)
    partial = _fixed_size(partial, n_partial, rng)

    # Queries: a box around the walklet, clipped to the scene's box.
    verts = assets.tris[:n_tris].reshape(-1, 3)
    scene_lo, scene_hi = verts.min(axis=0), verts.max(axis=0)
    scene_diag = float(np.linalg.norm(scene_hi - scene_lo))
    wl_center = cams_np.mean(axis=0)
    half = 0.25 * (scene_hi - scene_lo)
    q_lo = np.maximum(wl_center - half, scene_lo)
    q_hi = np.minimum(wl_center + half, scene_hi)
    queries = rng.uniform(q_lo, q_hi, size=(n_query, 3)).astype(np.float32)

    # Sight carving: free iff visible from some walklet camera.
    seen = _unoccluded(cams_np, queries, soa, n_tris).any(axis=0)
    occ = (~seen).astype(np.float32)[:, None]
    vh = _view_harmonics(queries, cams_np, n_elev, n_azim, dev)

    # Candidates: interior lattice positions near the walklet.
    flat = positions.reshape(-1, 3)
    d2 = np.linalg.norm(flat - wl_center[None], axis=-1)
    near = np.nonzero(d2 <= 0.35 * scene_diag)[0]
    inside = points_inside_mesh(
        torch.from_numpy(flat[near].astype(np.float32)).to(dev), soa, n_tris)
    near = near[inside.cpu().numpy()]
    if len(near) == 0:
        near = np.asarray([int(np.argmin(d2))])
    pick = near[rng.integers(0, len(near), n_candidates)]
    cand_pos = flat[pick].astype(np.float32)
    cand_azim = rng.integers(0, 8, n_candidates) * 45.0

    gt_pts = assets.gt_surface[
        rng.permutation(len(assets.gt_surface))[:512]].astype(np.float32)
    gt_cov = visible_fov_fraction(gt_pts, cand_pos, cand_azim, elev2, soa,
                                  n_tris, intr)

    def norm(q):
        return (q - wl_center) / scene_diag

    return PretrainSample(
        partial_pc=norm(partial).astype(np.float32),
        query_x=norm(queries).astype(np.float32),
        query_occ=occ,
        view_harmonics=vh.astype(np.float32),
        candidate_cams=norm(cand_pos).astype(np.float32),
        gt_coverage=np.asarray(gt_cov, np.float32),
    )


def visible_fov_fraction(gt_pts: np.ndarray, cand_pos: np.ndarray,
                         cand_azim: np.ndarray, elev_deg: float,
                         soa: torch.Tensor, n_tris,
                         intr: CameraIntrinsics) -> List[float]:
    """Per candidate, the share of gt_pts unoccluded (one K2 launch for
    all) and inside its fov within 70 units."""
    unoccl = _unoccluded(cand_pos, gt_pts, soa, n_tris)
    dev = soa.device
    poses = torch.from_numpy(np.stack([
        np.asarray([p[0], p[1], p[2], elev_deg, float(a)], np.float32)
        for p, a in zip(cand_pos, cand_azim)])).to(dev)
    R, T = get_camera_RT(poses[:, :3], poses[:, 3:])
    pts = torch.from_numpy(gt_pts).to(dev)
    fracs = []
    for c in range(len(cand_pos)):
        fov = points_in_fov_mask(pts, R[c], T[c], intr,
                                 fov_range=70.0).cpu().numpy()
        fracs.append(float((unoccl[c] & fov).mean()))
    return fracs
