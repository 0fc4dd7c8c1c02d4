"""MACARONS online self-supervised training loop on PyTorch.

Port of ``nextbestpath_tpu/train/train_macarons.py`` (the reference's
macarons/trainers/train_macarons.py ``loop``). A pose:

1. the coverage metric of the point cloud (kernel K3);
2. the current frame, depth only or RGB-D (``capture_rgbd``: colour shaded
   from the same K1 launch's triangle index); with ``learn_depth`` the
   online ManyDepth step one pose behind capture (target the previous
   frame, alphas -1, -2 and +1; jitter and flip; photometric + regularity
   loss; Adam), under the staged-unfreeze guard when
   ``depth_reject_factor > 0``; with predicted depth (``use_perfect_depth
   =False``) the depth used is ManyDepth's, masked by the error mask;
3. with a ``Memory``: the frame and depth saved, then per replay loop a
   SCONE replay step on a scene rebuilt from another trajectory (the
   measured gains of its held-out cameras against the covered state its
   base frames rebuild, in trajectory order) and a depth replay step;
4. the frame's points fill the surface store, and the frame carves the
   proxy field;
5. the curriculum-weighted proxy tokens (``categorical`` as Gumbel-max)
   and point-cloud tokens, the frustum masks of the 20 neighbouring poses
   and SconeVis's gains: the greedy next pose;
6. the move (K1, its four frames in one launch), the arrival frame, its
   measured coverage gain against the surface store, and the SCONE step
   (occupancy MSE against the carving pseudo-GT and the uncentered L1 of
   the predicted gains against the measured one);
7. with predicted depth, every ``remap_every_n_poses``: the frame history
   re-inferred with the current depth weights and the point cloud,
   surface store and proxy carving rebuilt (and the memory's depths).

The models are applied functionally on variable dicts
(``models/macarons.py``); BatchNorm uses its running statistics
throughout, as the JAX trainer applies ManyDepth with ``train=False``.
Draws come in the sequential schedule of ``draws.py`` (a ``begin_group``
a JAX ``next_key()``); the default provider is a ``torch.Generator`` on
the device. Each stage runs in a span of ``utils/timing.py``
(``MACARONS_STAGES``). On the card every convolution and matmul of the
path runs in full f32 (``full_f32``).
"""

from __future__ import annotations

import dataclasses
import random as _pyrandom
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ..assets.scene_assets import SceneAssets
from ..config import Params, default_params
from ..device import DeviceLike, full_f32, resolve_device
from ..draws import TorchDraws
from ..eval.macarons_nbv import C_MAX, neighbour_candidates
from ..geometry.cameras import (CameraIntrinsics, camera_center,
                                get_camera_RT, points_in_fov_mask)
from ..models.harmonics import base_view_harmonics
from ..models.macarons import Adam, Macarons, apply_updates
from ..models.manydepth import disparity_to_depth
from ..models.scone import coverage_gain
from ..ops.coverage import coverage_percentage_exact
from ..ops.raytrace import tris_to_soa
from ..ops.view_state import compute_view_harmonics
from ..sim.curriculum import curriculum_sampling_distances
from ..sim.proxy import ProxyField, carve_with_frame
from ..sim.rollout import TrajectoryBuffer, move_and_capture
from ..sim.sensor import (PointBuffer, backproject_sample, capture_depth,
                          capture_rgbd)
from ..sim.surface_store import SurfaceStore, camera_coverage_gain
from ..sim.tables import build_scene_tables
from ..utils.timing import span
from .depth_losses import (color_jitter, error_mask_from_disparity,
                           horizontal_flip, photometric_loss,
                           regularity_loss)
from .pretrain_scone import uncentered_l1

MACARONS_STAGES = ("coverage", "render", "depth_step", "depth_infer",
                   "replay", "fill", "carve", "tokens", "nbv", "move", "gain",
                   "scone_step", "remap")
STORE_CAPACITY = 262144
REPLAY_STORE_CAPACITY = 65536
# The jitter's draws (apply, brightness, contrast, saturation, hue) from
# the split of the depth step key's first half, the flip's its second.
AUG_SHAPES = [[(), (), (), (), ()], ()]

# The small configuration of the card-against-CPU checks and the CLI's
# --tiny (the JAX package's own online-trainer tests): 32x56 frames.
TINY = dict(image_height=32, image_width=56, points_per_frame=256,
            full_pc_capacity=32768, n_gt_surface_points=1024,
            max_path_len=32, n_proxy_points=512)


@dataclasses.dataclass
class MacaronsTrainState:
    model: Macarons
    occ_opt_state: Any
    vis_opt_state: Any
    depth_opt_state: Any
    occ_tx: Adam
    vis_tx: Adam
    depth_tx: Adam

    @staticmethod
    def create(seed: int = 0, params: Optional[Params] = None,
               depth_lr: float = 1e-4, scone_lr: float = 1e-4,
               depth_clip: float = 0.0, model: Optional[Macarons] = None,
               device: DeviceLike = "cuda") -> "MacaronsTrainState":
        """A separate Adam for each module; ``depth_clip > 0`` clips the
        depth gradients' global norm first (the staged-unfreeze recipe).
        ``model``: the bundle to train (default ``Macarons.create(seed)``
        at the params' frame size), moved to the device."""
        dev = resolve_device(device)
        p = params or default_params()
        if model is None:
            model = Macarons.create(seed, image_height=int(p.image_height),
                                    image_width=int(p.image_width),
                                    device=dev)
        else:
            model = Macarons._of(model.depth, model.scone_occ,
                                 model.scone_vis, dev)
        occ_tx, vis_tx = Adam(scone_lr), Adam(scone_lr)
        depth_tx = Adam(depth_lr, clip=depth_clip)
        return MacaronsTrainState(
            model=model,
            occ_opt_state=occ_tx.init(model.occ_vars),
            vis_opt_state=vis_tx.init(model.vis_vars),
            depth_opt_state=depth_tx.init(model.depth_vars),
            occ_tx=occ_tx, vis_tx=vis_tx, depth_tx=depth_tx)


def _grads(loss: torch.Tensor, leaves: List[Dict[str, torch.Tensor]]):
    """d loss / d leaves, dict by dict; zeros for a leaf the loss does not
    reach (ManyDepth's coarser disparity heads), as JAX's."""
    flat = [(i, k, v) for i, d in enumerate(leaves) for k, v in d.items()]
    gs = torch.autograd.grad(loss, [v for _, _, v in flat],
                             allow_unused=True, materialize_grads=True)
    out: List[Dict[str, torch.Tensor]] = [{} for _ in leaves]
    for (i, k, _), g in zip(flat, gs):
        out[i][k] = g
    return out


def _leaves(variables):
    """Fresh autograd leaves of every variable (the JAX trainer takes the
    gradient of the whole tree, ManyDepth's BatchNorm statistics too)."""
    return {k: v.detach().requires_grad_(True) for k, v in variables.items()}


def make_depth_steps(model: Macarons, depth_tx: Adam, intr: CameraIntrinsics,
                     p: Params):
    """The online depth training and inference steps.

    ``depth_step(depth_vars, depth_opt, tgt, R, T, x_alpha, R_alpha,
    T_alpha, aug, n_cv=2) -> (new_vars, new_opt, photo, reg)``: the target
    and the supervision frames x_alpha (the first n_cv, the past frames,
    feed the cost volume; all are warp targets of the min-over-alpha
    photometric loss) get one jitter and, where the draw says so, the
    horizontal flip with the camera conjugate; then ManyDepth, the
    photometric + regularity loss at the pre-update weights, its gradient
    and an Adam update. ``aug``: the raw uniforms of ``AUG_SHAPES``.

    ``depth_infer(depth_vars, tgt, R, T, x_alpha, R_alpha, T_alpha)``: the
    predicted depth with the error mask, -1 where masked."""
    reg_factor = float(p.get("regularity_loss_factor", 0.1))
    jitter_p = float(p.get("jitter_probability", 1.0))
    sym_p = float(p.get("symmetry_probability", 0.5))
    jit = dict(brightness=float(p.get("brightness_jitter_range", 0.2)),
               contrast=float(p.get("contrast_jitter_range", 0.2)),
               saturation=float(p.get("saturation_jitter_range", 0.2)),
               hue=float(p.get("hue_jitter_range", 0.1)),
               probability=jitter_p)

    def depth_step(depth_vars, depth_opt, tgt, R, T, x_alpha, R_alpha,
                   T_alpha, aug, n_cv: int = 2):
        u_jitter, u_flip = aug
        with full_f32():
            all_imgs = color_jitter(u_jitter,
                                    torch.cat([tgt[None], x_alpha]), **jit)
            Rs = torch.cat([R[None], R_alpha])
            Ts = torch.cat([T[None], T_alpha])
            f_imgs, f_R, f_T = horizontal_flip(all_imgs, Rs, Ts)
            do_flip = u_flip < sym_p
            imgs = torch.where(do_flip, f_imgs, all_imgs)
            Rs = torch.where(do_flip, f_R, Rs)
            Ts = torch.where(do_flip, f_T, Ts)
            tgt2, xa2 = imgs[0], imgs[1:]
            R2, Ra2, T2, Ta2 = Rs[0], Rs[1:], Ts[0], Ts[1:]
            leaves = _leaves(depth_vars)
            disp1 = functional_call(
                model.depth, leaves,
                (tgt2[None], R2[None], T2[None], xa2[None, :n_cv],
                 Ra2[None, :n_cv], Ta2[None, :n_cv]))[0]
            depth = disparity_to_depth(disp1[0, ..., 0])
            photo = photometric_loss(tgt2, depth, R2, T2, xa2, Ra2, Ta2, intr)
            reg = regularity_loss(disp1[0, ..., 0], tgt2)
            (grads,) = _grads(photo + reg_factor * reg, [leaves])
            updates, new_opt = depth_tx.update(grads, depth_opt)
        return (apply_updates(depth_vars, updates), new_opt, photo.detach(),
                reg.detach())

    @torch.no_grad()
    def depth_infer(depth_vars, tgt, R, T, x_alpha, R_alpha, T_alpha):
        with full_f32():
            disp1 = functional_call(
                model.depth, depth_vars,
                (tgt[None], R[None], T[None], x_alpha[None], R_alpha[None],
                 T_alpha[None]))[0]
            d = disp1[0, ..., 0]
            depth = disparity_to_depth(d)
            ok = error_mask_from_disparity(d, tgt, torch.ones_like(d,
                                                                   dtype=bool))
        return torch.where(ok, depth, torch.full_like(depth, -1.0))

    return depth_step, depth_infer


def _weighted_uncentered_l1(x, y, w, eps: float = 1e-7):
    """uncentered_l1 over the valid candidates only (w in {0, 1})."""
    wsum = torch.clamp(w.sum(), min=1.0)
    mx = (x * w).sum() / wsum
    my = (y * w).sum() / wsum
    return (torch.abs(x / (mx + eps) - y / (my + eps)) * w).sum() / wsum


def train_macarons_online(
    assets: SceneAssets,
    state: MacaronsTrainState,
    params: Optional[Params] = None,
    n_poses: int = 100,
    seed: int = 8,
    n_tokens: int = 512,
    n_proxy_tokens: int = 512,
    use_perfect_depth: bool = True,
    learn_depth: bool = False,
    unfreeze_depth_after: int = 0,
    depth_reject_factor: float = 0.0,
    log_depth_error: bool = False,
    memory=None,
    scene_memory_path: Optional[str] = None,
    memory_replay_loops: int = 0,
    verbose: bool = True,
    draws=None,
) -> Dict[str, List[float]]:
    """One scene's online training trajectory (module docstring); the
    state's variables and optimizer states are replaced as it trains.
    Runs on the state's device. Returns the loss and metric logs, as the
    JAX function's. draws: a provider in the sequential schedule (default
    ``TorchDraws(seed)`` on the device)."""
    p = params or default_params()
    model = state.model
    dev = next(iter(model.occ_vars.values())).device
    draws = draws if draws is not None else TorchDraws(seed, dev)

    def group(role: str) -> str:
        draws.begin_group(role)
        return role

    intr = CameraIntrinsics(
        image_height=int(p.image_height), image_width=int(p.image_width),
        fov_degrees=float(p.fov_degrees), znear=float(p.camera_znear),
        zfar=float(p.zfar))
    n_px = intr.image_height * intr.image_width
    n_steps = int(p.n_interpolation_steps)
    cap_kw = dict(n_slots=int(p.points_per_frame),
                  gathering_factor=float(p.gathering_factor),
                  sensor_range=float(p.sensor_range))
    tri_soa = tris_to_soa(torch.from_numpy(assets.tris).to(dev))
    n_tris = torch.tensor([assets.n_tris], dtype=torch.int32, device=dev)
    gt = torch.from_numpy(assets.gt_surface).to(dev)
    L, H, n_azim = assets.pose_l, assets.pose_h, assets.n_azim
    tables = build_scene_tables(tri_soa, n_tris,
                                torch.from_numpy(assets.pose_origin).to(dev),
                                L, H)
    blocked = tables.gt_edge_blocked.cpu().numpy()
    positions = tables.positions.cpu().numpy()

    n_elev_vs = int(p.view_state_n_elev)
    n_azim_vs = int(p.view_state_n_azim)
    base_h, h_polar = base_view_harmonics(n_elev_vs, n_azim_vs,
                                          int(p.harmonic_degree), device=dev)

    def f32(x):
        return torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)

    sx_min = f32(assets.settings.scene.x_min - 0.2)
    sx_max = f32(assets.settings.scene.x_max + 0.2)
    box_center = (sx_min + sx_max) / 2.0
    box_diag = torch.linalg.norm(sx_max - sx_min)

    def norm(q):
        return (q - box_center) / box_diag

    def vharm(view_states):
        with full_f32():
            return compute_view_harmonics(view_states, base_h, h_polar,
                                          n_elev_vs, n_azim_vs)

    n_proxy = int(p.n_proxy_points)
    proxy = ProxyField.create(draws.uniform(group("proxy"), (n_proxy, 3)),
                              sx_min, sx_max, n_elev_vs, n_azim_vs)
    resolution = (float(p.get("surface_resolution", 0.05))
                  * float(p.scene_scale_factor))
    surface = SurfaceStore.create(STORE_CAPACITY, sx_min, sx_max, resolution)
    pc = PointBuffer.create(int(p.full_pc_capacity), dev)
    traj = TrajectoryBuffer.create(8 * (n_poses + 4), dev)
    elev2 = float(assets.elevations_deg[2])

    def pose5_np(idx) -> np.ndarray:
        pos = positions[idx[0], idx[1]]
        return np.asarray([pos[0], pos[1], pos[2], elev2,
                           assets.azimuths_deg[idx[2]]], np.float32)

    def pose5(idx) -> torch.Tensor:
        return torch.from_numpy(pose5_np(idx)).to(dev)

    def frame_points(role, zbuf, R, T):
        return backproject_sample(zbuf, R, T, intr,
                                  draws.uniform(group(role), (n_px,)),
                                  **cap_kw)

    def move(old, new):
        role = group("move")
        scores = [draws.uniform(role, (n_px,), step=s)
                  for s in range(1, n_steps + 1)]
        move_and_capture(tri_soa, n_tris, old, new, pc, traj, scores, intr,
                         n_steps=n_steps, n_azim=n_azim, **cap_kw)

    start = assets.start_cam_idx
    cur = (int(start[0]), int(start[2]), int(start[4]))
    pose0 = pose5(cur)
    group("init")
    scores0 = [draws.uniform("init", (n_px,), step=s)
               for s in range(1, n_steps + 1)]
    move_and_capture(tri_soa, n_tris, pose0, pose0, pc, traj, scores0, intr,
                     n_steps=n_steps, n_azim=n_azim, **cap_kw)

    occ_mod, vis_mod = model.scone_occ, model.scone_vis
    need_rgb = learn_depth or not use_perfect_depth or log_depth_error
    depth_step = depth_infer = None
    if need_rgb:
        depth_step, depth_infer = make_depth_steps(model, state.depth_tx,
                                                   intr, p)
    tri_colors = torch.from_numpy(assets.tri_colors).to(dev)
    ambient = float(p.get("ambient_light_intensity", 0.85))
    frame_hist: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = []

    def occ_apply(ov, pc_tokens, proxy_pts, proxy_vh, role):
        return functional_call(
            occ_mod, ov, (norm(pc_tokens)[None], norm(proxy_pts)[None],
                          proxy_vh), dict(draws=draws, role=role))

    def scone_losses(ov, vv, pc_tokens, proxy_pts, proxy_vh, sup_occ, role):
        occ_pred = occ_apply(ov, pc_tokens, proxy_pts, proxy_vh, role)
        occ_loss = ((occ_pred[0] - sup_occ) ** 2).mean()
        tokens4 = torch.cat([norm(proxy_pts), occ_pred[0]], dim=-1)[None]
        h = functional_call(vis_mod, vv, (tokens4,),
                            dict(view_harmonics=proxy_vh))
        return occ_loss, tokens4, h

    def scone_update(loss, ov, vv):
        g_occ, g_vis = _grads(loss, [ov, vv])
        ou, state.occ_opt_state = state.occ_tx.update(g_occ,
                                                      state.occ_opt_state)
        vu, state.vis_opt_state = state.vis_tx.update(g_vis,
                                                      state.vis_opt_state)
        model.occ_vars = apply_updates(model.occ_vars, ou)
        model.vis_vars = apply_updates(model.vis_vars, vu)

    def scone_step(pc_tokens, proxy_pts, proxy_vh, sup_occ, cand_cams,
                   cand_fov, cand_w, measured):
        role = group("scone")
        with full_f32():
            ov, vv = _leaves(model.occ_vars), _leaves(model.vis_vars)
            occ_loss, tokens4, h = scone_losses(ov, vv, pc_tokens, proxy_pts,
                                                proxy_vh, sup_occ, role)
            pred_gain = coverage_gain(tokens4[..., :3], h,
                                      norm(cand_cams)[None],
                                      fov_mask=cand_fov[None])
            cov_loss = _weighted_uncentered_l1(pred_gain[0], measured,
                                               cand_w)
            scone_update(occ_loss + cov_loss, ov, vv)
        return occ_loss.detach(), cov_loss.detach()

    def occ_replay_step(pc_tokens, proxy_pts, proxy_vh, sup_occ):
        role = group("replay")
        with full_f32():
            ov = _leaves(model.occ_vars)
            pred = occ_apply(ov, pc_tokens, proxy_pts, proxy_vh, role)
            loss = ((pred[0] - sup_occ) ** 2).mean()
            (g,) = _grads(loss, [ov])
            ou, state.occ_opt_state = state.occ_tx.update(
                g, state.occ_opt_state)
            model.occ_vars = apply_updates(model.occ_vars, ou)
        return loss.detach()

    def scone_replay_step(pc_tokens, proxy_pts, proxy_vh, sup_occ,
                          base_clouds, base_valid, replay_clouds,
                          replay_valid, replay_cams):
        """Occupancy + coverage-gain supervision on a replayed scene: the
        base frames go through camera_coverage_gain + fill in trajectory
        order, then each held-out camera is measured before its own cloud
        is filled."""
        store = SurfaceStore.create(REPLAY_STORE_CAPACITY, sx_min, sx_max,
                                    resolution)
        for cloud, valid in zip(base_clouds, base_valid):
            _, store = camera_coverage_gain(store, cloud, valid, eps_cov)
            store = store.fill(cloud, valid)
        measured = []
        for cloud, valid in zip(replay_clouds, replay_valid):
            gain, store = camera_coverage_gain(store, cloud, valid, eps_cov)
            measured.append(gain / torch.clamp(valid.sum(), min=1))
            store = store.fill(cloud, valid)
        measured = torch.stack(measured)
        role = group("replay")
        with full_f32():
            ov, vv = _leaves(model.occ_vars), _leaves(model.vis_vars)
            occ_loss, tokens4, h = scone_losses(ov, vv, pc_tokens, proxy_pts,
                                                proxy_vh, sup_occ, role)
            pred_gain = coverage_gain(tokens4[..., :3], h,
                                      norm(replay_cams)[None])
            cov_loss = uncentered_l1(pred_gain[..., None],
                                     measured[None, :, None])
            scone_update(occ_loss + cov_loss, ov, vv)
        return occ_loss.detach(), cov_loss.detach()

    def run_memory_replay(rng_py, n_replay_poses: int = 2):
        scene = memory.get_random_scene_for_scone_model(
            scene_memory_path, intr, rng=rng_py,
            sensor_range=float(p.sensor_range),
            n_replay_poses=n_replay_poses, device=dev)
        if scene is None:
            return None
        pr = np.random.default_rng(rng_py.randrange(2 ** 31))
        pi = pr.integers(0, len(scene["proxy_points"]), n_proxy_tokens)
        si = pr.integers(0, len(scene["surface"]), n_tokens)

        def t(x, dtype=torch.float32):
            return torch.from_numpy(np.asarray(x)).to(dev, dtype)

        vh_r = vharm(t(scene["view_states"][pi])[None])
        args = (t(scene["surface"][si]), t(scene["proxy_points"][pi]), vh_r,
                t(scene["supervision_occ"][pi]))
        if "replay_cams" in scene:
            ol, cl = scone_replay_step(
                *args, t(scene["base_clouds"]),
                t(scene["base_valid"], torch.bool), t(scene["replay_clouds"]),
                t(scene["replay_valid"], torch.bool), t(scene["replay_cams"]))
            logs["replay_cov_loss"].append(float(cl))
            return float(ol)
        return float(occ_replay_step(*args))

    # The staged-unfreeze guard (depth_reject_factor > 0): the recent
    # accepted photometric losses and the last known-good (vars, opt),
    # shared by the online and the replay depth steps.
    guard = {"photos": [], "snapshot": None}

    def apply_depth_update(new_vars, new_opt, photo, pose_marker):
        """Accept the update, or (the loss at the pre-update weights spikes
        over depth_reject_factor x the median of the last 10 accepted)
        roll back to the last good snapshot. Returns the float loss."""
        photo_f = float(photo)
        photos = guard["photos"]
        good = bool(photos) and photo_f <= depth_reject_factor * float(
            np.median(photos[-10:]))
        if depth_reject_factor <= 0 or not photos or good:
            if depth_reject_factor > 0:
                guard["snapshot"] = (model.depth_vars, state.depth_opt_state)
                photos.append(photo_f)
            model.depth_vars = new_vars
            state.depth_opt_state = new_opt
        elif guard["snapshot"] is not None:
            model.depth_vars, state.depth_opt_state = guard["snapshot"]
            logs.setdefault("depth_rejected_poses", []).append(pose_marker)
        return photo_f

    def img(rgb_u8) -> torch.Tensor:
        return torch.from_numpy(np.asarray(rgb_u8)).to(dev, torch.float32) \
            / 255.0

    def run_depth_memory_replay(rng_py, pose_marker):
        """A consecutive 4-frame window of another trajectory re-trains
        ManyDepth (target frame 2, alphas frames 1, 0, 3) through the same
        step and guard as the online path."""
        frames = memory.random_replay_frames(scene_memory_path, 4,
                                             rng=rng_py)
        if len(frames) < 4 or "rgb" not in frames[0]:
            return None

        def cam(f):
            return (torch.from_numpy(np.asarray(f["R"], np.float32)
                                     .reshape(3, 3)).to(dev),
                    torch.from_numpy(np.asarray(f["T"], np.float32)
                                     .reshape(3)).to(dev))

        tgt, alphas = frames[2], (frames[1], frames[0], frames[3])
        x_alpha = torch.stack([img(f["rgb"]) for f in alphas])
        R_a = torch.stack([cam(f)[0] for f in alphas])
        T_a = torch.stack([cam(f)[1] for f in alphas])
        aug = draws.uniforms(group("depth"), AUG_SHAPES)
        with span("depth_step"):
            new_vars, new_opt, photo, _ = depth_step(
                model.depth_vars, state.depth_opt_state, img(tgt["rgb"]),
                *cam(tgt), x_alpha, R_a, T_a, aug)
        return apply_depth_update(new_vars, new_opt, photo, pose_marker)

    mem_rng = _pyrandom.Random(seed + 17)
    frame_nb = 0
    use_memory = memory is not None and scene_memory_path
    if use_memory:
        memory.begin_trajectory(scene_memory_path)
    pose_history: List[List[float]] = []
    all_frames: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    remap_every = int(p.get("remap_every_n_poses", 95))

    logs = {"coverage": [], "occ_loss": [], "cov_loss": [], "gain": [],
            "depth_loss": [], "depth_abs_err": [], "store_coverage": [],
            "replay_occ_loss": [], "replay_cov_loss": [],
            "replay_depth_loss": []}
    eps_cov = (2.0 * float(p.get("surface_resolution", 0.05))
               * float(p.scene_scale_factor)
               * float(p.surface_epsilon_factor))
    curriculum_dists = curriculum_sampling_distances(
        max(n_poses, 2), float(3.0 * proxy.distance_between_points),
        float(2.0 * torch.linalg.norm(sx_max - sx_min)))
    carve_kw = dict(score_threshold=float(p.score_threshold),
                    carving_tolerance=float(p.carving_tolerance),
                    n_elev=n_elev_vs, n_azim=n_azim_vs,
                    sensor_range=float(p.sensor_range))

    for pose_i in range(n_poses):
        with span("coverage"):
            cov = float(coverage_percentage_exact(
                gt, pc.points, pc.count,
                draws.uniform(group("cov"), (pc.capacity,))))
        logs["coverage"].append(cov)
        if verbose and pose_i % 10 == 0:
            print(f"macarons pose {pose_i}: coverage {cov:.4f}")

        cur_pose = pose5(cur)
        pose_history.append([float(v) for v in pose5_np(cur)])
        with span("render"):
            if need_rgb:
                rgb, zbuf, R, T = capture_rgbd(tri_soa, n_tris, cur_pose,
                                               intr, tri_colors=tri_colors,
                                               ambient=ambient)
                frame_hist.append((rgb, R, T))
                if len(frame_hist) > 4:
                    frame_hist.pop(0)
                if not use_perfect_depth:
                    all_frames.append((
                        (np.clip(rgb.cpu().numpy(), 0, 1) * 255)
                        .astype(np.uint8), R.cpu().numpy(), T.cpu().numpy()))
            else:
                zbuf, R, T = capture_depth(tri_soa, n_tris, cur_pose, intr)

        have_context = need_rgb and len(frame_hist) >= 3
        if learn_depth and pose_i >= unfreeze_depth_after \
                and len(frame_hist) >= 4:
            # One pose behind capture: target the previous frame, alphas
            # -1, -2 and the just-captured +1.
            hist = [frame_hist[-3], frame_hist[-4], frame_hist[-1]]
            aug = draws.uniforms(group("depth"), AUG_SHAPES)
            with span("depth_step"):
                new_vars, new_opt, photo, reg = depth_step(
                    model.depth_vars, state.depth_opt_state,
                    *frame_hist[-2], torch.stack([f[0] for f in hist]),
                    torch.stack([f[1] for f in hist]),
                    torch.stack([f[2] for f in hist]), aug)
            logs["depth_loss"].append(
                apply_depth_update(new_vars, new_opt, photo, pose_i))

        def infer_current():
            past = [frame_hist[-2], frame_hist[-3]]
            with span("depth_infer"):
                return depth_infer(model.depth_vars, rgb, R, T,
                                   torch.stack([f[0] for f in past]),
                                   torch.stack([f[1] for f in past]),
                                   torch.stack([f[2] for f in past]))

        zbuf_used = zbuf
        if not use_perfect_depth and have_context:
            zbuf_used = infer_current()
        if log_depth_error and have_context:
            pred = infer_current() if use_perfect_depth else zbuf_used
            valid = (pred > 0) & (zbuf > 0)
            err = (torch.abs(pred - zbuf) * valid).sum() / torch.clamp(
                valid.sum(), min=1)
            logs["depth_abs_err"].append(float(err))
        if use_memory:
            slot = memory.current_trajectory()
            memory.save_frame(scene_memory_path, slot, frame_nb,
                              zbuf.cpu().numpy(), R.cpu().numpy(),
                              T.cpu().numpy(), float(p.zfar),
                              rgb=rgb.cpu().numpy() if need_rgb else None)
            memory.save_depth(scene_memory_path, slot, frame_nb,
                              zbuf_used.cpu().numpy(), R.cpu().numpy(),
                              T.cpu().numpy())
            frame_nb += 1
            for _ in range(memory_replay_loops):
                with span("replay"):
                    rl = run_memory_replay(mem_rng)
                if rl is not None:
                    logs["replay_occ_loss"].append(rl)
                if learn_depth and pose_i >= unfreeze_depth_after:
                    dl_r = run_depth_memory_replay(mem_rng, pose_i)
                    if dl_r is not None:
                        logs["replay_depth_loss"].append(dl_r)

        with span("fill"):
            batch = frame_points("frame", zbuf_used, R, T)
            surface = surface.fill(batch.points, batch.valid)
        if log_depth_error:
            with span("coverage"):
                logs["store_coverage"].append(float(coverage_percentage_exact(
                    gt, surface.points, surface.count,
                    draws.uniform(group("store_cov"), (surface.capacity,)))))
        with span("carve"):
            proxy = carve_with_frame(proxy, zbuf_used, R, T, cur_pose[:3],
                                     intr, **carve_kw)

        cands, valid = neighbour_candidates(cur, blocked, L, H, n_azim)
        cand_valid = valid.astype(np.float32)
        if not cand_valid.any():
            rot = int(draws.randint(group("rot"), 0, n_azim))
            cands[0] = (cur[0], cur[1], rot)
            cand_valid[0] = 1.0
        cand_xyz = torch.from_numpy(
            np.stack([positions[c[0], c[1]] for c in cands])).to(dev)
        cand_pose = torch.from_numpy(
            np.stack([pose5_np(c) for c in cands])).to(dev)
        R_c, T_c = get_camera_RT(cand_pose[:, :3], cand_pose[:, 3:5])

        with span("tokens"):
            # Curriculum: proxy tokens within the ramp's distance of the
            # camera (all of them when none is), as Gumbel-max.
            d_t = curriculum_dists[min(pose_i, len(curriculum_dists) - 1)]
            prox_d = torch.linalg.norm(proxy.points - cur_pose[:3][None],
                                       dim=-1)
            near = prox_d <= float(d_t)
            logits = torch.where(near, torch.zeros_like(prox_d),
                                 torch.full_like(prox_d, -float("inf")))
            logits = torch.where(near.any(), logits, torch.zeros_like(logits))
            noise = draws.gumbel(group("proxy_tokens"),
                                 (n_proxy_tokens, n_proxy))
            pidx = torch.argmax(noise + logits[None], dim=-1)
            del noise
            proxy_pts = proxy.points[pidx]
            sup_occ = proxy.supervision_occ[pidx]
            vh = vharm(proxy.view_states[None, pidx])
            tidx = draws.randint(group("tokens"), 0,
                                 torch.clamp(pc.count, min=1),
                                 shape=(n_tokens,))
            pc_tokens = pc.points[tidx]

        with span("nbv"), torch.no_grad(), full_f32():
            cand_fov = points_in_fov_mask(
                proxy_pts[None], R_c[:, None], T_c[:, None], intr,
                fov_range=float(p.sensor_range)).to(torch.float32)
            h = functional_call(
                vis_mod, model.vis_vars,
                (torch.cat([norm(proxy_pts), sup_occ], -1)[None],),
                dict(view_harmonics=vh))
            gains = coverage_gain(norm(proxy_pts)[None], h,
                                  norm(cand_xyz)[None],
                                  fov_mask=cand_fov[None])[0]
            gains = torch.where(torch.from_numpy(cand_valid).to(dev) > 0,
                                gains, torch.full_like(gains, -float("inf")))
            chosen = int(torch.argmax(gains))
        nxt = cands[chosen]

        with span("move"):
            move(cur_pose, pose5(nxt))
        with span("gain"):
            zb2, R2, T2 = capture_depth(tri_soa, n_tris, pose5(nxt), intr)
            new_batch = frame_points("new_frame", zb2, R2, T2)
            gain, surface = camera_coverage_gain(
                surface, new_batch.points, new_batch.valid, eps_cov)
            logs["gain"].append(float(gain))

        # The executed candidate's measured gain; the other slots 1e-3,
        # the padded ones weight 0.
        measured = torch.full((C_MAX,), 1e-3, dtype=torch.float32,
                              device=dev)
        measured[chosen] = torch.clamp(
            gain / torch.clamp(new_batch.valid.sum(), min=1), min=1e-3)
        with span("scone_step"):
            ol, cl = scone_step(pc_tokens, proxy_pts, vh, sup_occ, cand_xyz,
                                cand_fov,
                                torch.from_numpy(cand_valid).to(dev),
                                measured)
        logs["occ_loss"].append(float(ol))
        logs["cov_loss"].append(float(cl))

        if (not use_perfect_depth and remap_every > 0 and pose_i > 0
                and pose_i % remap_every == 0 and len(all_frames) >= 3):
            with span("remap"):
                surface, pc, proxy = _remap(
                    all_frames, depth_infer, model, img, frame_points,
                    surface, proxy, intr, carve_kw, memory if use_memory
                    else None, scene_memory_path, dev, resolution, sx_min,
                    sx_max, int(p.full_pc_capacity))
            if verbose:
                print(f"macarons pose {pose_i}: recompute_mapping rebuilt "
                      f"{len(all_frames) - 2} frames, {int(pc.count)} points")
        cur = nxt

    if use_memory:
        slot = memory.current_trajectory()
        memory.save_surface(scene_memory_path, slot, pc.points.cpu().numpy(),
                            int(pc.count))
        memory.save_occupancy(
            scene_memory_path, slot, proxy.points.cpu().numpy(),
            proxy.proba.cpu().numpy(), proxy.supervision_occ.cpu().numpy(),
            proxy.view_states.cpu().numpy(),
            proxy.out_of_field.cpu().numpy())
        memory.save_poses(scene_memory_path, pose_history, traj=slot)
    return logs


def _remap(all_frames, depth_infer, model, img, frame_points, surface,
           proxy, intr, carve_kw, memory, scene_memory_path, dev,
           resolution, sx_min, sx_max, pc_capacity):
    """The recompute_mapping analog: frames 2.. of the history re-inferred
    with the current depth weights, and a new point cloud, surface store
    and proxy carving built from them; the memory's depths refreshed."""
    surface = SurfaceStore.create(surface.capacity, sx_min, sx_max,
                                  resolution)
    pc = PointBuffer.create(pc_capacity, dev)
    P_n = proxy.points.shape[0]

    def full(cols, value):
        return torch.full((P_n, cols), value, dtype=torch.float32,
                          device=dev)

    proxy = dataclasses.replace(
        proxy, proba=full(1, 0.5), supervision_occ=full(1, 1.0),
        view_states=torch.zeros_like(proxy.view_states),
        n_inside_fov=full(1, 0.0), n_behind_depth=full(1, 0.0),
        out_of_field=full(1, 1.0))

    def cam(t):
        return (torch.from_numpy(all_frames[t][1]).to(dev),
                torch.from_numpy(all_frames[t][2]).to(dev))

    for t in range(2, len(all_frames)):
        R_t, T_t = cam(t)
        z_t = depth_infer(
            model.depth_vars, img(all_frames[t][0]), R_t, T_t,
            torch.stack([img(all_frames[t - 1][0]),
                         img(all_frames[t - 2][0])]),
            torch.stack([cam(t - 1)[0], cam(t - 2)[0]]),
            torch.stack([cam(t - 1)[1], cam(t - 2)[1]]))
        b = frame_points("remap", z_t, R_t, T_t)
        pc.append(b, prefix_valid=True)
        surface = surface.fill(b.points, b.valid)
        proxy = carve_with_frame(proxy, z_t, R_t, T_t,
                                 camera_center(R_t, T_t), intr, **carve_kw)
        if memory is not None:
            memory.save_depth(scene_memory_path, memory.current_trajectory(),
                              t, z_t.cpu().numpy(), R_t.cpu().numpy(),
                              T_t.cpu().numpy())
    return surface, pc, proxy
