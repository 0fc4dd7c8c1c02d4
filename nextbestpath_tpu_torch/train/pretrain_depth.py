"""Offline depth-network pretraining on PyTorch: the warm-start substitute.

Port of ``nextbestpath_tpu/train/pretrain_depth.py``. The reference warm-
starts ManyDepth from a pretrained depth model that cannot exist offline;
this trains the same network supervised against rendered zbuf over many
procedural scenes, so that the online photometric loop
(``train/train_macarons.py``) starts from a geometry-aware initialisation.

* A sample is a 3-pose random lattice walklet (``_sample_walk``: a uniform
  inside cell, then unblocked unit moves with azimuth turns in [-2, 2]),
  rendered as RGB-D frames (``capture_rgbd``, kernel K1): the target is the
  last pose's frame, the contexts the two poses behind it, ``[r1, r0]``,
  the frame history's layout online. The scene's inside cells and blocked
  edges come from ``sim/tables.py::build_scene_tables`` (kernel K2).
* The loss is dense L1 on the 4 disparity scales against
  ``depth_to_disparity(zbuf)`` downscaled as ``jax.image.resize(...,
  "linear")`` does (``resize_linear``), background rays supervising
  toward d_max.
* ManyDepth runs in train mode (``models/resnet.py``: batch statistics,
  running statistics moved in place by the forward); Adam (optax's) steps
  the parameters only.

Draws come in the sequential schedule of ``draws.py``: ``begin_group``
``eval`` for the held-out batch and ``batch`` for each step's, then each
sample's walk with ``step`` the sample's index. Checkpoints are the JAX
package's (``depth_pre_best.ckpt``, ``depth_pre_latest.ckpt``: flax
``params`` and ``batch_stats``), which JAX ``train_macarons.py
--depth-ckpt`` reads. On the card the step runs in full f32 (TF32 off).
"""

from __future__ import annotations

import json
import os
import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..assets.scene_assets import SceneAssets
from ..config import Params, default_params
from ..device import DeviceLike, full_f32, resolve_device
from ..draws import TorchDraws
from ..geometry.cameras import CameraIntrinsics
from ..models.convert import manydepth_from_flax, manydepth_to_flax
from ..models.macarons import Adam, adam_step_
from ..models.manydepth import (D_MAX, D_MIN, ManyDepth, depth_to_disparity,
                                disparity_to_depth, flax_init_)
from ..ops.raytrace import tris_to_soa
from ..sim.sensor import capture_rgbd
from ..sim.tables import build_scene_tables
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.timing import span

_DIRS = ((1, 0), (-1, 0), (0, 1), (0, -1))
_SCALE_WEIGHTS = (1.0, 0.5, 0.25, 0.125)
DEPTH_STAGES = ("batch", "step", "eval")


class DepthScene(NamedTuple):
    """A scene's device constants for sampling and rendering."""

    tri_soa: torch.Tensor       # (9, F)
    n_tris: torch.Tensor        # (1,) int32
    positions: torch.Tensor     # (L, H, 3)
    inside: torch.Tensor        # (L, H) bool
    edge_blocked: torch.Tensor  # (4, L, H) bool
    azims: torch.Tensor         # (A,)
    elev: torch.Tensor          # 0-d


def depth_scene_from_assets(assets: SceneAssets,
                            device: DeviceLike = "cuda") -> DepthScene:
    """The scene on the device with its tables (one K2 launch)."""
    dev = resolve_device(device)
    tri_soa = tris_to_soa(torch.from_numpy(assets.tris).to(dev))
    n_tris = torch.tensor([assets.n_tris], dtype=torch.int32, device=dev)
    tables = build_scene_tables(
        tri_soa, n_tris, torch.from_numpy(assets.pose_origin).to(dev),
        assets.pose_l, assets.pose_h)
    return DepthScene(
        tri_soa=tri_soa, n_tris=n_tris, positions=tables.positions,
        inside=tables.inside, edge_blocked=tables.gt_edge_blocked,
        azims=torch.from_numpy(np.asarray(assets.azimuths_deg,
                                          np.float32)).to(dev),
        elev=torch.tensor(float(assets.elevations_deg[2]),
                          dtype=torch.float32, device=dev))


def _sample_walk(scene: DepthScene, draws, n_azim: int, n_poses: int = 3,
                 step: Optional[int] = None):
    """A short random lattice walk: n_poses consecutive (5,) poses.

    The start is uniform over the inside cells (``categorical`` as the
    argmax of the logits plus ``cell``'s Gumbel noise) with azimuth
    ``a0``; each move takes a uniform unblocked direction (``dir``; it
    stays in place when every edge is blocked) and a turn ``da`` in [-2,
    2]. Nothing is read back to the host."""
    L, H = scene.inside.shape
    dev = scene.positions.device
    neg_inf = torch.tensor(float("-inf"), device=dev)
    zero = torch.zeros((), device=dev)
    logits = torch.where(scene.inside.reshape(-1), zero, neg_inf)
    flat = torch.argmax(logits + draws.gumbel("cell", (L * H,), step=step))
    c = torch.stack([flat // H, flat % H])
    a = draws.randint("a0", 0, n_azim, step=step)
    dirs = torch.tensor(_DIRS, dtype=torch.long, device=dev)
    hi = torch.tensor([L - 1, H - 1], dtype=torch.long, device=dev)

    def pose5(c, a):
        return torch.cat([scene.positions[c[0], c[1]], scene.elev[None],
                          scene.azims[a][None]])

    poses = [pose5(c, a)]
    for _ in range(n_poses - 1):
        blocked = scene.edge_blocked[:, c[0], c[1]]
        any_open = (~blocked).any()
        dir_logits = torch.where(blocked & any_open, neg_inf, zero)
        d = torch.argmax(dir_logits + draws.gumbel("dir", (4,), step=step))
        c = torch.where(any_open, c + dirs[d], c)
        c = torch.minimum(torch.clamp(c, min=0), hi)
        da = draws.randint("da", -2, 3, step=step)
        a = torch.remainder(a + da, n_azim)
        poses.append(pose5(c, a))
    return poses


def make_batch_fn(intr: CameraIntrinsics, n_azim: int, batch: int):
    """Batch builder: (scene, draws) -> (tgt (B, H, W, 3), R, T, x_alpha
    (B, 2, H, W, 3), R_alpha, T_alpha, zbuf (B, H, W)): per sample three
    RGB-D frames of a walklet (3 B K1 launches), the target the last
    pose's, the contexts ``[r1, r0]``."""

    def make_batch(scene: DepthScene, draws):
        cols = [[] for _ in range(7)]
        for b in range(batch):
            frames = [capture_rgbd(scene.tri_soa, scene.n_tris, p, intr)
                      for p in _sample_walk(scene, draws, n_azim, 3, step=b)]
            (r0, _, R0, T0), (r1, _, R1, T1), (r2, z2, R2, T2) = frames
            for col, v in zip(cols, (r2, R2, T2, torch.stack([r1, r0]),
                                     torch.stack([R1, R0]),
                                     torch.stack([T1, T0]), z2)):
                col.append(v)
        return tuple(torch.stack(col) for col in cols)

    return make_batch


def _weight_mat(m: int, n: int, dtype, device) -> torch.Tensor:
    """(m, n) weights of ``jax.image.resize``'s linear kernel from m to n
    samples (``compute_weight_mat``): sample centres (j + 0.5) m / n - 0.5,
    a triangle kernel widened by m / n when downscaling (antialiasing),
    columns normalised, zero where the centre leaves [-0.5, m - 0.5]."""
    inv_scale = 1.0 / (n / m)
    kernel_scale = max(inv_scale, 1.0)
    s = (torch.arange(n, dtype=dtype, device=device) + 0.5) * inv_scale - 0.5
    x = torch.abs(s[None, :] - torch.arange(m, dtype=dtype, device=device
                                            )[:, None]) / kernel_scale
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (s >= -0.5) & (s <= m - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_linear(x: torch.Tensor, size) -> torch.Tensor:
    """``jax.image.resize(x, (B, h, w, C), "linear")`` of NHWC x: each
    spatial axis that changes is contracted with its ``_weight_mat``."""
    H, W = x.shape[1], x.shape[2]
    h, w = int(size[0]), int(size[1])
    if H != h:
        x = torch.einsum("bhwc,hk->bkwc", x,
                         _weight_mat(H, h, x.dtype, x.device))
    if W != w:
        x = torch.einsum("bhwc,wk->bhkc", x,
                         _weight_mat(W, w, x.dtype, x.device))
    return x


def supervised_disparity_loss(disps, zbuf: torch.Tensor) -> torch.Tensor:
    """Multi-scale L1 against ``depth_to_disparity(zbuf)``; background (-1)
    rays supervise toward d_max (disparity 0), what a miss means."""
    gt_depth = torch.where(zbuf > 0, zbuf, torch.full_like(zbuf, D_MAX))
    gt_disp = depth_to_disparity(torch.clamp(gt_depth, D_MIN, D_MAX))[..., None]
    loss = 0.0
    for w, d in zip(_SCALE_WEIGHTS, disps):
        gt_s = resize_linear(gt_disp, d.shape[1:3])
        loss = loss + w * torch.abs(d - gt_s).mean()
    return loss


def make_train_step(model: ManyDepth, tx: Adam):
    """``step(opt_state, tgt, R, T, x_alpha, R_alpha, T_alpha, zbuf) ->
    (opt_state, loss)``: ManyDepth in train mode (the forward moves its
    running statistics), the loss, its gradient and an Adam step of the
    parameters, in place."""
    def step(opt_state, tgt, R, T, xa, Ra, Ta, zbuf):
        with full_f32():
            disps = model(tgt, R, T, xa, Ra, Ta, train=True)
            loss = supervised_disparity_loss(disps, zbuf)
            opt_state = adam_step_(model, loss, tx, opt_state)
        return opt_state, loss.detach()

    return step


def make_eval_fn(model: ManyDepth):
    """Mean |depth - zbuf| over the hit pixels of the full-resolution
    disparity, BatchNorm in eval mode."""

    @torch.no_grad()
    def evaluate(tgt, R, T, xa, Ra, Ta, zbuf):
        with full_f32():
            disp1 = model(tgt, R, T, xa, Ra, Ta)[0]
        depth = disparity_to_depth(disp1[..., 0])
        valid = (zbuf > 0).to(depth.dtype)
        return (torch.abs(depth - zbuf) * valid).sum() / torch.clamp(
            valid.sum(), min=1.0)

    return evaluate


def save_depth_checkpoint(path: str, model: ManyDepth, step: int,
                          err: float) -> None:
    """The JAX package's depth checkpoint: flax variables, the step as its
    epoch, the held-out error in ``extra``."""
    save_checkpoint(path, manydepth_to_flax(model.state_dict()), epoch=step,
                    extra={"eval_err": err})


def load_depth_checkpoint(path: str, model: ManyDepth) -> None:
    """A depth checkpoint (either package's) into ``model``, strict."""
    variables = load_checkpoint(path)[0]
    sd = manydepth_from_flax(variables)
    dev = next(model.parameters()).device
    model.load_state_dict({k: v.to(dev) for k, v in sd.items()}, strict=True)


def pretrain_depth(
    scenes: Sequence[SceneAssets],
    eval_scene: SceneAssets,
    steps: int = 2000,
    batch: int = 2,
    lr: float = 1e-4,
    seed: int = 8,
    out_dir: str = "weights/depth_pre",
    log_dir: str = "training_log",
    eval_every: int = 100,
    image_height: int = 256,
    image_width: int = 456,
    params: Optional[Params] = None,
    resume: Optional[str] = None,
    max_wall_s: Optional[float] = None,
    verbose: bool = True,
    model: Optional[ManyDepth] = None,
    draws=None,
    device: DeviceLike = "cuda",
):
    """Supervised depth pretraining over procgen scenes.

    Saves ``depth_pre_best.ckpt`` (the lowest held-out mean |depth - zbuf|)
    and ``depth_pre_latest.ckpt`` at each evaluation, and
    ``depth_pre_loss.json`` into ``log_dir``. ``model``: the initial
    network (default ManyDepth with flax's initialisers from ``seed``),
    trained in place on the device; ``resume`` loads a checkpoint over it.
    ``draws``: the provider (default a ``TorchDraws`` seeded ``seed``).
    Returns (model, best_err)."""
    dev = resolve_device(device)
    p = params or default_params()
    intr = CameraIntrinsics(image_height=image_height,
                            image_width=image_width,
                            fov_degrees=float(p.fov_degrees),
                            znear=float(p.camera_znear), zfar=float(p.zfar))
    if model is None:
        model = flax_init_(ManyDepth(intr=intr), seed)
    model = model.to(dev)
    if resume and os.path.exists(resume):
        load_depth_checkpoint(resume, model)
        if verbose:
            print(f"resumed depth variables from {resume}")
    draws = draws if draws is not None else TorchDraws(seed, dev)
    tx = Adam(lr)
    opt_state = tx.init(dict(model.named_parameters()))

    n_azim = scenes[0].n_azim
    d_scenes = [depth_scene_from_assets(a, dev) for a in scenes]
    make_batch = make_batch_fn(intr, n_azim, batch)
    train_step = make_train_step(model, tx)
    evaluate = make_eval_fn(model)

    # The fixed held-out batch.
    ev_scene = depth_scene_from_assets(eval_scene, dev)
    draws.begin_group("eval")
    ev_batch = make_batch(ev_scene, draws)

    best_err = float("inf")
    log = {"loss": [], "eval_err": []}
    os.makedirs(out_dir, exist_ok=True)
    os.makedirs(log_dir, exist_ok=True)
    t0 = time.time()
    for step_i in range(steps):
        with span("batch"):
            draws.begin_group("batch")
            b = make_batch(d_scenes[step_i % len(d_scenes)], draws)
        with span("step"):
            opt_state, loss = train_step(opt_state, *b)
        log["loss"].append(float(loss))
        if verbose and (step_i < 3 or step_i % 50 == 0):
            print(f"step {step_i}: loss {log['loss'][-1]:.5f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
        if (step_i + 1) % eval_every == 0 or step_i == steps - 1:
            with span("eval"):
                err = float(evaluate(*ev_batch))
            log["eval_err"].append({"step": step_i + 1, "err": err})
            if verbose:
                print(f"  eval mean|depth-zbuf| = {err:.4f} "
                      f"(best {best_err:.4f})", flush=True)
            if err < best_err:
                best_err = err
                save_depth_checkpoint(
                    os.path.join(out_dir, "depth_pre_best.ckpt"), model,
                    step_i + 1, err)
            save_depth_checkpoint(
                os.path.join(out_dir, "depth_pre_latest.ckpt"), model,
                step_i + 1, err)
            with open(os.path.join(log_dir, "depth_pre_loss.json"),
                      "w") as f:
                json.dump(log, f)
        if max_wall_s is not None and time.time() - t0 > max_wall_s:
            if verbose:
                print(f"wall budget reached at step {step_i}", flush=True)
            break
    return model, best_err
