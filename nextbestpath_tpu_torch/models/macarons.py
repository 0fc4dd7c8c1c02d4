"""MACARONS composite model (depth + occupancy + visibility) and its
optimizers.

Port of ``nextbestpath_tpu/models/macarons.py`` (the reference's
macarons/networks/Macarons.py). ``Macarons`` holds the three modules and
their variables as dicts of tensors by ``state_dict`` name (``depth_vars``,
``occ_vars``, ``vis_vars``); ``__call__`` applies a module with its
variables (``torch.func.functional_call``), so a training step can take
new variables without touching the modules, as flax's ``apply`` does, and
the staged-unfreeze guard can roll back by keeping references.

The JAX trainer differentiates with respect to a module's whole variable
tree, so its optimizers also step ManyDepth's BatchNorm running means and
variances (which eval-mode BatchNorm reads); here too every variable is
optimized.

``Adam`` is optax's ``adam`` (``scale_by_adam`` with eps outside the
square root and bias correction, then ``scale(-lr)``), optionally chained
after ``clip_by_global_norm`` (optax's formula: ``t / norm * max_norm``
when the norm is not below ``max_norm``); ``Frozen`` is
``optax.set_to_zero``. Both are functional: ``init(params)`` and
``update(grads, state) -> (updates, state)`` on dicts of tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.func import functional_call

from ..geometry.cameras import CameraIntrinsics
from .convert import (manydepth_from_flax, scone_occ_from_flax,
                      scone_vis_from_flax)
from .manydepth import ManyDepth, flax_init_
from .scone import SconeOcc, SconeVis, coverage_gain, visibility_gains

Vars = Dict[str, torch.Tensor]


def module_vars(module: torch.nn.Module) -> Vars:
    """A module's parameters and buffers by ``state_dict`` name, detached."""
    return {k: v.detach() for k, v in module.state_dict().items()}


@dataclasses.dataclass
class Macarons:
    """The three modules and their variables."""

    depth: ManyDepth
    scone_occ: SconeOcc
    scone_vis: SconeVis
    depth_vars: Vars
    occ_vars: Vars
    vis_vars: Vars

    @staticmethod
    def create(seed: int = 0, intr: Optional[CameraIntrinsics] = None,
               seq_len: int = 2048, image_height: int = 256,
               image_width: int = 456, device="cpu") -> "Macarons":
        """Published widths with random weights from ``seed``: ManyDepth
        with flax's initialisers, the SCONE models with PyTorch's."""
        intr = intr or CameraIntrinsics(image_height=image_height,
                                        image_width=image_width)
        torch.manual_seed(seed)
        occ = SconeOcc(seq_len=seq_len)
        vis = SconeVis()
        depth = flax_init_(ManyDepth(intr=intr), seed)
        return Macarons._of(depth, occ, vis, device)

    @staticmethod
    def from_flax(depth_vars, occ_vars, vis_vars,
                  intr: Optional[CameraIntrinsics] = None,
                  seq_len: int = 2048, image_height: int = 256,
                  image_width: int = 456, device="cpu",
                  dtype=np.float32) -> "Macarons":
        """From the JAX package's variables as numpy trees (``depth_vars``
        with ``params`` and ``batch_stats``; the SCONE ones with or
        without their ``params`` level)."""
        intr = intr or CameraIntrinsics(image_height=image_height,
                                        image_width=image_width)
        depth = ManyDepth(intr=intr,
                          learn_pose="pose_decoder" in depth_vars["params"])
        depth.load_state_dict(manydepth_from_flax(depth_vars, dtype))
        occ = SconeOcc(seq_len=seq_len)
        occ.load_state_dict(scone_occ_from_flax(occ_vars, dtype))
        vis = SconeVis()
        vis.load_state_dict(scone_vis_from_flax(vis_vars, dtype))
        if dtype == np.float64:
            depth, occ, vis = depth.double(), occ.double(), vis.double()
        return Macarons._of(depth, occ, vis, device)

    @staticmethod
    def _of(depth, occ, vis, device) -> "Macarons":
        depth, occ, vis = (m.to(device).eval() for m in (depth, occ, vis))
        return Macarons(depth, occ, vis, module_vars(depth),
                        module_vars(occ), module_vars(vis))

    def __call__(self, mode: str, *args, variables: Optional[Vars] = None,
                 **kwargs):
        """Mode dispatch (Macarons.forward): ``depth``, ``occupancy`` or
        ``visibility``, with the bundle's variables or ``variables``."""
        modules = {"depth": (self.depth, self.depth_vars),
                   "occupancy": (self.scone_occ, self.occ_vars),
                   "visibility": (self.scone_vis, self.vis_vars)}
        if mode not in modules:
            raise ValueError(f"unknown mode {mode!r}")
        module, own = modules[mode]
        return functional_call(module, own if variables is None
                               else variables, args, kwargs)

    def compute_visibility_gains(self, pts, view_harmonics, X_cam,
                                 per_point: bool = False):
        """SconeVis's harmonics evaluated toward candidate cameras."""
        h = self("visibility", pts, view_harmonics=view_harmonics)
        if per_point:
            return visibility_gains(pts[..., :3], h, X_cam)
        return coverage_gain(pts[..., :3], h, X_cam)


class AdamState(NamedTuple):
    count: torch.Tensor  # 0-d int32
    mu: Vars
    nu: Vars


class Adam:
    """optax ``adam(lr)``, after ``clip_by_global_norm(clip)`` when
    ``clip > 0``."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, clip: float = 0.0):
        self.lr, self.b1, self.b2, self.eps, self.clip = lr, b1, b2, eps, clip

    def init(self, params: Vars) -> AdamState:
        dev = next(iter(params.values())).device
        zeros = {k: torch.zeros_like(v) for k, v in params.items()}
        return AdamState(torch.zeros((), dtype=torch.int32, device=dev),
                         zeros, {k: v.clone() for k, v in zeros.items()})

    def update(self, grads: Vars, state: AdamState):
        if self.clip > 0:
            norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
            keep = norm < self.clip
            grads = {k: torch.where(keep, g, g / norm.to(g.dtype) * self.clip)
                     for k, g in grads.items()}
        b1, b2 = self.b1, self.b2
        mu = {k: (1 - b1) * g + b1 * state.mu[k] for k, g in grads.items()}
        nu = {k: (1 - b2) * g ** 2 + b2 * state.nu[k]
              for k, g in grads.items()}
        count = state.count + 1
        # optax takes decay ** count in f32.
        cf = count.to(torch.float32)
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32, device=cf.device) ** cf
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32, device=cf.device) ** cf
        upd = {}
        for k in grads:
            m_hat = mu[k] / bc1.to(mu[k].dtype)
            v_hat = nu[k] / bc2.to(nu[k].dtype)
            upd[k] = -self.lr * (m_hat / (torch.sqrt(v_hat) + self.eps))
        return upd, AdamState(count, mu, nu)


class Frozen:
    """optax ``set_to_zero``: zero updates, an empty state."""

    def init(self, params: Vars):
        return ()

    def update(self, grads: Vars, state):
        return {k: torch.zeros_like(g) for k, g in grads.items()}, state


def apply_updates(variables: Vars, updates: Vars) -> Vars:
    """optax ``apply_updates`` on the entries with updates; the others
    pass through."""
    return {k: (v + updates[k].to(v.dtype) if k in updates else v)
            for k, v in variables.items()}


def macarons_optimizer(depth_lr: float = 1e-4, scone_lr: float = 1e-4,
                       freeze_depth: bool = False,
                       freeze_scone: bool = False):
    """Per-module optimizers with freeze flags (MacaronsOptimizer analog):
    (depth optimizer, scone optimizer)."""
    def make(lr, frozen):
        return Frozen() if frozen else Adam(lr)

    return make(depth_lr, freeze_depth), make(scone_lr, freeze_scone)
