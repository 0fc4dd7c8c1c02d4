"""Epoch driver of NBP training (port of
``nextbestpath_tpu/train/driver.py::run_training_nbp``, the host-loop
trainer).

Epoch 0 only collects rollouts and moves the validation split out of the
replay store; each later epoch collects, then trains (``train_nbp``).
Checkpoints, written by ``utils/checkpoint.py`` in the JAX package's format:
``{tag}_best_val.ckpt`` whenever the validation loss improves and
``{tag}_epoch_{n}.ckpt`` every ``save_model_every_n_epoch`` epochs; the
loss log is ``{log_dir}/{tag}_loss.json``. The fully-jitted scan trainer
(``run_training_nbp_scan``) and the data-parallel one are not ported.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional, Sequence

import torch

from ..assets.scene_assets import SceneAssets
from ..config import Params, default_params
from ..device import DeviceLike, resolve_device
from ..models.unet import NBP
from ..utils.checkpoint import save_nbp
from .collection import collect_trajectory
from .replay import ReplayDB
from .train_nbp import TrainState, init_train_state, train_nbp


def seeded_train_model(seed: int, width: int = 64) -> NBP:
    """A fresh f32 ``NBP`` with torch's default initialisation from
    ``seed`` (the distribution of the JAX module's torch-style init; the
    global RNG is left as it was)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return NBP(width=width)


def run_training_nbp(
    scenes: Sequence[SceneAssets],
    params: Optional[Params] = None,
    epochs: int = 100,
    n_poses: int = 100,
    db_path: Optional[str] = None,
    weights_dir: str = "weights/nbp",
    log_dir: str = "training_log",
    model_tag: str = "nbp",
    seed: int = 8,
    verbose: bool = True,
    device: DeviceLike = "cuda",
    model: Optional[NBP] = None,
) -> TrainState:
    """Train an NBP (``model``, default ``seeded_train_model(seed)``) on
    ``scenes`` for ``epochs`` epochs of one ``n_poses`` rollout a scene.
    db_path: the replay store's npz, loaded if present and saved every
    epoch. Returns the final TrainState."""
    dev = resolve_device(device)
    p = params or default_params()
    model = (model if model is not None else seeded_train_model(seed)).to(dev)
    state = init_train_state(model, lr=float(p.nbp_lr))
    db = ReplayDB(db_path)
    validation_data: List = []
    best_val = float("inf")
    log = {"train": [], "val": [], "coverage_after_trajectory": []}

    for epoch in range(epochs):
        t0 = time.time()
        if verbose:
            print(f"=== epoch {epoch} ===")
        for i, assets in enumerate(scenes):
            cov = collect_trajectory(
                assets, state.model, db, params=p,
                seed=seed * 1000 + epoch * len(scenes) + i,
                n_poses=n_poses, verbose=False, device=dev)
            log["coverage_after_trajectory"].append(cov[-1] if cov else 0.0)
            if verbose:
                print(f"  collected {assets.name}: final coverage "
                      f"{cov[-1] if cov else 0:.4f}, db size {len(db)}")

        if epoch == 0:
            validation_data = db.extract_validation(num=1200)
            if verbose:
                print(f"  validation split: {len(validation_data)} entries")
        else:
            state, tl, vl = train_nbp(state, db, validation_data,
                                      current_epoch=epoch, params=p,
                                      seed=seed * 131 + epoch,
                                      verbose=verbose)
            log["train"].append(tl)
            log["val"].append(vl)
            if vl < best_val:
                best_val = vl
                save_nbp(os.path.join(weights_dir,
                                      f"{model_tag}_best_val.ckpt"),
                         state.model, epoch=epoch)
            if epoch % int(p.save_model_every_n_epoch) == 0:
                save_nbp(os.path.join(weights_dir,
                                      f"{model_tag}_epoch_{epoch}.ckpt"),
                         state.model, epoch=epoch)
            os.makedirs(log_dir, exist_ok=True)
            with open(os.path.join(log_dir, f"{model_tag}_loss.json"),
                      "w") as f:
                json.dump(log, f)
        if db_path:
            db.save()
        if verbose:
            print(f"  epoch wall time {time.time() - t0:.1f}s")
    return state
