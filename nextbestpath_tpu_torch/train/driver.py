"""Epoch drivers of NBP training (port of
``nextbestpath_tpu/train/driver.py``).

``run_training_nbp``, the host-loop trainer: epoch 0 only collects
rollouts and moves the validation split out of the replay store; each
later epoch collects, then trains (``train_nbp``). Checkpoints, written by
``utils/checkpoint.py`` in the JAX package's format: ``{tag}_best_val.ckpt``
whenever the validation loss improves and ``{tag}_epoch_{n}.ckpt`` every
``save_model_every_n_epoch`` epochs; the loss log is
``{log_dir}/{tag}_loss.json``.

``run_training_nbp_scan``, the production trainer: the same recipe with
the device-resident collection (``train/scan_collection.py``, one capture
for every same-lattice scene), a bf16 U-Net, held-out rollout evaluation
(``BatchedScanRollout``) that selects ``{tag}_best_auc.ckpt``, a
``{tag}_latest.ckpt`` with the optimizer state after every epoch, replay
shards a collection epoch in ``db_dir``, resume from both, a warm start
from a checkpoint's variables and a wall-clock budget.

``run_training_nbp_dp``, the data-parallel trainer over ranks
(``parallel/``): collection one scene a rank, training with every micro
batch split over the ranks, held-out evaluation one scene a rank.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..assets.scene_assets import SceneAssets
from ..config import Params, default_params
from ..device import DeviceLike, resolve_device
from ..models.convert import flax_to_state_dict, state_dict_to_flax
from ..models.unet import NBP
from ..utils.checkpoint import (load_checkpoint, load_nbp, save_checkpoint,
                                save_nbp)
from .collection import collect_trajectory
from .replay import ReplayDB
from .train_nbp import (TrainState, init_train_state, opt_state_from_flax,
                        opt_state_to_flax, set_lr, train_nbp)

RESUME_MIN_LR = 1e-4
EVAL_SEEDS = (999, 1999)


def seeded_train_model(seed: int, width: int = 64,
                       dtype: torch.dtype = torch.float32) -> NBP:
    """A fresh ``NBP`` (computing in ``dtype``) with torch's default
    initialisation from ``seed`` (the distribution of the JAX module's
    torch-style init; the global RNG is left as it was)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return NBP(width=width, dtype=dtype)


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


def _gain_stats(epoch: int, gains: np.ndarray) -> dict:
    return {"epoch": epoch, "n_labels": int(gains.size),
            "mean": round(float(gains.mean()), 4),
            "p50": round(float(np.percentile(gains, 50)), 4),
            "p90": round(float(np.percentile(gains, 90)), 4),
            "max": round(float(gains.max()), 4),
            "frac_zero": round(float((gains == 0).mean()), 4)}


def _delete_stale_shards(db_dir: str, epoch: int, verbose: bool) -> None:
    """Shards of epochs after the checkpoint's are a longer earlier run's
    leftovers (or an epoch whose checkpoint never landed): delete them."""
    if not os.path.isdir(db_dir):
        return
    for fname in sorted(os.listdir(db_dir)):
        if not (fname.startswith("epoch_") and fname.endswith(".npz")):
            continue
        try:
            shard_epoch = int(fname[len("epoch_"):-len(".npz")])
        except ValueError:
            continue
        if shard_epoch > epoch:
            os.remove(os.path.join(db_dir, fname))
            if verbose:
                print(f"resume: deleted stale shard {fname} "
                      f"(> checkpoint epoch {epoch})")


def run_training_nbp_scan(
    scenes: Sequence[SceneAssets],
    eval_scenes: Optional[Sequence[SceneAssets]] = None,
    params: Optional[Params] = None,
    epochs: int = 100,
    n_poses: int = 100,
    db_dir: Optional[str] = None,
    weights_dir: str = "weights/nbp",
    log_dir: str = "training_log",
    model_tag: str = "nbp",
    seed: int = 8,
    verbose: bool = True,
    resume: bool = False,
    eval_every: int = 3,
    eval_poses: int = 40,
    max_wall_s: Optional[float] = None,
    init_from: Optional[str] = None,
    device: DeviceLike = "cuda",
    model: Optional[NBP] = None,
    make_draws=None,
    make_eval_draws=None,
) -> TrainState:
    """Train an NBP (``model``, default the bf16 ``seeded_train_model(seed)``)
    on same-lattice ``scenes`` (``pad_assets_to_common``) with the scan
    collection; ``eval_scenes`` (same-lattice, held out) are rolled out for
    ``eval_poses`` poses at seeds 999 and 1999 every ``eval_every`` epochs
    (from epoch 1), the best mean AUC kept as ``{tag}_best_auc.ckpt``.

    resume: restart from ``{tag}_latest.ckpt`` (its variables, optimizer
    state, learning rate clamped to at least 1e-4, best losses) and the
    shards of ``db_dir`` up to its epoch (later ones are deleted); raises
    ValueError without ``db_dir``, without the saved validation split, or
    when the checkpoint holds no optimizer state. init_from: a checkpoint
    whose variables seed a fresh run (ignored when absent or when a resume
    happens). max_wall_s: stop after the epoch that passes it.
    make_draws / make_eval_draws: seed -> the provider of a collection's /
    an evaluation rollout's draws (default ``TorchDraws``; the tests inject
    the JAX key schedules). Returns the final TrainState."""
    from ..eval.scan_rollout import BatchedScanRollout
    from .scan_collection import ScanCollection, collect_trajectory_scan

    dev = resolve_device(device)
    p = params or default_params()
    model = (model if model is not None
             else seeded_train_model(seed, dtype=torch.bfloat16)).to(dev)
    state = init_train_state(model, lr=float(p.nbp_lr))
    if init_from and os.path.exists(init_from):
        ck_epoch, _ = load_nbp(init_from, model)
        if verbose:
            print(f"warm start from {init_from} (saved at epoch {ck_epoch})")
    collection = ScanCollection(scenes, model, params=p,
                                make_draws=make_draws, device=dev)
    evaluator = (BatchedScanRollout(eval_scenes, model, params=p,
                                    make_draws=make_eval_draws, device=dev)
                 if eval_scenes else None)

    db = ReplayDB()
    validation_data: List = []
    best_val = float("inf")
    best_auc = float("-inf")
    start_epoch = 0
    db_high_water = 0
    log = {"train": [], "val": [], "coverage_after_trajectory": [],
           "eval_auc": []}
    latest_path = os.path.join(weights_dir, f"{model_tag}_latest.ckpt")
    val_path = os.path.join(db_dir, "validation.npz") if db_dir else None
    log_path = os.path.join(log_dir, f"{model_tag}_loss.json")

    if resume and os.path.exists(latest_path):
        variables, opt_tree, epoch, extra = load_checkpoint(latest_path)
        if opt_tree is None:
            raise ValueError(
                f"{latest_path} has no optimizer state: it was saved "
                "variables-only (best-val style) and cannot seed a resume; "
                "use init_from/--init-weights to warm-start instead")
        with torch.no_grad():
            model.load_state_dict(flax_to_state_dict(
                variables["params"], variables["batch_stats"]), strict=True)
        opt_state_from_flax(opt_tree, state)
        set_lr(state, max(float(extra.get("lr", state.lr)), RESUME_MIN_LR))
        best_val = float(extra.get("best_val", best_val))
        best_auc = float(extra.get("best_auc", best_auc))
        start_epoch = int(epoch) + 1
        if not db_dir:
            raise ValueError(
                "resume=True needs db_dir: resuming past epoch 0 with an "
                "empty replay DB cannot train")
        _delete_stale_shards(db_dir, int(epoch), verbose)
        db_high_water = db.load_dir(db_dir, max_epoch=int(epoch))
        if not os.path.exists(val_path):
            raise ValueError(
                f"resume=True but the validation split {val_path} is "
                "missing: an empty validation set returns loss 0.0 and "
                "would clobber the best-val checkpoint every epoch")
        val_db = ReplayDB()
        val_db.load(val_path)
        validation_data = val_db.entries
        if os.path.exists(log_path):
            with open(log_path) as f:
                prev = json.load(f)
            for k in log:
                log[k] = prev.get(k, [])
        if verbose:
            print(f"resumed from {latest_path}: epoch {start_epoch}, "
                  f"db {len(db)}, val {len(validation_data)}, "
                  f"lr {state.lr:.2e}, best_val {best_val:.4f}")

    t_start = time.time()
    db_stat_mark = len(db.entries)
    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        if verbose:
            print(f"=== epoch {epoch} ===", flush=True)
        for i in range(len(scenes)):
            cov = collect_trajectory_scan(
                collection, i, state.model, db,
                seed=seed * 1000 + epoch * len(scenes) + i, n_poses=n_poses)
            log["coverage_after_trajectory"].append(cov[-1] if cov else 0.0)
            if verbose:
                print(f"  collected {scenes[i].name}: {len(cov)} poses, "
                      f"final coverage {cov[-1] if cov else 0:.4f}, "
                      f"db size {len(db)}", flush=True)

        # Value-target statistics of the epoch's new labels.
        new = db.entries[db_stat_mark:]
        db_stat_mark = len(db.entries)
        if new:
            gstats = _gain_stats(epoch, np.concatenate([e.gains for e in new]))
            log.setdefault("gain_stats", []).append(gstats)
            if verbose:
                print(f"  gain stats: {gstats}", flush=True)

        if epoch == 0:
            validation_data = db.extract_validation(num=1200)
            db_stat_mark = len(db.entries)
            if val_path:
                db.save_entries(val_path, validation_data)
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

        if db_dir:
            db_high_water = db.save_epoch(db_dir, epoch, db_high_water)

        if evaluator is not None and epoch > 0 and epoch % eval_every == 0:
            # Checkpoints are selected on held-out rollout AUC, which the
            # validation loss does not track (JAX driver.py:287-293).
            per_seed = [[r.auc for r in evaluator.run(
                n_poses=eval_poses, seed=s, variables=state.model)]
                for s in EVAL_SEEDS]
            mean_per_scene = np.mean(np.asarray(per_seed), axis=0)
            aucs = {a.name: round(float(m), 4)
                    for a, m in zip(eval_scenes, mean_per_scene)}
            mean_auc = float(mean_per_scene.mean())
            log["eval_auc"].append({"epoch": epoch, "auc": aucs,
                                    "mean": round(mean_auc, 4)})
            if verbose:
                print(f"  eval AUC @ {eval_poses} poses (2 seeds): {aucs} "
                      f"mean {mean_auc:.4f}", flush=True)
            if mean_auc > best_auc:
                best_auc = mean_auc
                save_nbp(os.path.join(weights_dir,
                                      f"{model_tag}_best_auc.ckpt"),
                         state.model, epoch=epoch,
                         extra={"mean_auc": mean_auc})

        params_tree, stats_tree = state_dict_to_flax(state.model.state_dict())
        save_checkpoint(latest_path,
                        {"params": params_tree, "batch_stats": stats_tree},
                        opt_state=opt_state_to_flax(state), epoch=epoch,
                        extra={"lr": state.lr, "best_val": best_val,
                               "best_auc": best_auc})
        os.makedirs(log_dir, exist_ok=True)
        with open(log_path, "w") as f:
            json.dump(log, f)
        if verbose:
            print(f"  epoch wall time {time.time() - t0:.1f}s", flush=True)
        if max_wall_s is not None and time.time() - t_start > max_wall_s:
            if verbose:
                print(f"wall-clock budget reached after epoch {epoch}; "
                      "resume with resume=True", flush=True)
            break
    return state


def run_training_nbp_dp(
    scenes: Sequence[SceneAssets],
    mesh,
    eval_scenes: Optional[Sequence[SceneAssets]] = None,
    params: Optional[Params] = None,
    epochs: int = 10,
    n_poses: int = 100,
    weights_dir: str = "weights/nbp",
    log_dir: str = "training_log",
    model_tag: str = "nbp_dp",
    seed: int = 8,
    verbose: bool = True,
    model: Optional[NBP] = None,
    db: Optional[ReplayDB] = None,
) -> TrainState:
    """Data-parallel NBP training on the ranks of ``mesh``
    (``parallel/mesh.py``), called on every rank with the same arguments
    (JAX ``run_training_nbp_dp``, the reference's DDP trainer,
    macarons_utils.py:177-326 and train_nbp_model.py:40-158).

    ``scenes`` (same-lattice, a multiple of the ranks) are collected in
    groups of W, one scene a rank (``ShardedScanCollection``; group g's
    scene r from seed ``seed * 1000 + epoch * len(scenes) + g * W + r``),
    into a replay store that is the same on every rank. Epoch 0 moves the
    validation split out; later epochs train with ``train_nbp_dp`` and,
    with ``eval_scenes`` (one a rank), score them with a
    ``ShardedScanRollout`` of ``min(n_poses, 40)`` poses from seed 999.
    Rank 0 alone writes ``{tag}_best_val.ckpt`` and the loss JSON; the
    ranks meet at a barrier after. ``model``: default the bf16
    ``seeded_train_model(seed)``; rank 0's weights are broadcast to every
    rank first. db: the replay store to fill (default a
    new one), which the caller can read or save after the run. Returns the
    final TrainState, the same on every rank."""
    import torch.distributed as dist

    from ..parallel.dp import train_nbp_dp
    from ..parallel.mesh import replicate
    from ..parallel.spmd import ShardedScanCollection, ShardedScanRollout

    p = params or default_params()
    W = mesh.size
    if len(scenes) % W:
        raise ValueError(
            f"scene count {len(scenes)} must be a multiple of the ranks {W} "
            "(one scene a rank a collection)")
    model = (model if model is not None
             else seeded_train_model(seed, dtype=torch.bfloat16)
             ).to(mesh.device)
    replicate(list(model.parameters()) + list(model.buffers()), mesh)
    state = init_train_state(model, lr=float(p.nbp_lr))
    groups = [list(scenes[i:i + W]) for i in range(0, len(scenes), W)]
    collections = [ShardedScanCollection(g, model, mesh, params=p)
                   for g in groups]
    evaluator = (ShardedScanRollout(eval_scenes, model, mesh, params=p)
                 if eval_scenes else None)
    lead = mesh.rank == 0
    say = verbose and lead

    db = db if db is not None else ReplayDB()
    validation_data: List = []
    best_val = float("inf")
    log = {"train": [], "val": [], "coverage_after_trajectory": [],
           "eval_auc": []}
    for epoch in range(epochs):
        t0 = time.time()
        if say:
            print(f"=== [dp x{W}] epoch {epoch} ===", flush=True)
        for gi, col in enumerate(collections):
            covs = col.collect_all(
                state.model, db,
                seed=seed * 1000 + epoch * len(scenes) + gi * W,
                n_poses=n_poses)
            for s, cov in enumerate(covs):
                log["coverage_after_trajectory"].append(
                    cov[-1] if cov else 0.0)
                if say:
                    print(f"  collected {groups[gi][s].name}: {len(cov)} "
                          f"poses, final coverage "
                          f"{cov[-1] if cov else 0:.4f}, db {len(db)}",
                          flush=True)

        if epoch == 0:
            validation_data = db.extract_validation(num=1200)
            if say:
                print(f"  validation split: {len(validation_data)} entries")
        else:
            state, tl, vl = train_nbp_dp(
                state, db, validation_data, current_epoch=epoch, mesh=mesh,
                params=p, seed=seed * 131 + epoch, verbose=verbose)
            log["train"].append(tl)
            log["val"].append(vl)
            if vl < best_val:
                best_val = vl
                if lead:
                    save_nbp(os.path.join(weights_dir,
                                          f"{model_tag}_best_val.ckpt"),
                             state.model, epoch=epoch)

        if evaluator is not None and epoch > 0:
            results = evaluator.run(n_poses=min(n_poses, 40), seed=999,
                                    variables=state.model)
            aucs = {a.name: round(r.auc, 4)
                    for a, r in zip(eval_scenes, results)}
            log["eval_auc"].append({"epoch": epoch, "auc": aucs})
            if say:
                print(f"  eval AUC: {aucs}", flush=True)

        if lead:
            os.makedirs(log_dir, exist_ok=True)
            with open(os.path.join(log_dir, f"{model_tag}_loss.json"),
                      "w") as f:
                json.dump(log, f)
        dist.barrier(group=mesh.group)
        if say:
            print(f"  epoch wall time {time.time() - t0:.1f}s", flush=True)
    return state
