"""The multi-process dry run and the rank bodies of the parallel checks.

``dryrun_multichip(n, device, backend)`` is the port of the JAX package's
``__graft_entry__.py::dryrun_multichip``: as one spawned job of n ranks
(``parallel/launch.py``) it runs the four checks of
``_dryrun_multichip_impl``: the DP train step, the loss and gradient of n
ranks against one process on the same global batch, the sharded rollout
against single rollouts of the same scenes, and the sharded collection.
The JAX function re-executes itself in a clean CPU process with n virtual
devices; here the ranks are processes, on the CPU (gloo) or on cards.

Every other function here is a rank body, ``fn(mesh, ...)``, spawned by
the tests (``tests/test_torch_parallel.py``) and ``chip_smoke.py``: spawn
imports a rank body by its module path, so none can live in a test module
or a script's ``__main__``. Each returns host objects.

    python -m nextbestpath_tpu_torch.parallel.dryrun --ranks 4 --device cpu
"""

from __future__ import annotations

import argparse
import copy
import hashlib
import json
import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import kernels
from ..assets import generate_scene, pack_generated_scene, pad_assets_to_common
from ..config import default_params
from ..eval.heldout import held_out_seed
from ..eval.nbp_planning import seeded_nbp
from ..eval.scan_rollout import (ScanRollout, common_sizes, pad_scene_arrays,
                                 scene_arrays_from_assets)
from ..models.convert import flax_to_state_dict, state_dict_to_flax
from ..models.unet import NBP, BatchNorm, as_float64, batch_norm_group
from ..train.driver import run_training_nbp_dp, seeded_train_model
from ..train.replay import Experience, ReplayDB
from ..train.scan_collection import ScanCollection, collect_trajectory_scan
from ..train.train_nbp import (_micro_chunks, _train_step_ds,
                               build_device_dataset, init_train_state,
                               train_nbp)
from .dp import dp_grad_parity, dp_step, dp_train_demo, train_nbp_dp
from .launch import spawn
from .mesh import Mesh, local_block, same_on_all_ranks
from .multihost import reduce_mean
from .spmd import ShardedScanCollection, ShardedScanRollout, gather

# The dry run's scene config (JAX ``dp_rollout_demo``): small frames and
# buffers, the reference's 64x64 model input.
DRYRUN_PARAMS = dict(image_height=64, image_width=114, points_per_frame=512,
                     full_pc_capacity=65536, n_gt_surface_points=2048,
                     pc2img_size=[64, 64], value_map_size=[16, 16])
# The JAX dry run's gradient-parity thresholds (f32; reduction order alone
# moves the loss by about 1e-6).
PARITY_LOSS_REL, PARITY_NORM_REL, PARITY_COSINE = 1e-4, 1e-3, 0.9999


def procgen_scenes(specs: Sequence, params_kw: Dict) -> list:
    """Packed procgen scenes ``[(difficulty, seed), ...]`` under
    ``default_params(**params_kw)``, padded to a common lattice."""
    p = default_params(**params_kw)
    return pad_assets_to_common([
        pack_generated_scene(generate_scene(d, seed=s), params=p)
        for d, s in specs])


# -- the dry run -------------------------------------------------------------

def single_rollouts(assets_list, model: NBP, params, device, n_poses: int,
                    seed: int, only: Optional[Sequence[int]] = None) -> list:
    """Scene i's ``ScanRollout`` from seed + i, for each i of ``only``
    (default every scene) one after another, each on its scene padded to
    the list's common sizes: what a sharded rollout of the list must
    give."""
    f_max, g_max = common_sizes(assets_list)
    out = []
    for i in range(len(assets_list)) if only is None else only:
        scene = pad_scene_arrays(scene_arrays_from_assets(
            assets_list[i], n_pieces=int(params.n_pieces), device=device),
            f_max, g_max)
        out.append(ScanRollout(assets_list[i], model, params=params,
                               scene=scene, device=device
                               ).run(n_poses=n_poses, seed=seed + i))
    return out


def spread_singles(mesh: Mesh, one) -> list:
    """Every scene's single run, ``one(i)`` for scene i made by rank
    i - 1 (so by another rank than the one that ran it sharded, and the
    ranks share the work), on every rank in scene order."""
    got = gather(one((mesh.rank + 1) % mesh.size), mesh)
    return [got[(i - 1) % mesh.size] for i in range(mesh.size)]


def same_rollouts(a, b) -> bool:
    """Coverage curves, trajectories and point counts equal bit for bit."""
    return len(a) == len(b) and all(
        x.coverage_evolution == y.coverage_evolution
        and np.array_equal(x.cam_positions, y.cam_positions)
        and x.n_points == y.n_points for x, y in zip(a, b))


def dp_rollout_demo(mesh: Mesh, n_poses: int = 2, seed: int = 8,
                    width: int = 8) -> Dict:
    """A sharded rollout over ``simple`` scenes 0..W-1 at the dry run's
    config, and the same scenes' single rollouts (``spread_singles``).
    Returns the sharded results and whether they are equal."""
    params = default_params(**DRYRUN_PARAMS)
    assets = procgen_scenes([("simple", i) for i in range(mesh.size)],
                            DRYRUN_PARAMS)
    model = seeded_nbp(width)
    res = ShardedScanRollout(assets, model, mesh, params=params).run(
        n_poses=n_poses, seed=seed)
    single = spread_singles(mesh, lambda i: single_rollouts(
        assets, model, params, mesh.device, n_poses, seed, only=[i])[0])
    return dict(results=res, same=same_rollouts(res, single))


def db_digest(db: ReplayDB) -> List[str]:
    """A replay store's entries, each as the SHA-256 of its arrays' bytes
    and pose index (equal lists: equal stores, entry for entry)."""
    out = []
    for e in db.entries:
        h = hashlib.sha256()
        for a in (e.model_input, e.gt_layout, e.pixels, e.gains):
            h.update(np.ascontiguousarray(a).tobytes())
        h.update(str(e.pose_i).encode())
        out.append(h.hexdigest())
    return out


def dp_collection_demo(mesh: Mesh, n_poses: int = 2, seed: int = 3,
                       width: int = 8) -> Dict:
    """A sharded collection over ``simple`` scenes 0..W-1 at the dry run's
    config into a replay store. Returns the coverages, the store's size
    and whether it is the same on every rank."""
    params = default_params(**DRYRUN_PARAMS)
    assets = procgen_scenes([("simple", i) for i in range(mesh.size)],
                            DRYRUN_PARAMS)
    model = seeded_nbp(width).to(mesh.device).train()
    db = ReplayDB()
    covs = ShardedScanCollection(assets, model, mesh, params=params
                                 ).collect_all(model, db, seed=seed,
                                               n_poses=n_poses)
    digests = gather(db_digest(db), mesh)
    return dict(coverages=covs, n_db=len(db),
                db_same=all(d == digests[0] for d in digests))


def f32_parity(par: Dict) -> tuple:
    """(loss rel, grad norm rel, within the dry run's f32 thresholds) of
    a ``dp_grad_parity`` result."""
    loss_rel = abs(par["loss_n"] - par["loss_1"]) / max(abs(par["loss_1"]),
                                                        1e-8)
    norm_rel = abs(par["norm_n"] - par["norm_1"]) / max(par["norm_1"], 1e-30)
    return loss_rel, norm_rel, (loss_rel <= PARITY_LOSS_REL
                                and norm_rel <= PARITY_NORM_REL
                                and par["cosine"] >= PARITY_COSINE)


def dryrun_rank(mesh: Mesh, n_poses: int = 2) -> str:
    """The four checks of the dry run on this rank; raises on a failure.
    Returns the summary line."""
    loss = dp_train_demo(mesh, image_size=64, n_steps=1, verbose=False)
    par = dp_grad_parity(mesh, image_size=64, width=16)
    loss_rel, norm_rel, ok = f32_parity(par)
    if not ok:
        raise AssertionError(
            f"DP gradient parity broken: loss {par['loss_n']!r} vs "
            f"{par['loss_1']!r} (rel {loss_rel:.2e}), grad norm "
            f"{par['norm_n']:.6g} vs {par['norm_1']:.6g} (rel "
            f"{norm_rel:.2e}), cosine {par['cosine']:.6f}")
    roll = dp_rollout_demo(mesh, n_poses=n_poses)
    if not roll["same"]:
        raise AssertionError("the sharded rollout differs from the single "
                             "rollouts of its scenes")
    col = dp_collection_demo(mesh, n_poses=n_poses)
    if not col["db_same"] or col["n_db"] < 1:
        raise AssertionError(f"the sharded collection's replay stores "
                             f"differ across ranks or are empty "
                             f"({col['n_db']} entries)")
    covs = [round(r.coverage_evolution[-1], 4) for r in roll["results"]]
    return (f"dryrun_multichip({mesh.size}) on {mesh.device} "
            f"({mesh.backend}): ok, loss = {loss:.4f} (grad parity: loss rel "
            f"{loss_rel:.2e}, norm rel {norm_rel:.2e}, cosine "
            f"{par['cosine']:.6f}); sharded rollout = single rollouts, final "
            f"coverage {covs}; collection db {col['n_db']} entries, the same "
            "on every rank")


def dryrun_multichip(n_ranks: int, device: str = "cuda",
                     backend: Optional[str] = None,
                     timeout_s: float = 600.0) -> str:
    """The dry run as one job of ``n_ranks`` ranks on ``device`` ("cuda":
    NCCL, one rank a card, unless ``backend="gloo"``; "cpu": gloo).
    Raises on any rank's failure; prints and returns the summary."""
    line = spawn(dryrun_rank, n_ranks, device=device, backend=backend,
                 timeout_s=timeout_s)[0]
    print(line, flush=True)
    return line


# -- rank bodies of the tests ------------------------------------------------

def failing_rank(mesh: Mesh) -> None:
    """Rank 1 raises while rank 0 waits at a barrier (the launcher's
    check of a failing rank)."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()


def sleeping_rank(mesh: Mesh, seconds: float) -> None:
    """Every rank sleeps (the launcher's check of its deadline)."""
    time.sleep(seconds)


def bn_block_rank(mesh: Mesh, x: np.ndarray, weight: np.ndarray,
                  bias: np.ndarray, dy: np.ndarray) -> Dict:
    """A train-mode ``BatchNorm`` over the global batch x (N, C, H, W), f64,
    this rank holding its block: the output and input gradient of its
    block (loss ``sum(y * dy)``), the weight and bias gradients summed
    over the ranks, and the running statistics; and ``reduce_mean`` of
    the rank."""
    bn = BatchNorm(x.shape[1]).double().to(mesh.device).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    xb = local_block(torch.from_numpy(x).to(mesh.device), mesh)
    xb.requires_grad_(True)
    with batch_norm_group(bn, mesh.group):
        y = bn(xb)
    dyb = local_block(torch.from_numpy(dy).to(mesh.device), mesh)
    dx, dw, db = torch.autograd.grad((y * dyb).sum(),
                                     [xb, bn.weight, bn.bias])
    dwb = torch.cat([dw, db])
    dist.all_reduce(dwb)
    c = x.shape[1]
    return dict(y=y.detach().cpu().numpy(), dx=dx.cpu().numpy(),
                dw=dwb[:c].cpu().numpy(), db=dwb[c:].cpu().numpy(),
                mean=bn.running_mean.cpu().numpy(),
                var=bn.running_var.cpu().numpy(),
                rank_mean=float(reduce_mean(torch.tensor(
                    [float(mesh.rank)], device=mesh.device), mesh.group)))


def seeded_entries(n: int, seed: int, size: int, cls=Experience) -> list:
    """``n`` random experiences at ``size`` x ``size`` from a numpy seed:
    an f16 input, a binary layout and 1-5 labelled value pixels each,
    pose indices from 20 on (past epoch 1's cut). ``cls``: the replay entry type (the
    JAX package's for its side of a test)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(1, 6))
        out.append(cls(
            model_input=(rng.random((5, size, size)) * 3).astype(np.float16),
            gt_layout=(rng.random((size, size)) > 0.7).astype(np.uint8),
            pixels=np.stack([rng.integers(0, 8, k),
                             rng.integers(0, size // 4, k),
                             rng.integers(0, size // 4, k)],
                            1).astype(np.int32),
            gains=(rng.random(k) * 5).astype(np.float32),
            pose_i=20 + i))
    return out


def flat_state(model: NBP, stats_only: bool = False) -> np.ndarray:
    """The model's floating-point state (parameters and running
    statistics, or the statistics alone) as one f64 vector."""
    return torch.cat([t.detach().reshape(-1).double().cpu()
                      for k, t in model.state_dict().items()
                      if t.is_floating_point()
                      and (not stats_only or "running" in k)]).numpy()


def train_dp_rank(mesh: Mesh, variables: Dict, entries: List[Experience],
                  validation: List[Experience], current_epoch: int,
                  num_epochs: int, seed: int, f64: bool, width: int,
                  params_kw: Dict, accumulation_steps: int = 7,
                  with_single: bool = False) -> Dict:
    """``train_nbp_dp`` from flax ``variables`` (``{"params",
    "batch_stats"}`` numpy trees) on a replay store of ``entries``:
    (train loss, val loss, parameters and statistics flat, whether they
    are the same bits on every rank), ``accumulation_steps`` micro steps
    an optimizer step; with_single, rank 0 also runs
    ``train_nbp`` (one process) on the same inputs afterwards."""
    params = default_params(**params_kw)

    def fresh():
        m = NBP(width=width)
        m.load_state_dict(flax_to_state_dict(variables["params"],
                                             variables["batch_stats"]))
        if f64:
            as_float64(m)
        return m.to(mesh.device).train()

    def store():
        db = ReplayDB()
        db.entries = list(entries)
        return db

    state = init_train_state(fresh(), lr=1e-3,
                             accumulation_steps=accumulation_steps)
    state, tl, vl = train_nbp_dp(state, store(), validation, current_epoch,
                                 mesh, params=params, num_epochs=num_epochs,
                                 seed=seed, verbose=False)
    out = dict(tl=tl, vl=vl, flat=flat_state(state.model),
               stats=flat_state(state.model, stats_only=True),
               same_bits=same_on_all_ranks(
                   list(state.model.state_dict().values()), mesh))
    if with_single and mesh.rank == 0:
        single = init_train_state(fresh(), lr=1e-3,
                                  accumulation_steps=accumulation_steps)
        single, tl1, vl1 = train_nbp(single, store(), validation,
                                     current_epoch, params=params,
                                     num_epochs=num_epochs, seed=seed,
                                     verbose=False)
        out["single"] = dict(tl=tl1, vl=vl1, flat=flat_state(single.model),
                             stats=flat_state(single.model, stats_only=True))
    return out


def sharded_parity_rank(mesh: Mesh, specs: Sequence, params_kw: Dict,
                        width: int, n_poses: int, seed: int,
                        collect_seed: int) -> Dict:
    """``ShardedScanRollout`` and ``ShardedScanCollection`` over the
    procgen scenes ``specs`` (one a rank), and the same scenes' single
    ``ScanRollout`` runs and single ``ScanCollection`` runs of the padded
    group into a replay store (``spread_singles``). Returns both, and
    whether every rank's sharded store is the same."""
    params = default_params(**params_kw)
    assets = procgen_scenes(specs, params_kw)
    model = seeded_nbp(width).to(mesh.device).train()
    roll = ShardedScanRollout(assets, model, mesh, params=params).run(
        n_poses=n_poses, seed=seed)
    db = ReplayDB()
    covs = ShardedScanCollection(assets, model, mesh, params=params
                                 ).collect_all(model, db, seed=collect_seed,
                                               n_poses=n_poses)
    digest = db_digest(db)
    col = ScanCollection(assets, model, params=params, device=mesh.device)

    def one(i):
        db1 = ReplayDB()
        cov = collect_trajectory_scan(col, i, model, db1,
                                      seed=collect_seed + i, n_poses=n_poses)
        return (single_rollouts(assets, model, params, mesh.device, n_poses,
                                seed, only=[i])[0], cov, db_digest(db1))
    singles = spread_singles(mesh, one)
    return dict(rollout=roll, coverages=covs, db=digest,
                db_same=all(d == digest for d in gather(digest, mesh)),
                single_rollout=[x[0] for x in singles],
                single_coverages=[x[1] for x in singles],
                single_db=[h for x in singles for h in x[2]])


def driver_rank(mesh: Mesh, specs: Sequence, params_kw: Dict, width: int,
                epochs: int, n_poses: int, weights_dir: str, log_dir: str,
                seed: int) -> Dict:
    """``run_training_nbp_dp`` over the procgen scenes ``specs`` with
    NBP(width), into the given directories. Returns the replay store's
    digest and whether the final weights are the same bits on every
    rank."""
    params = default_params(**params_kw)
    db = ReplayDB()
    state = run_training_nbp_dp(
        procgen_scenes(specs, params_kw), mesh, params=params, epochs=epochs,
        n_poses=n_poses, weights_dir=weights_dir, log_dir=log_dir,
        model_tag="dp", seed=seed, verbose=False,
        model=seeded_nbp(width, seed), db=db)
    return dict(db=db_digest(db), same_bits=same_on_all_ranks(
        list(state.model.state_dict().values()), mesh))


# -- the card's phase (``chip_smoke.py`` phase 11) ----------------------------

# The card's checks against one process: phase 8's tolerance (rtol 1e-4 of
# each vector's largest magnitude: f32 losses and running statistics, f64
# parameters), rtol 1e-8 for the f64 loss and gradient of one micro batch.
CARD_RTOL, CARD_RTOL_F64_STEP = 1e-4, 1e-8


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _call_ms(fn, reps: int, warmup: int = 1) -> float:
    """Device ms of one call of ``fn``, from CUDA events over ``reps``
    calls."""
    for _ in range(warmup):
        fn()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def chip_parity_rank(mesh: Mesh) -> Dict:
    """Phase 11 (b) and (c) on this rank: ``dp_grad_parity`` at
    NBP(width=8), 64x64, in f32 (the dry run's thresholds) and f64 (rtol
    1e-8); one ``train_nbp_dp`` cycle (24 seeded 64x64 entries, 3 micro
    steps of 8, one AdamW step) against ``train_nbp`` in one process on
    the same device, in f32 (the training loss and the running
    statistics) and f64 (the losses, parameters and statistics), phase 8's
    tolerance, the weights the same bits on every rank;
    the sharded rollout and collection over ``simple`` 8.. at full width
    (f32, 6 poses) against the scenes' single captured runs, bit for bit.
    Raises on a failure; returns the numbers."""
    out = {}
    for f64 in (False, True):
        par = dp_grad_parity(mesh, image_size=64, width=8, f64=f64)
        loss_rel, _, ok = f32_parity(par)
        grad_rel = _rel(par["grad_n"], par["grad_1"])
        out[f"grad_{'f64' if f64 else 'f32'}"] = dict(
            loss_rel=loss_rel, grad_rel=grad_rel, cosine=par["cosine"])
        if f64:
            ok = max(loss_rel, grad_rel) <= CARD_RTOL_F64_STEP
        if not ok:
            raise AssertionError(f"dp_grad_parity on {mesh.size} ranks "
                                 f"({'f64' if f64 else 'f32'}): {out}")
    params_tree, stats_tree = state_dict_to_flax(
        seeded_train_model(1, width=8).state_dict())
    variables = {"params": params_tree, "batch_stats": stats_tree}
    train, val = seeded_entries(24, 0, 64), seeded_entries(8, 1, 64)
    for f64 in (False, True):
        r = train_dp_rank(mesh, variables, train, val, 2, 1, 0, f64, 8, {},
                          accumulation_steps=3, with_single=True)
        key = f"cycle_{'f64' if f64 else 'f32'}"
        if mesh.rank == 0:
            one = r["single"]
            # In f32 the training loss (its micro steps all come before
            # the cycle's AdamW step) and the running statistics, as phase
            # 8 holds them: Adam's first step moves each weight by about
            # lr times the sign of its gradient, so f32 rounding of a
            # gradient near zero moves the validation loss after it.
            rels = [abs(r["tl"] - one["tl"]) / abs(one["tl"])]
            if f64:
                rels.append(abs(r["vl"] - one["vl"]) / abs(one["vl"]))
            out[key] = dict(
                loss_rel=max(rels),
                state_rel=_rel(r["flat"] if f64 else r["stats"],
                               one["flat"] if f64 else one["stats"]),
                same_bits=r["same_bits"])
            if (max(out[key]["loss_rel"], out[key]["state_rel"]) > CARD_RTOL
                    or not r["same_bits"]):
                raise AssertionError(f"train_nbp_dp on {mesh.size} ranks "
                                     f"against one process: {out[key]}")
    par = sharded_parity_rank(
        mesh, [("simple", 8 + r) for r in range(mesh.size)], {}, 64, 6, 8, 5)
    ok = (same_rollouts(par["rollout"], par["single_rollout"])
          and par["coverages"] == par["single_coverages"]
          and par["db"] == par["single_db"] and par["db_same"])
    out["sharded"] = dict(
        same=ok, n_db=len(par["db"]),
        coverage=[round(x.coverage_evolution[-1], 4)
                  for x in par["rollout"]])
    if not ok:
        raise AssertionError("the sharded rollout or collection differs "
                             "from the single captured runs")
    return out


def chip_dp_rank(mesh: Mesh, entries: Optional[Sequence[Experience]]
                 ) -> Dict:
    """Phase 11 (a) on this rank, NCCL, one rank a card, full width.

    ``run_training_nbp_dp`` with the bf16 ``seeded_train_model`` on procgen
    ``simple`` 8.. (one a rank) for 2 epochs of 16 poses (epoch 1 trains
    on the poses past 10 only, so 16 make it train), held out ``simple``
    scenes from ``eval.heldout`` (one a rank), into a temporary directory, the launch counts set to 0 just before it and
    read just after; then the device ms of a DP micro step of 8 against
    the single-process step on the same 56 entries (``entries``, default
    the driver's store; passes single, DP, DP, single, a warm-up first),
    the ms of a micro step's BatchNorm all-reduces (one forward and one
    backward a layer) and of the gradient bucket's, the ms a collected
    pose and the aggregate collection and evaluation poses/s, and the peak
    memory. Raises on a failure; returns the numbers (rank 0's)."""
    W, dev = mesh.size, mesh.device
    n_poses = 16
    params = default_params()
    scenes = procgen_scenes([("simple", 8 + r) for r in range(W)], {})
    evals = procgen_scenes([("simple", held_out_seed(0, j))
                            for j in range(W)], {})
    tmp = tempfile.mkdtemp(prefix="nbp_dp_")
    out: Dict = {}
    try:
        db = ReplayDB()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        state = run_training_nbp_dp(
            scenes, mesh, eval_scenes=evals, params=params, epochs=2,
            n_poses=n_poses, weights_dir=os.path.join(tmp, "w"),
            log_dir=os.path.join(tmp, "log"), seed=8, verbose=False, db=db,
            model=seeded_train_model(8, dtype=torch.bfloat16))
        torch.cuda.synchronize()
        out["driver_s"] = time.perf_counter() - t0
        out["launches"] = dict(kernels.LAUNCHES)
        out["same_bits"] = same_on_all_ranks(
            list(state.model.state_dict().values()), mesh)
        if mesh.rank == 0:
            out["files"] = sorted(os.listdir(os.path.join(tmp, "w")))
            with open(os.path.join(tmp, "log", "nbp_dp_loss.json")) as f:
                out["log"] = json.load(f)
            losses = out["log"]["train"] + out["log"]["val"]
            if (not out["same_bits"] or not losses
                    or out["files"] != ["nbp_dp_best_val.ckpt"]
                    or not np.all(np.isfinite(losses))
                    or not out["log"]["eval_auc"]):
                raise AssertionError(f"run_training_nbp_dp on {W} ranks: "
                                     f"{out}")

        # Collection and evaluation rates (a warm-up run captures).
        col = ShardedScanCollection(scenes, state.model, mesh, params=params)
        seeds = [1 + r for r in range(W)]
        col.run_all(state.model, seeds, n_poses=2)
        col.run_all(state.model, seeds, n_poses=n_poses)
        out["collect_ms"] = col.wall_time_s / n_poses * 1e3
        out["collect_rate"] = W * n_poses / col.wall_time_s
        ev = ShardedScanRollout(evals, state.model, mesh, params=params)
        ev.run(n_poses=2, seed=1, variables=state.model)
        out["eval_rate"] = ev.run(n_poses=20, seed=999,
                                  variables=state.model)[0].steps_per_sec

        # A DP micro step against the single-process one, same card.
        data = list(entries) if entries else db.entries
        data = (data * (56 // len(data) + 1))[:56]
        ds, _ = build_device_dataset(data, dev)
        model = seeded_train_model(8, dtype=torch.bfloat16).to(dev)
        st_dp = init_train_state(model)
        st_1 = init_train_state(copy.deepcopy(model))
        chunks = list(_micro_chunks(list(range(56)), 8, device=dev))

        def one_pass(dp: bool) -> float:
            """ms a micro step of a pass of 7 (and its AdamW step), timed
            as a whole: a host-bound step shows as it runs, unsynced."""
            def run():
                for idx, sw in chunks:
                    if dp:
                        _train_step_ds(st_dp, ds, idx, sw, dp_step(mesh))
                    else:
                        _train_step_ds(st_1, ds, idx, sw)
            return _call_ms(run, 1, warmup=0) / len(chunks)
        one_pass(False), one_pass(True)
        single = [one_pass(False)]
        dp = [one_pass(True), one_pass(True)]
        single.append(one_pass(False))
        out["micro_single_ms"], out["micro_dp_ms"] = single, dp

        # The collectives of a micro step alone.
        bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
        bufs = [torch.zeros(2 * bn.num_features + 1, device=dev)
                for bn in bns]

        def bn_round():
            for b in bufs + bufs[::-1]:
                dist.all_reduce(b)
        n_params = sum(q.numel() for q in model.parameters())
        bucket = torch.zeros(n_params + 1, device=dev)
        out["n_bn"], out["n_params"] = len(bns), n_params
        out["bn_all_reduce_ms"] = _call_ms(bn_round, 5, warmup=2)
        out["grad_all_reduce_ms"] = _call_ms(
            lambda: dist.all_reduce(bucket), 5, warmup=2)
        out["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def chip_phase(entries: Optional[Sequence[Experience]], n_cards: int,
               timeout_s: float = 600.0) -> Dict:
    """Phase 11: (a) ``chip_dp_rank`` under NCCL on ``n_cards`` cards,
    (b) ``chip_parity_rank`` on 2 gloo ranks sharing card 0, and, with 2
    or more cards, (c) ``chip_parity_rank`` under NCCL on every card.
    The card's kernel library must be built (``kernels.build``) first.
    Returns rank 0's results of each."""
    out = dict(
        a=spawn(chip_dp_rank, n_cards, device="cuda", backend="nccl",
                args=(entries,), timeout_s=timeout_s)[0],
        b=spawn(chip_parity_rank, 2, device="cuda:0", backend="gloo",
                timeout_s=timeout_s)[0])
    if n_cards >= 2:
        out["c"] = spawn(chip_parity_rank, n_cards, device="cuda",
                         backend="nccl", timeout_s=timeout_s)[0]
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    ap.add_argument("--timeout", type=float, default=600.0)
    a = ap.parse_args(argv)
    dryrun_multichip(a.ranks, device=a.device, backend=a.backend,
                     timeout_s=a.timeout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
