#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nextbestpath_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. the device, and the card's name and power limit from nvidia-smi;
2. the build: one nvcc call compiles csrc/*.cu into one library;
3. each kernel (K1 pinhole ray cast, K2 general ray cast, K3 running-min
   distance) against its plain PyTorch version on the card, bit for bit,
   at the shapes the planning rollout gives it (K1 at one frame and at a
   move's four frames in one launch; K2 at the scene tables in one launch,
   the inside test alone, the ``insane`` scene's tables and a frame's rays,
   with the lanes a ray it takes and its time at zero triangles; K3 at
   full, partial and zero counts; the planner kernels nbp_bfs_field and
   nbp_extract_path at the main path's lattice and a 58x58 maze),
   with its time, its plain version's time, a library call's time where
   one computes the same function, the least time the card could take for
   the same work, and that work's time at one instruction an operation
   (the kernels round each product and sum alone, so no FMA);
4. the main path (``eval.nbp_planning.main_path_setup``): the NBP planning
   rollout on the ``simple`` scene (seed 8) with the default config (256x456
   frames, 6144 points a frame, 2M point capacity, 20000 GT points) and a
   full-width NBP U-Net in f32 with random weights from a seed. Launch counts
   are set to 0 just before it and read just after; every kernel must have
   run, K1 once for the initial move and twice a pose (the loop-start frame,
   then the move's four frames in one launch), K2 once (the scene's tables),
   K3 once a pose, and coverage must rise;
5. a reference check: a small rollout on the card against the same rollout
   on the CPU (plain versions), with the same draws and weights;
6. the device-resident scan rollout (``eval.scan_rollout.ScanRollout``) on
   the main path: its pose step captured as CUDA graphs, then 6 poses
   replayed with one host read a pose. Launch counts are set to 0 just
   before its construction and read after the warm-up and after the run:
   K2 once (the scene), then a pose K1 twice and K3 once, and the planner
   kernels (``nbp_bfs_field``, ``nbp_extract_path``) max_plan_retries times
   each on regeneration poses only, which alone replay the U-Net; coverage
   must rise. Then a small scan rollout captured against the same rollout
   run eagerly on the card (bit for bit) and on the CPU (within 1e-3, the
   same trajectory);
7. the evaluation CLI's path (``eval.nbp_planning.test_nbp_planning``,
   what ``test_nbp_planning_torch.py`` runs) over two held-out scenes
   (``eval.heldout``: simple and normal, scene 0) at full width, 6 poses
   each, in the legacy mode (sequential draws, the argsort sampler of the
   metric) with the bf16 U-Net (seeded weights, ``final2`` bias -4), counts
   set to 0 just before and read just after: K2 once a scene, K1 1 + 2 a
   pose, K3 once a pose, coverage rising in each scene. Then a checkpoint
   round trip of the full-width NBP (the port's writer and reader: the
   state_dict and the bf16 forward equal bit for bit); the bf16 forward
   against the f32 one of the same weights at 256x256x5 (within 0.05 on
   both maps) with the U-Net's device time in f32 and bf16, folded and
   not; the legacy host rollout's ms a pose on the main path in f32 and
   bf16; the scan rollout with the stratified draw and the batched capture
   at phase 5's small config (captured equal to eager bit for bit, eager
   within 1e-3 of the CPU); and the random-walk baseline at full width for
   6 poses, counts set to 0 just before it (K2 once, K1 1 + 1 a pose, K3
   once a pose).

8. training on the card (``train/``, what ``train_nbp_torch.py`` runs):
   ``collect_trajectory`` on the main path's scene with a seeded
   full-width NBP for 12 poses, counts set to 0 just before it and read
   just after (K2 once, K1 1 + 2 a pose, K3 once a pose, the planner
   kernels once a plan), coverage rising, 256x256 experiences, the U-Net's
   running statistics unmoved; a dataset of 56 of its experiences through
   ``train_epoch_ds`` (7 micro steps of 8, one AdamW step): the parameters
   unchanged through the 7th micro step's forward and changed after it,
   the losses finite, cuDNN's TF32 off in the forward, the backward and
   the optimizer step and the caller's flags back after, with the ms of a
   micro step (forward and backward) and of the optimizer step, steady
   (a second epoch), and the peak memory; one accumulation cycle of
   NBP(width=8) at 64x64 on the card against the CPU (f32: the losses and
   batch statistics, f64: the parameters, within rtol 1e-4); and
   ``run_training_nbp`` for 2 epochs of 8 poses on the main path's scene
   into a temporary directory, its checkpoint read back equal;
9. the scan trainer (``train/scan_collection.py``, ``train/driver.py::
   run_training_nbp_scan``, what ``train_nbp_torch.py --scan`` runs):
   ``ScanCollection`` on the main path's scene with the bf16 folded NBP,
   12 poses as CUDA graphs after a 2-pose warm-up, counts set to 0 just
   before its construction (K2 once, then a pose K1 twice and K3 once, the
   planner kernels once a plan), then the same run eagerly, bit for bit;
   K3 on a padded GT cloud against its plain version, and the masked
   coverage on the card against the CPU, exactly; the bf16 training step at
   full width (7 micro steps of 8) beside phase 8's f32 one; the driver for
   3 epochs of 8 poses on two padded scenes with an eval scene, then a
   resume to a 4th (files, the stale shard deleted, the optimizer's steps
   carried on, the eval AUC logged); and a small collection on the card
   against the CPU's (the same decisions, coverage within 1e-3);
10. several scenes on one card: the true-batch ``BatchedScanRollout`` over
   four padded ``simple`` scenes (seeds 8-11) at full width in f32, 6
   poses after a 2-pose warm-up, counts set to 0 before its construction
   (K2 once a scene, then a pose K1 twice and K3 once for all scenes, the
   planner kernels max_plan_retries times on any-regeneration poses, one
   host read), coverage rising in each scene, captured equal to eager bit
   for bit, and the same trajectories and coverage as four single captured
   ``ScanRollout``s; ``run_interleaved`` over those four, bit for bit
   against their single runs; ``ScanRandomWalk`` over the four scenes as
   one graph a pose with no host read, equal to eager; the aggregate
   poses/s of sequential single runs, ``run_interleaved`` and the true
   batch at B = 4 and 8 for 30 poses with the peak memory; and a small
   true batch of two scenes on the card against the CPU;
11. data parallelism over processes (``parallel/``), each job spawned by
   ``parallel/launch.py`` with a deadline, any rank's failure failing the
   phase: (a) under NCCL, one rank a card on every visible card (1 on a
   one-card machine), ``run_training_nbp_dp`` with the bf16 full-width
   ``seeded_train_model`` on ``simple`` 8.. (one a rank) for 2 epochs of
   16 poses with held-out ``simple`` scenes evaluated by a
   ``ShardedScanRollout``, counts set to 0 just before it and read just
   after on rank 0 (the ``dp`` path: K2, K1, K3 and the planner kernels
   all launched), the weights the same bits on every rank; then the
   device ms of a DP micro step of 8 on phase 9's entries against the
   single-process step in the same process, the ms of a micro step's
   BatchNorm and gradient all-reduces alone, the ms a collected pose, the
   aggregate collection and evaluation poses/s and the peak memory; (b)
   two gloo ranks sharing card 0: the loss and gradient of one micro
   batch (a rank holding only padded rows) against one process in f32
   and f64, one ``train_nbp_dp`` cycle against ``train_nbp`` in f32 and
   f64 (phase 8's tolerance, the weights the same bits on both ranks),
   and the sharded rollout and collection over ``simple`` 8-9 at full
   width equal to the two scenes' single captured runs bit for bit; (c)
   with two or more cards, (b)'s checks under NCCL, one rank a card.

Phase 3 also holds the scene-axis launches (K1, K3 and the planner
kernels over B scenes, one count, lattice, start or goal a scene) against
their plain versions and against stacked single-scene launches, bit for
bit, at B = 4 and 8.

The line before the last lists the kernels as JSON; the last line is the
device JSON. Imports nothing of JAX and reads nothing that git ignores.

    python3 chip_smoke.py --against DIR

also times K2 of another checkout of this repo (its own
``nextbestpath_tpu_torch/kernels.py``, built into its own ``_build/``) at
phase 3's K2 shapes, held to this tree's plain version, in the order DIR,
this tree, this tree, DIR, and prints one JSON line a run and shape.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# Peak rates of one H100 SXM at its full 700 W (NVIDIA data sheet). The
# f32 rate counts an FMA as two operations; the kernels forbid contraction,
# so their ceiling is one instruction an operation, half that rate.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
NO_FMA_OPS = 33.5e12

# Operations per (ray, triangle) or (GT, sample) pair that the function
# needs: K1 three 3-term dots (15), the three sign and range compares of
# det, u and v, the add u + v and its compare (5); K2 the origin difference
# (3), the cross products p = d x e2 and q = s x e1 (18), the dots det, u
# and v (15), |det|, two sign selects, u + v and four compares (8); K3 three
# differences, three squares, two adds and a min. The divisions of the few
# pairs that pass (and K2's t_scaled dot before them) are left out.
OPS_K1, OPS_K2, OPS_K3 = 20, 44, 9

# The planner kernels' integer work, as the functions need it rather than
# as the kernels do it. A distance field needs one relaxation an edge, as a
# frontier BFS does: the edge's flag, the load, the add and the min, four
# operations for each of a node's four incoming edges (16 a node), once;
# the kernel's repeated sweeps (one a level of the start's eccentricity)
# are its own choice. Its bytes: the edge flags and the start read, the
# distances written. A path walk needs, a step, the test of the one
# predecessor it takes: its two coordinates, their four bound compares, the
# edge flag and the distance compare (8 operations), reading that
# predecessor's flag and distance (5 bytes); then it writes the max_len
# path slots and the length and reachability. The H100's int32 peak: 64
# INT32 lanes an SM, an IMAD counted as two operations as the FMA is (H100
# white paper, 33.5 TOPS at 700 W).
OPS_BFS_NODE, OPS_WALK_STEP, BYTES_WALK_STEP = 16, 8, 5
PEAK_INT32_OPS = 33.5e12

TOL_COVERAGE = 1e-3    # small rollout: card vs CPU coverage curve


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float = PEAK_F32_FLOPS):
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ceiling_ms(n_ops: float) -> float:
    return n_ops / NO_FMA_OPS * 1e3


def wall_ms(fn, reps: int) -> float:
    """Host-clock time of one call of ``fn``, synchronized: for plain
    versions that read the card on the host."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def serpentine(L: int, H: int, device):
    """(4, L, H) bool blocked edges of a serpentine maze: one opening a
    row, at alternating ends, so the path winds through every node."""
    import numpy as np
    import torch
    blocked = np.zeros((4, L, H), bool)
    for j in range(H - 1):
        blocked[2, :, j] = True
        blocked[3, :, j + 1] = True
        open_row = (L - 1) if j % 2 == 0 else 0
        blocked[2, open_row, j] = blocked[3, open_row, j + 1] = False
    return torch.from_numpy(blocked).to(device)


def plan_kernel_rows(assets, soa, n_tris, max_len, dev):
    """nbp_bfs_field and nbp_extract_path against their plain versions,
    integer-exact: at the main path's 17x17 lattice (the scene's GT edge
    table as the blocked edges, from the start pose, to the farthest
    reachable node) and at a 58x58 serpentine maze (the procgen ``insane``
    lattice's size) from a corner to the far corner, past max_len. Returns
    the kernels JSON rows at the main path's case."""
    import torch
    from nextbestpath_tpu_torch import kernels
    from nextbestpath_tpu_torch.planning.grid_paths import (
        INF, bfs_distance_field_plain, extract_path_plain)
    from nextbestpath_tpu_torch.sim.tables import build_scene_tables

    tables = build_scene_tables(soa, n_tris,
                                torch.from_numpy(assets.pose_origin).to(dev),
                                assets.pose_l, assets.pose_h)
    start = torch.tensor([int(assets.start_cam_idx[0]), int(assets.start_cam_idx[2])],
                         dtype=torch.int64, device=dev)
    cases = [("main", tables.gt_edge_blocked.contiguous(), start),
             ("maze", serpentine(58, 58, dev), torch.zeros(2, dtype=torch.int64, device=dev))]
    out = {}
    for name, blocked, st in cases:
        L, H = blocked.shape[1], blocked.shape[2]
        dist_k = kernels.bfs_field(blocked, st)
        dist_p = bfs_distance_field_plain(blocked, st, L, H)
        reach = dist_p < INF
        ecc = int(dist_p[reach].max())
        flat = int(torch.argmax(torch.where(reach, dist_p, -1)))
        goal = torch.tensor([flat // H, flat % H], dtype=torch.int64, device=dev)
        path_k, meta_k = kernels.extract_path(dist_k, blocked, goal, max_len)
        path_p, len_p, reach_p = extract_path_plain(dist_p, blocked, goal, L, H, max_len)
        same = (torch.equal(dist_k, dist_p) and torch.equal(path_k, path_p)
                and int(meta_k[0]) == int(len_p) and bool(meta_k[1]) == bool(reach_p))
        log(f"planner kernels ({name}): {L}x{H} lattice, {int(reach.sum())} reachable, "
            f"eccentricity {ecc}, path length {int(len_p)} of {ecc} (max_len {max_len}), "
            f"equal to the plain versions: {same}")
        if not same:
            raise AssertionError(f"the planner kernels disagree with their plain versions ({name})")
        n = L * H
        steps = ecc  # the walk from the farthest node back to the start
        bfs_ops = n * OPS_BFS_NODE
        walk_ops = steps * OPS_WALK_STEP
        out[name] = dict(
            shape=f"{L}x{H} lattice, eccentricity {ecc}, path to the farthest node "
                  f"(max_len {max_len})",
            bfs=dict(ms=kernels.device_ms(lambda: kernels.bfs_field(blocked, st), 50),
                     plain_ms=wall_ms(lambda: bfs_distance_field_plain(blocked, st, L, H), 5),
                     bound=bound_ms(4 * n + 16 + 4 * n, bfs_ops, PEAK_INT32_OPS)),
            walk=dict(ms=kernels.device_ms(
                          lambda: kernels.extract_path(dist_k, blocked, goal, max_len), 50),
                      plain_ms=wall_ms(lambda: extract_path_plain(
                          dist_p, blocked, goal, L, H, max_len), 5),
                      bound=bound_ms(16 + 4 + steps * BYTES_WALK_STEP
                                     + 8 * max_len + 8, walk_ops,
                                     PEAK_INT32_OPS)))
        for k in ("bfs", "walk"):
            r = out[name][k]
            log(f"  {k} ({name}): {r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms, bound "
                f"{r['bound'][0]:.3g} ms by {r['bound'][1]})")
    main = out["main"]
    return [dict(name=name, route="cuda", source="nextbestpath_tpu_torch/csrc/plan.cu",
                 replaces=rep, max_abs_err=0.0, ms=main[k]["ms"],
                 plain_ms=main[k]["plain_ms"], bound_ms=main[k]["bound"][0],
                 bound_by=main[k]["bound"][1], ceiling_ms=None, library_ms=None,
                 shape=main["shape"], maze_ms=out["maze"][k]["ms"])
            for name, k, rep in (
                ("bfs_field", "bfs", "nextbestpath_tpu/planning/grid_paths.py:102 (XLA while_loop)"),
                ("extract_path", "walk", "nextbestpath_tpu/planning/grid_paths.py:160 (XLA while_loop)"))]


def compare_hits(name, got, want, n_rays):
    """Kernel against plain version: hits, counts and indices equal, and t
    equal to the bit (both round each operation alike)."""
    import torch
    t_k, c_k, i_k = got
    t_p, c_p, i_p = want
    hit_k, hit_p = t_k < 3.4e38, t_p < 3.4e38
    both = hit_k & hit_p
    err = float((t_k[both] - t_p[both]).abs().max()) if bool(both.any()) else 0.0
    mism = {"hit": int((hit_k != hit_p).sum()), "count": int((c_k != c_p).sum()),
            "index": int((i_k != i_p).sum())}
    log(f"{name}: rays {n_rays} hits {int(hit_p.sum())} max_abs_err(t) {err:.3e} "
        f"mismatches {mism}")
    if max(mism.values()) > 0 or not torch.equal(t_k, t_p):
        raise AssertionError(f"{name} disagrees with its plain version: {mism}, "
                             f"max abs err of t {err}")
    torch.cuda.synchronize()
    return err


def k2_cases(assets, eye, dirs, znear, zfar):
    """K2's inputs at phase 3: ``tables``, the 7 L H rays of the main path's
    planner tables in the one launch of sim/tables.py::build_scene_tables;
    ``inside``, their first 3 L H, the inside test alone; ``insane``, the
    tables of the procgen ``insane`` scene (seed 8, 58x58 lattice, 2,784
    triangles); ``frame``, the rays ``dirs`` (N, 3) of one frame of the main
    path's move, each with its own copy of ``eye`` (3,) as its origin, in
    (znear, zfar). Dicts of origins, dirs, soa, the triangle count as an int
    (nt) and as a device tensor (n_tris), t_min and t_max."""
    import torch
    from nextbestpath_tpu_torch.assets import generate_scene, pack_generated_scene
    from nextbestpath_tpu_torch.eval.nbp_planning import MAIN_PATH_SEED
    from nextbestpath_tpu_torch.ops.raytrace import tris_to_soa
    from nextbestpath_tpu_torch.planning.grid_paths import lattice_positions
    from nextbestpath_tpu_torch.sim.tables import table_rays

    def tables(name, a, n_rays=None):
        pos = lattice_positions(torch.from_numpy(a.pose_origin).to(dev),
                                a.pose_l, a.pose_h)
        o, d = table_rays(pos)
        return dict(name=name, origins=o[:n_rays].contiguous(),
                    dirs=d[:n_rays].contiguous(),
                    soa=tris_to_soa(torch.from_numpy(a.tris).to(dev)), nt=int(a.n_tris),
                    n_tris=torch.tensor([a.n_tris], dtype=torch.int32, device=dev),
                    t_min=1e-6, t_max=3.4e38)

    dev = dirs.device
    main = tables("tables", assets)
    frame = dict(main, name="frame", origins=eye.expand(dirs.shape[0], 3).contiguous(),
                 dirs=dirs.contiguous(), t_min=znear, t_max=zfar)
    insane = pack_generated_scene(generate_scene("insane", seed=MAIN_PATH_SEED))
    return [main, tables("inside", assets, 3 * assets.pose_l * assets.pose_h),
            tables("insane", insane), frame]


def time_k2_against(tree, cases, plain):
    """K2 of the checkout ``tree`` and of this one at ``cases``, each held to
    ``plain`` (this tree's plain version's results, by case name) and timed
    in the order tree, this, this, tree."""
    import torch
    from nextbestpath_tpu_torch import kernels
    spec = importlib.util.spec_from_file_location(
        "_other_kernels", os.path.join(tree, "nextbestpath_tpu_torch", "kernels.py"))
    other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    other.build()
    for label, kern in ((tree, other), (".", kernels), (".", kernels), (tree, other)):
        for c in cases:
            def run(k=kern, c=c):
                return k.ray_hits(c["origins"], c["dirs"], c["soa"], c["n_tris"],
                                  c["t_min"], c["t_max"])
            if not all(torch.equal(g, w) for g, w in zip(run(), plain[c["name"]])):
                raise AssertionError(f"K2 of {label} disagrees with the plain "
                                     f"version at {c['name']}")
            print(json.dumps(dict(tree=label, shape=c["name"], rays=c["origins"].shape[0],
                                  tris=c["nt"], ms=kernels.device_ms(run, 50))), flush=True)


def small_scan_check(label, s_assets, small):
    """The scan rollout at the small config ``small`` for 8 poses, with one
    CPU generator's draws: captured as graphs it must equal the same step
    run eagerly on the card bit for bit, and the eager run the CPU's within
    TOL_COVERAGE with the same trajectory."""
    import torch
    from nextbestpath_tpu_torch.draws import TorchDraws
    from nextbestpath_tpu_torch.eval.nbp_planning import seeded_nbp
    from nextbestpath_tpu_torch.eval.scan_rollout import ScanRollout

    runs = {}
    for run, d, graphs in (("graphs", "cuda", True), ("eager", "cuda", False),
                           ("cpu", "cpu", False)):
        r = ScanRollout(s_assets, seeded_nbp(), params=small, device=d,
                        draws=TorchDraws(8, torch.device(d), "cpu"))
        r._use_graphs = graphs
        out = r.run(n_poses=8)
        runs[run] = (out, r.regen_poses, r.state.pc.points[:out.n_points].cpu())
    (g, g_regen, g_pts), (e, e_regen, e_pts), (c, c_regen, _) = (
        runs[k] for k in ("graphs", "eager", "cpu"))
    bitwise = (g.coverage_evolution == e.coverage_evolution
               and (g.cam_positions == e.cam_positions).all()
               and g.n_points == e.n_points and torch.equal(g_pts, e_pts)
               and g_regen == e_regen)
    diff = max(abs(a - b) for a, b in zip(e.coverage_evolution, c.coverage_evolution))
    same_path = (e.cam_positions.shape == c.cam_positions.shape
                 and float(abs(e.cam_positions - c.cam_positions).max()) < 1e-4
                 and e.n_points == c.n_points and e_regen == c_regen)
    log(f"{label} (32x56, 8 poses, regeneration {g_regen}): captured "
        f"{g.coverage_evolution} vs eager {e.coverage_evolution}, bit for bit "
        f"{bitwise}; eager vs cpu {c.coverage_evolution}, max diff {diff:.2e}, "
        f"same trajectory {same_path}")
    if not bitwise:
        raise AssertionError(f"{label}: the captured scan rollout differs from the eager one")
    if diff > TOL_COVERAGE or not same_path:
        raise AssertionError(f"{label}: the card's scan rollout disagrees with the CPU's")


def expect_launches(label, got, want):
    for name, k in want.items():
        if got[name] != k:
            raise AssertionError(f"{label}: kernel {name} launched {got[name]} times, "
                                 f"expected {k} ({got})")


def rises(label, cov):
    if not all(c == c and 0.0 <= c <= 1.0 for c in cov) or not max(cov[1:]) > cov[0]:
        raise AssertionError(f"{label}: coverage does not rise: {cov}")


def cli_phase(params, f32_model, small, s_assets, dev):
    """Phase 7 (module docstring). Returns the launches of its two paths by
    kernel: {"cli": ..., "random_walk": ...}."""
    import tempfile

    import torch
    from nextbestpath_tpu_torch import kernels
    from nextbestpath_tpu_torch.config import Params
    from nextbestpath_tpu_torch.eval.heldout import held_out_assets
    from nextbestpath_tpu_torch.eval.nbp_planning import (
        MAIN_PATH_SEED, MAIN_PATH_WARMUP_POSES, NBPPlanningRollout,
        main_path_setup, seeded_nbp, test_nbp_planning)
    from nextbestpath_tpu_torch.eval.random_walk import random_walk_rollout
    from nextbestpath_tpu_torch.models.fold import fold_bn
    from nextbestpath_tpu_torch.utils.checkpoint import load_nbp, save_nbp

    n_poses = 6
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scenes = held_out_assets(params, 1, ("simple", "normal"), pad=False)
    t_scenes = time.perf_counter() - t0
    bf16 = seeded_nbp(dtype=torch.bfloat16).to(dev).eval()
    x = torch.rand(1, 256, 256, 5, generator=torch.Generator().manual_seed(0)).to(dev)
    with torch.no_grad():
        bf16(x)  # cuDNN picks its bf16 algorithms before the counted run
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    kept = []
    results = test_nbp_planning(scenes, bf16, params=params, n_poses=n_poses,
                                seed=MAIN_PATH_SEED, verbose=False, device=dev,
                                rollouts=kept)
    cli = dict(kernels.LAUNCHES)
    log(f"CLI path: test_nbp_planning over {len(scenes)} held-out scenes (made in "
        f"{t_scenes:.2f} s), {n_poses} poses each, legacy mode, bf16 U-Net; launches {cli}")
    for a, roll in zip(scenes, kept):
        r = results[a.name]
        log(f"  {a.name} ({a.n_tris} triangles, lattice {a.pose_l}x{a.pose_h}): "
            f"{r['wall_time_s'] / n_poses * 1e3:.2f} ms/pose, {sum(roll.regen_poses)} of "
            f"{n_poses} poses regenerated, coverage "
            f"{[round(c, 4) for c in r['coverage_evolution']]}, auc {r['auc']:.4f}, "
            f"launches in its run {roll.launches}")
        rises(a.name, r["coverage_evolution"])
        expect_launches(a.name, roll.launches, {"ray_hits_pinhole": 1 + 2 * n_poses,
                                               "ray_hits": 0, "min_sq_dists": n_poses})
    expect_launches("CLI path", cli, {"ray_hits_pinhole": len(scenes) * (1 + 2 * n_poses),
                                      "ray_hits": len(scenes),
                                      "min_sq_dists": len(scenes) * n_poses})

    # The checkpoint round trip of the full-width NBP.
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "nbp.ckpt")
        t0 = time.perf_counter()
        save_nbp(path, bf16, epoch=1, extra={"note": "chip_smoke"})
        t_save = time.perf_counter() - t0
        size = os.path.getsize(path)
        back = seeded_nbp(seed=1, dtype=torch.bfloat16)  # other weights, overwritten
        t0 = time.perf_counter()
        epoch, extra = load_nbp(path, back)
        t_load = time.perf_counter() - t0
    back = back.to(dev).eval()
    same_sd = all(torch.equal(v, back.state_dict()[k]) for k, v in bf16.state_dict().items())
    with torch.no_grad():
        same_out = all(torch.equal(a, b) for a, b in zip(bf16(x), back(x)))
    log(f"checkpoint round trip: {size} bytes, saved in {t_save:.2f} s, loaded in "
        f"{t_load:.2f} s, epoch {epoch}, extra {extra}; state_dict equal {same_sd}, "
        f"bf16 forward equal {same_out}")
    if not (same_sd and same_out and epoch == 1):
        raise AssertionError("the checkpoint round trip changed the model")

    # bf16 against f32, and the U-Net's device time.
    f32 = f32_model.to(dev).eval()
    with torch.no_grad():
        (v32, o32), (v16, o16) = f32(x), bf16(x)
    err_o = float((o16 - o32).abs().max())
    err_v = float((v16 - v32).abs().max())
    rel_v = err_v / float(v32.abs().max())
    log(f"bf16 vs f32 forward (256x256x5): obstacle map max abs err {err_o:.3e}, value map "
        f"{err_v:.3e} ({rel_v:.3e} of max |f32 value| {float(v32.abs().max()):.3e})")
    if not (err_o <= 0.05 and err_v <= 0.05):
        raise AssertionError("the bf16 forward is more than 0.05 from the f32 one")
    unet_ms = {}
    with torch.no_grad():
        for label, m in (("f32", f32), ("bf16", bf16), ("f32 folded", fold_bn(f32)),
                         ("bf16 folded", fold_bn(bf16))):
            unet_ms[label] = kernels.device_ms(lambda m=m: m(x), 20)
    log("U-Net forward device ms (256x256x5, batch 1): "
        + ", ".join(f"{k} {v:.3f}" for k, v in unet_ms.items()))

    # The legacy host rollout on the main path, f32 and bf16.
    _, main_assets, _ = main_path_setup()
    for label, m in (("f32", f32), ("bf16", bf16)):
        NBPPlanningRollout(main_assets, m, params=params, seed=MAIN_PATH_SEED,
                           device=dev).run(n_poses=MAIN_PATH_WARMUP_POSES)
        roll = NBPPlanningRollout(main_assets, m, params=params, seed=MAIN_PATH_SEED,
                                  device=dev)
        res = roll.run(n_poses=n_poses)
        log(f"legacy host rollout, main path, {label}: {res.wall_time_s / n_poses * 1e3:.2f} "
            f"ms/pose, {sum(roll.regen_poses)} of {n_poses} poses regenerated, coverage "
            f"{[round(c, 4) for c in res.coverage_evolution]}")
        rises(f"legacy {label}", res.coverage_evolution)

    # The scan's capture options at phase 5's small config.
    small_scan_check("scan with stratified draw and batched capture", s_assets,
                     Params(dict(small.as_dict(), stratified_sampling=True,
                                 batched_capture=True), flatten=False))

    # The random-walk baseline at full width.
    random_walk_rollout(scenes[0], params=params, n_poses=2, seed=MAIN_PATH_SEED, device=dev)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    res = random_walk_rollout(scenes[0], params=params, n_poses=n_poses,
                              seed=MAIN_PATH_SEED, device=dev)
    walk = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    log(f"random walk {scenes[0].name}, {n_poses} poses: {res.wall_time_s / n_poses * 1e3:.2f} "
        f"ms/pose, coverage {[round(c, 4) for c in res.coverage_evolution]}, auc "
        f"{res.auc:.4f}, points {res.n_points}, launches {walk}")
    rises("random walk", res.coverage_evolution)
    expect_launches("random walk", walk, {"ray_hits_pinhole": 1 + n_poses, "ray_hits": 1,
                                          "min_sq_dists": n_poses})
    log(f"phase 7 peak memory {peak:.0f} MiB")
    return {"cli": cli, "random_walk": walk}


def train_phase(params, assets, dev, smi):
    """Phase 8 (module docstring). Returns the collection's launches by
    kernel."""
    import random
    import tempfile

    import numpy as np
    import torch
    from nextbestpath_tpu_torch import kernels
    from nextbestpath_tpu_torch.draws import TorchDraws
    from nextbestpath_tpu_torch.eval.nbp_planning import MAIN_PATH_SEED, seeded_nbp
    from nextbestpath_tpu_torch.models.unet import NBP, as_float64
    from nextbestpath_tpu_torch.train import train_nbp as TT
    from nextbestpath_tpu_torch.train.collection import collect_trajectory
    from nextbestpath_tpu_torch.train.driver import (run_training_nbp,
                                                     seeded_train_model)
    from nextbestpath_tpu_torch.train.replay import Experience, ReplayDB
    from nextbestpath_tpu_torch.utils.checkpoint import load_nbp

    class CountingDraws(TorchDraws):
        def __init__(self, seed):
            super().__init__(seed, dev)
            self.groups = {}

        def begin_group(self, role):
            self.groups[role] = self.groups.get(role, 0) + 1

    t_phase = time.perf_counter()
    model = seeded_nbp().to(dev)
    # Collection: a 2-pose warm-up (cuDNN's first calls), then 12 poses.
    collect_trajectory(assets, model, ReplayDB(), params=params, seed=1,
                       n_poses=2, device=dev)
    n_poses = 12
    stats0 = {k: b.clone() for k, b in model.named_buffers()}
    db = ReplayDB()
    draws = CountingDraws(MAIN_PATH_SEED)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    cov = collect_trajectory(assets, model, db, params=params, draws=draws,
                             n_poses=n_poses, device=dev)
    torch.cuda.synchronize()
    collect_ms = (time.perf_counter() - t0) / max(len(cov), 1) * 1e3
    launches = dict(kernels.LAUNCHES)
    plans = draws.groups.get("goal", 0)
    log(f"phase 8 collection simple/{MAIN_PATH_SEED}, {len(cov)} poses, {plans} plans: "
        f"{collect_ms:.2f} ms a collected pose [{smi}], coverage "
        f"{[round(c, 4) for c in cov]}, {len(db)} experiences, launches {launches}")
    rises("collection", cov)
    if len(cov) != n_poses:
        raise AssertionError(f"collection stopped after {len(cov)} of {n_poses} poses")
    expect_launches("collection", launches, {
        "ray_hits": 1, "ray_hits_pinhole": 1 + 2 * n_poses, "min_sq_dists": n_poses,
        "bfs_field": plans, "extract_path": plans})
    if plans < 1 or not db.entries:
        raise AssertionError("the collection planned no path or mined no label")
    e = db.entries[0]
    if e.model_input.shape != (5, 256, 256) or e.gt_layout.shape != (256, 256) \
            or not any(x.gt_layout.any() for x in db.entries):
        raise AssertionError(f"experience shapes {e.model_input.shape}, {e.gt_layout.shape}")
    if not all(torch.equal(b, stats0[k]) for k, b in model.named_buffers()):
        raise AssertionError("the collection moved the U-Net's running statistics")

    # Training at full width: 56 entries, 7 micro steps of 8, one AdamW step.
    data = (db.entries * (56 // len(db.entries) + 1))[:56]
    state = TT.init_train_state(model)
    ds, _ = TT.build_device_dataset(data, dev)
    w0 = model.final1.weight.detach().clone()
    marks, flags_seen, same = [], [], []

    def mark(tag):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((tag, ev))

    saved = []  # bytes the forward leaves allocated: the saved activations

    def on_forward(*_):
        mark("fwd")
        flags_seen.append(torch.backends.cudnn.allow_tf32)
        same.append(torch.equal(model.final1.weight, w0))
        saved.append(-torch.cuda.memory_allocated())

    def on_forward_end(*_):
        mark("fwd_end")
        saved[-1] += torch.cuda.memory_allocated()

    def on_backward(_):
        flags_seen.append(torch.backends.cudnn.allow_tf32)

    def on_step(*_):
        mark("opt")
        flags_seen.append(torch.backends.cudnn.allow_tf32)

    def on_step_end(*_):
        mark("opt_end")

    hooks = [model.register_forward_pre_hook(on_forward),
             model.register_forward_hook(on_forward_end),
             model.conv_blocks[0].conv0.weight.register_hook(on_backward),
             state.optimizer.register_step_pre_hook(on_step),
             state.optimizer.register_step_post_hook(on_step_end)]
    caller = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        losses = []
        for epoch in range(2):  # the second is the steady one, timed
            if epoch == 1:
                marks.clear()
            _, loss = TT.train_epoch_ds(state, ds, list(range(56)), random.Random(epoch))
            losses.append(loss)
            if epoch == 0:
                changed = not torch.equal(model.final1.weight, w0)
                first_same = list(same)
        flags_after = (torch.backends.cudnn.allow_tf32,
                       torch.backends.cuda.matmul.allow_tf32)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = caller
        for h in hooks:
            h.remove()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    starts = [ev for tag, ev in marks if tag == "fwd"]
    opt_start = next(ev for tag, ev in marks if tag == "opt")
    opt_end = next(ev for tag, ev in marks if tag == "opt_end")
    ends = [ev for tag, ev in marks if tag == "fwd_end"]
    micro_ms = [a.elapsed_time(b) for a, b in zip(starts, starts[1:] + [opt_start])]
    fwd_ms = [a.elapsed_time(b) for a, b in zip(starts, ends)]
    opt_ms = opt_start.elapsed_time(opt_end)
    log(f"phase 8 training, full-width NBP, 256x256x5, 7 micro steps of 8 a step [{smi}]: "
        f"{sum(micro_ms) / len(micro_ms):.2f} ms a micro step (forward + backward; "
        f"{[round(m, 2) for m in micro_ms]}; forward {sum(fwd_ms) / len(fwd_ms):.2f}, the "
        f"rest backward and accumulation), optimizer step {opt_ms:.2f} ms, peak memory "
        f"{peak:.2f} GiB (saved activations {max(saved) / 2 ** 30:.2f} GiB), mean losses "
        f"{losses}, optimizer steps "
        f"{int(state.optimizer.state[state.params[0]]['step'])}")
    log(f"  [{smi}] parameters unchanged at the forward of micro steps 1-7 {first_same[:7]}, "
        f"changed after the 7th {changed}; TF32 seen in the step {set(flags_seen)}, "
        f"caller's flags after {flags_after}")
    if first_same[:7] != [True] * 7 or not changed or state.mini_step != 0:
        raise AssertionError("the accumulation did not emit on the 7th micro step only")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"a training loss is not finite: {losses}")
    if any(flags_seen) or flags_after != (True, True):
        raise AssertionError("TF32 was on inside the training step, or the flags were lost")
    del ds, state

    # One accumulation cycle of NBP(width=8) at 64x64, card against CPU.
    small_data = [Experience(
        model_input=e.model_input[:, ::4, ::4].copy(), gt_layout=e.gt_layout[::4, ::4].copy(),
        pixels=e.pixels % np.array([8, 16, 16], np.int32), gains=e.gains, pose_i=12)
        for e in db.entries[:6]]
    small_data = (small_data * 6)[:6]
    out = {}
    for dtype in ("f32", "f64"):
        for d in ("card", "cpu"):
            m = seeded_train_model(1, width=8)
            if dtype == "f64":
                as_float64(m)
            where = dev if d == "card" else torch.device("cpu")
            m.to(where)
            st = TT.init_train_state(m, accumulation_steps=3)
            sds, _ = TT.build_device_dataset(small_data, where)
            _, loss = TT.train_epoch_ds(st, sds, list(range(6)), random.Random(0),
                                        micro_batch=2)
            out[dtype, d] = (loss, {k: v.cpu() for k, v in m.state_dict().items()})
    worst = {}
    for dtype in ("f32", "f64"):
        (l_g, sd_g), (l_c, sd_c) = out[dtype, "card"], out[dtype, "cpu"]
        keys = [k for k in sd_c if "running" in k or (dtype == "f64" and "num_batches" not in k)]
        errs = [float(((sd_g[k] - sd_c[k]).abs() / (sd_c[k].abs().max() + 1e-30)).max())
                for k in keys]
        worst[dtype] = (abs(l_g - l_c) / abs(l_c), max(errs))
    log(f"phase 8 card vs CPU [{smi}], one cycle of NBP(width=8) at 64x64 (3 micro steps of 2): "
        f"f32 loss rel err {worst['f32'][0]:.2e}, batch stats {worst['f32'][1]:.2e}; "
        f"f64 loss {worst['f64'][0]:.2e}, parameters and stats {worst['f64'][1]:.2e}")
    if max(max(v) for v in worst.values()) > 1e-4:
        raise AssertionError("the card's training step disagrees with the CPU's")

    # The epoch driver, 2 epochs of 8 poses, into a temporary directory.
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        st = run_training_nbp([assets], params=params, epochs=2, n_poses=8,
                              weights_dir=os.path.join(tmp, "w"),
                              log_dir=os.path.join(tmp, "log"), seed=MAIN_PATH_SEED,
                              verbose=False, device=dev)
        t_drv = time.perf_counter() - t0
        names = sorted(os.listdir(os.path.join(tmp, "w")))
        back = NBP()
        epoch, _ = load_nbp(os.path.join(tmp, "w", "nbp_best_val.ckpt"), back)
        equal = all(torch.equal(v.cpu(), back.state_dict()[k])
                    for k, v in st.model.state_dict().items())
        with open(os.path.join(tmp, "log", "nbp_loss.json")) as f:
            loss_log = json.load(f)
    log(f"phase 8 driver [{smi}]: run_training_nbp, 2 epochs of 8 poses, {t_drv:.2f} s; wrote "
        f"{names}; checkpoint epoch {epoch} read back equal {equal}; log {loss_log}")
    if not equal or epoch != 1 or names != ["nbp_best_val.ckpt"]:
        raise AssertionError("the driver's checkpoint did not read back equal")
    log(f"phase 8 wall time {time.perf_counter() - t_phase:.1f} s [{smi}]")
    return launches, dict(collect_ms=collect_ms, micro_ms=sum(micro_ms) / len(micro_ms),
                          fwd_ms=sum(fwd_ms) / len(fwd_ms), peak_gib=peak)


def micro_step_times(state, ds, n, epochs=2):
    """Device ms of the micro steps of the last of ``epochs`` passes over
    ``n`` staged entries (``train_epoch_ds``), from CUDA events at each
    forward's start and end and at the optimizer step: (micro step ms,
    forward ms, peak GiB)."""
    import random

    import torch
    from nextbestpath_tpu_torch.train import train_nbp as TT

    marks = []

    def mark(tag):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((tag, ev))

    model = state.model
    hooks = [model.register_forward_pre_hook(lambda *_: mark("fwd")),
             model.register_forward_hook(lambda *_: mark("fwd_end")),
             state.optimizer.register_step_pre_hook(lambda *_: mark("opt"))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        for epoch in range(epochs):
            marks.clear()
            TT.train_epoch_ds(state, ds, list(range(n)), random.Random(epoch))
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    starts = [ev for tag, ev in marks if tag == "fwd"]
    ends = [ev for tag, ev in marks if tag == "fwd_end"]
    opt = [ev for tag, ev in marks if tag == "opt"][-1]
    micro = [a.elapsed_time(b) for a, b in zip(starts, starts[1:] + [opt])]
    fwd = [a.elapsed_time(b) for a, b in zip(starts, ends)]
    return (sum(micro) / len(micro), sum(fwd) / len(fwd),
            torch.cuda.max_memory_allocated() / 2 ** 30)


def scan_train_phase(params, assets, small, s_assets, dev, smi, f32):
    """Phase 9 (module docstring). ``f32``: phase 8's numbers, printed
    beside. Returns the launches by kernel of the collection's main path
    (construction, warm-up and run), the collection's replay store and
    the bf16 micro step's ms."""
    t_phase = time.perf_counter()
    launches, coll, db = phase9_collection(params, assets, dev, smi, f32)
    phase9_padded_k3(coll, dev)
    micro_ms = phase9_bf16_step(db, dev, smi, f32)
    del coll
    phase9_driver(params, assets, dev, smi)
    phase9_card_vs_cpu(small, s_assets)
    log(f"phase 9 wall time {time.perf_counter() - t_phase:.1f} s [{smi}]")
    return launches, db, micro_ms


def phase9_collection(params, assets, dev, smi, f32):
    """ScanCollection on the main path's scene with the bf16 folded NBP:
    counts from 0 before its construction (the scene's K2 launch), read
    after the warm-up (which captures the graphs) and after the measured
    run; then the same run eagerly, bit for bit. Returns (launches, the
    collection, a replay store of its labels)."""
    import numpy as np
    import torch
    from nextbestpath_tpu_torch import kernels
    from nextbestpath_tpu_torch.eval.nbp_planning import (MAIN_PATH_SEED,
                                                          MAIN_PATH_WARMUP_POSES,
                                                          seeded_nbp)
    from nextbestpath_tpu_torch.train.replay import ReplayDB
    from nextbestpath_tpu_torch.train.scan_collection import (ScanCollection,
                                                              collect_trajectory_scan)

    model = seeded_nbp(dtype=torch.bfloat16).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    coll = ScanCollection([assets], model, params=params, device=dev)
    coll.run(0, model, seed=1, n_poses=MAIN_PATH_WARMUP_POSES)
    setup = dict(kernels.LAUNCHES)
    n_poses = 12
    out = coll.run(0, model, seed=MAIN_PATH_SEED, n_poses=n_poses)
    launches = dict(kernels.LAUNCHES)
    run_l = {k: launches[k] - setup[k] for k in setup}
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    ms = coll.wall_time_s / n_poses * 1e3
    plans = sum(coll.plan_poses)
    replays, reads = dict(coll.replays), coll.host_reads
    log(f"phase 9 collection simple/{MAIN_PATH_SEED}, bf16 folded NBP, {n_poses} poses as CUDA "
        f"graphs [{smi}]: {ms:.2f} ms a collected pose (phase 8's host collection "
        f"{f32['collect_ms']:.2f}), {plans} plans, {int(out.valid.sum())} valid poses, "
        f"replays {replays}, host reads {reads}, coverage "
        f"{[round(float(c), 4) for c in out.coverage]}, peak memory {peak:.0f} MiB; "
        f"launches: construction and warm-up {setup}, run {run_l}")
    rises("scan collection", [float(c) for c in out.coverage])
    want = dict(dict.fromkeys(kernels.LAUNCHES, 0), ray_hits_pinhole=1 + 2 * n_poses,
                min_sq_dists=n_poses, bfs_field=plans, extract_path=plans)
    if (run_l != want or setup["ray_hits"] != 1 or plans < 1 or reads != n_poses
            or replays != {"pre": n_poses, "plan": plans, "post": n_poses}
            or not out.valid.all()):
        raise AssertionError(f"scan collection: launches {run_l} (expected {want}), "
                             f"replays {replays}, host reads {reads}")
    coll._use_graphs = False
    eager = coll.run(0, model, seed=MAIN_PATH_SEED, n_poses=n_poses)
    coll._use_graphs = True
    same = all(np.array_equal(a, b) for a, b in zip(out, eager))
    log(f"phase 9 collection captured vs eager, {n_poses} poses: bit for bit {same}")
    if not same:
        raise AssertionError("the captured collection differs from the eager one")
    db = ReplayDB()
    collect_trajectory_scan(coll, 0, model, db, seed=MAIN_PATH_SEED, n_poses=n_poses)
    return launches, coll, db


def phase9_padded_k3(coll, dev):
    """K3 on a padded GT cloud against its plain version, and the masked
    coverage on the card against the CPU's, on the collection's cloud:
    normal/3 packed with 16,000 GT points and padded to simple/8's 20,000
    (procgen scenes keep every GT point, so a real pair pads nothing)."""
    import torch
    from nextbestpath_tpu_torch import kernels
    from nextbestpath_tpu_torch.assets import generate_scene, pack_generated_scene
    from nextbestpath_tpu_torch.config import default_params
    from nextbestpath_tpu_torch.ops.coverage import (coverage_percentage,
                                                     min_sq_dists_plain,
                                                     n_sample_for, stride_subsample)

    normal = pack_generated_scene(generate_scene("normal", seed=3),
                                  params=default_params(n_gt_surface_points=16000))
    g_pad = torch.full((20000, 3), 1e7, device=dev)
    g_pad[:16000] = torch.from_numpy(normal.gt_surface).to(dev)
    valid = torch.arange(20000, device=dev) < 16000
    pc = coll.state.pc
    n_s = n_sample_for(20000, pc.capacity)
    c = max(int(pc.count), 1)
    start = torch.tensor(c // 3, device=dev)
    half = torch.tensor(max(c // 7, 1), device=dev)
    idx, ok = stride_subsample(start, half, pc.count, n_s)
    s_in = torch.where(ok[:, None], pc.points[idx],
                       torch.full_like(pc.points[idx], 1e9)).contiguous()
    d_k = (kernels.min_sq_dists(g_pad, s_in, pc.count) if g_pad.is_cuda
           else min_sq_dists_plain(g_pad, s_in, pc.count))
    d_p = min_sq_dists_plain(g_pad, s_in, pc.count)
    cov_card = float(coverage_percentage(g_pad, pc.points, pc.count, start, half,
                                         gt_valid=valid))
    cov_cpu = float(coverage_percentage(g_pad.cpu(), pc.points.cpu(), pc.count.cpu(),
                                        start.cpu(), half.cpu(), gt_valid=valid.cpu()))
    log(f"phase 9 K3 on padded GT (16,000 of 20,000 rows valid) x {n_s} samples, "
        f"{int(pc.count)} points: bit for bit {torch.equal(d_k, d_p)}; masked coverage "
        f"card {cov_card} vs cpu {cov_cpu}")
    if not torch.equal(d_k, d_p) or cov_card != cov_cpu or not 0.0 < cov_card < 1.0:
        raise AssertionError("K3 or the masked coverage disagrees on padded GT")


def phase9_bf16_step(db, dev, smi, f32):
    """The bf16 training step at full width: 56 experiences, 7 micro steps
    of 8 and one AdamW step a pass, the second pass timed. Returns the ms
    of a micro step."""
    import torch
    from nextbestpath_tpu_torch.eval.nbp_planning import seeded_nbp
    from nextbestpath_tpu_torch.train import train_nbp as TT

    data = (db.entries * (56 // len(db.entries) + 1))[:56]
    tm = seeded_nbp(dtype=torch.bfloat16).to(dev).train()
    state = TT.init_train_state(tm)
    ds, _ = TT.build_device_dataset(data, dev)
    micro, fwd, peak = micro_step_times(state, ds, 56)
    steps = int(state.optimizer.state[state.params[0]]["step"])
    log(f"phase 9 bf16 training step, full-width NBP, 256x256x5, micro batch 8 [{smi}]: "
        f"{micro:.2f} ms a micro step, forward {fwd:.2f} ms, peak {peak:.2f} GiB; "
        f"phase 8's f32 step {f32['micro_ms']:.2f} ms, forward {f32['fwd_ms']:.2f} ms, "
        f"peak {f32['peak_gib']:.2f} GiB; optimizer steps {steps}")
    if steps != 2 or not all(p.dtype == torch.float32 for p in tm.parameters()):
        raise AssertionError("the bf16 step did not emit twice on f32 parameters")
    return micro


def phase9_driver(params, assets, dev, smi):
    """run_training_nbp_scan for 3 epochs of 8 poses on simple/8 and normal/3
    padded to a common lattice with simple/508 held out, then a resume to a
    4th epoch after a stale shard is planted. The checkpoint writes are
    timed apart (the driver's ``save_checkpoint`` and ``save_nbp``)."""
    import shutil
    import tempfile

    import torch
    from nextbestpath_tpu_torch.assets import (generate_scene, pack_generated_scene,
                                               pad_assets_to_common)
    from nextbestpath_tpu_torch.eval.nbp_planning import MAIN_PATH_SEED
    from nextbestpath_tpu_torch.train import driver
    from nextbestpath_tpu_torch.train.driver import (run_training_nbp_scan,
                                                     seeded_train_model)

    saves = []

    def timed(fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            fn(*a, **k)
            saves.append(time.perf_counter() - t0)
        return call
    from nextbestpath_tpu_torch.utils.checkpoint import load_checkpoint

    scenes = pad_assets_to_common([
        assets, pack_generated_scene(generate_scene("normal", seed=3), params=params)])
    evals = [pack_generated_scene(generate_scene("simple", seed=508), params=params)]
    tmp = tempfile.mkdtemp(prefix="nbp_scan_")
    untimed = driver.save_checkpoint, driver.save_nbp
    driver.save_checkpoint, driver.save_nbp = map(timed, untimed)
    try:
        def drive(epochs, resume):
            t0 = time.perf_counter()
            st = run_training_nbp_scan(
                scenes, eval_scenes=evals, params=params, epochs=epochs, n_poses=8,
                db_dir=os.path.join(tmp, "db"), weights_dir=os.path.join(tmp, "w"),
                log_dir=os.path.join(tmp, "log"), seed=MAIN_PATH_SEED, verbose=False,
                resume=resume, eval_every=2, eval_poses=4, device=dev,
                model=seeded_train_model(MAIN_PATH_SEED, dtype=torch.bfloat16))
            return (time.perf_counter() - t0,
                    int(st.optimizer.state[st.params[0]]["step"]))
        t3, steps3 = drive(3, False)
        files = sorted(os.listdir(os.path.join(tmp, "w")))
        shutil.copy(os.path.join(tmp, "db", "epoch_0002.npz"),
                    os.path.join(tmp, "db", "epoch_0006.npz"))
        t4, steps4 = drive(4, True)
        shards = sorted(os.listdir(os.path.join(tmp, "db")))
        epoch = load_checkpoint(os.path.join(tmp, "w", "nbp_latest.ckpt"))[2]
        with open(os.path.join(tmp, "log", "nbp_loss.json")) as f:
            loss_log = json.load(f)
    finally:
        driver.save_checkpoint, driver.save_nbp = untimed
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 9 scan trainer [{smi}]: simple/8 + normal/3 padded to "
        f"{scenes[0].pose_l}x{scenes[0].pose_h}, eval simple/508, 3 epochs of 8 poses "
        f"{t3:.2f} s (optimizer steps {steps3}), resumed to epoch 4 {t4:.2f} s (steps "
        f"{steps4}); {len(saves)} checkpoint writes {sum(saves):.2f} s of it "
        f"({[round(x, 2) for x in saves]}); weights {files}; shards {shards}; latest "
        f"epoch {epoch}; log {json.dumps(loss_log)}")
    if (files != ["nbp_best_auc.ckpt", "nbp_best_val.ckpt", "nbp_latest.ckpt"]
            or "epoch_0006.npz" in shards or "epoch_0003.npz" not in shards
            or epoch != 3 or not steps4 > steps3 >= 1 or not loss_log["eval_auc"]):
        raise AssertionError("the scan trainer's files, shards, resume or eval disagree")


def scene_seeds(n):
    """The procgen ``simple`` seeds of phase 3's and phase 10's scene axis:
    the main path's seed and the next ones."""
    from nextbestpath_tpu_torch.eval.nbp_planning import MAIN_PATH_SEED
    return [MAIN_PATH_SEED + i for i in range(n)]


def padded_scenes(params, n):
    from nextbestpath_tpu_torch.assets import (generate_scene, pack_generated_scene,
                                               pad_assets_to_common)
    return pad_assets_to_common([pack_generated_scene(generate_scene("simple", seed=s),
                                                      params=params)
                                 for s in scene_seeds(n)])


def scene_kernel_rows(params, intr, dev):
    """Phase 3's scene-axis launches against their plain versions and
    against a stack of single-scene launches of today's kernels, bit for
    bit: K1 over B = 4 and 8 padded ``simple`` scenes (seeds 8-15), a move's
    4 frames each; K3 over B = 4 and 8 scenes' GT clouds with unequal
    sample counts (a 0 among them); P1/P2 over B = 4 17x17 lattices (the
    scenes' GT edge tables) and B = 4 58x58 mazes. The JSON rows take
    B = 4, the batch of phase 10; B = 8 is logged beside."""
    import torch
    from nextbestpath_tpu_torch import kernels
    from nextbestpath_tpu_torch.eval.nbp_planning import main_path_move
    from nextbestpath_tpu_torch.geometry.cameras import get_camera_RT
    from nextbestpath_tpu_torch.ops.coverage import min_sq_dists_scenes_plain
    from nextbestpath_tpu_torch.ops.raytrace import (frame_rays, pinhole_tri_soa,
                                                     ray_hits_pinhole_scenes_plain,
                                                     tris_to_soa)
    from nextbestpath_tpu_torch.planning.grid_paths import (
        INF, bfs_distance_field_scenes_plain, extract_path_scenes_plain)
    from nextbestpath_tpu_torch.sim.tables import build_scene_tables

    zn, zf = float(intr.znear), float(intr.zfar)
    n_steps = int(params.n_interpolation_steps)
    scenes = padded_scenes(params, 8)
    out = {}
    for B in (4, 8):
        a_b = scenes[:B]
        dirs, phs, counts = [], [], []
        for a in a_b:
            soa = tris_to_soa(torch.from_numpy(a.tris).to(dev))
            poses = main_path_move(a, n_steps, dev)
            R, T = get_camera_RT(poses[:, :3], poses[:, 3:])
            eyes, d = frame_rays(R, T, intr)
            dirs.append(d)
            phs.append(pinhole_tri_soa(soa, eyes))
            counts += [a.n_tris] * n_steps
        dirs = torch.cat(dirs).contiguous()
        ph = torch.cat(phs).contiguous()
        nt = torch.tensor(counts, dtype=torch.int32, device=dev)
        got = kernels.ray_hits_pinhole_scenes(dirs, ph, nt, zn, zf)
        want = ray_hits_pinhole_scenes_plain(dirs, ph, nt, zn, zf)
        single = [kernels.ray_hits_pinhole(dirs[k:k + n_steps], ph[k:k + n_steps],
                                           nt[k], zn, zf)
                  for k in range(0, len(counts), n_steps)]
        single = tuple(torch.cat([x[i] for x in single]) for i in range(3))
        compare_hits(f"K1 ray_hits_pinhole_scenes ({B} scenes x {n_steps} frames, one "
                     f"launch)", got, want, dirs.shape[0] * dirs.shape[1])
        if not all(torch.equal(g, w) for g, w in zip(got, single)):
            raise AssertionError(f"K1's scene axis differs from single launches (B={B})")
        n = dirs.shape[0] * dirs.shape[1]
        ops = dirs.shape[1] * sum(counts) * OPS_K1
        out[("k1", B)] = dict(
            ms=kernels.device_ms(lambda: kernels.ray_hits_pinhole_scenes(dirs, ph, nt, zn, zf), 30),
            plain_ms=kernels.device_ms(
                lambda: ray_hits_pinhole_scenes_plain(dirs, ph, nt, zn, zf), 2),
            single_ms=kernels.device_ms(lambda: [
                kernels.ray_hits_pinhole(dirs[k:k + n_steps], ph[k:k + n_steps], nt[k], zn, zf)
                for k in range(0, len(counts), n_steps)], 20),
            bound=bound_ms(n * 12 + ph.numel() * 4 + 4 * len(counts) + n * 12, ops),
            library_ms=None, ceiling=ceiling_ms(ops),
            shape=f"{B} scenes x {n_steps} frames x {dirs.shape[1]} rays x "
                  f"{counts[0]} tris, a count a frame")

        gen = torch.Generator(device="cpu").manual_seed(B)
        n_s = 40960
        c_list = [40960, 12345, 0, 30000, 40960, 777, 20000, 40960][:B]
        gs, ss = [], []
        for a, c in zip(a_b, c_list):
            g = torch.from_numpy(a.gt_surface).to(dev)
            samp = g[torch.randint(0, g.shape[0], (n_s,), generator=gen).to(dev)]
            samp = samp + 0.5 * torch.randn(n_s, 3, generator=gen).to(dev)
            ss.append(torch.where((torch.arange(n_s, device=dev) < c)[:, None], samp,
                                  torch.full_like(samp, 1e9)))
            gs.append(g)
        g3, s3 = torch.stack(gs).contiguous(), torch.stack(ss).contiguous()
        c3 = torch.tensor(c_list, dtype=torch.int32, device=dev)
        got = kernels.min_sq_dists_scenes(g3, s3, c3)
        want = min_sq_dists_scenes_plain(g3, s3, c3)
        single = torch.stack([kernels.min_sq_dists(g, s_, c) for g, s_, c in zip(g3, s3, c3)])
        ok = torch.equal(got, want) and torch.equal(got, single)
        log(f"K3 min_sq_dists_scenes ({B} scenes x {g3.shape[1]} GT x {n_s} samples, counts "
            f"{c_list}): equal to the plain version and to single launches {ok}; tiling "
            f"{kernels.min_sq_dists_tiling(g3.shape[1], n_s, dev, n_scenes=B)}")
        if not ok:
            raise AssertionError(f"K3's scene axis disagrees (B={B})")
        ops = g3.shape[1] * sum(c_list) * OPS_K3
        out[("k3", B)] = dict(
            ms=kernels.device_ms(lambda: kernels.min_sq_dists_scenes(g3, s3, c3), 20),
            plain_ms=kernels.device_ms(lambda: min_sq_dists_scenes_plain(g3, s3, c3), 2),
            single_ms=kernels.device_ms(lambda: [kernels.min_sq_dists(g, s_, c) for g, s_, c
                                                 in zip(g3, s3, c3)], 20),
            bound=bound_ms(g3.numel() * 4 + 12 * sum(c_list) + 4 * B + 4 * g3.shape[1] * B,
                           ops),
            library_ms=(kernels.device_ms(lambda: torch.cdist(g3, s3).amin(-1), 3)
                        if B == 4 else None),
            ceiling=ceiling_ms(ops),
            shape=f"{B} scenes x {g3.shape[1]} GT x {n_s} samples, counts {c_list}")
        del g3, s3, gs, ss
        torch.cuda.empty_cache()

    max_len = int(params.max_path_len)
    blocked17, start17 = [], []
    for a in scenes[:4]:
        soa = tris_to_soa(torch.from_numpy(a.tris).to(dev))
        nt = torch.tensor([a.n_tris], dtype=torch.int32, device=dev)
        blocked17.append(build_scene_tables(soa, nt, torch.from_numpy(a.pose_origin).to(dev),
                                            a.pose_l, a.pose_h).gt_edge_blocked)
        start17.append([int(a.start_cam_idx[0]), int(a.start_cam_idx[2])])
    maze = serpentine(58, 58, dev)
    cases = {"17x17": (torch.stack(blocked17).contiguous(),
                       torch.tensor(start17, dtype=torch.int64, device=dev)),
             "58x58 maze": (maze.expand(4, -1, -1, -1).contiguous(),
                            torch.tensor([[0, 0], [57, 0], [0, 57], [57, 57]],
                                         dtype=torch.int64, device=dev))}
    for name, (blocked, start) in cases.items():
        B, L, H = blocked.shape[0], blocked.shape[2], blocked.shape[3]
        dist = kernels.bfs_field_scenes(blocked, start)
        dist_p = bfs_distance_field_scenes_plain(blocked, start, L, H)
        dist_1 = torch.stack([kernels.bfs_field(b, st) for b, st in zip(blocked, start)])
        reach = dist_p < INF
        flat = torch.argmax(torch.where(reach, dist_p, -1).reshape(B, -1), dim=1)
        goal = torch.stack([flat // H, flat % H], dim=1)
        ecc = [int(d[r].max()) for d, r in zip(dist_p, reach)]
        path, meta = kernels.extract_path_scenes(dist, blocked, goal, max_len)
        path_p, len_p, reach_p = extract_path_scenes_plain(dist_p, blocked, goal, L, H, max_len)
        singles = [kernels.extract_path(d, b, g, max_len) for d, b, g in zip(dist, blocked, goal)]
        ok = (torch.equal(dist, dist_p) and torch.equal(dist, dist_1)
              and torch.equal(path, path_p) and torch.equal(meta[:, 0], len_p)
              and torch.equal(meta[:, 1] != 0, reach_p)
              and torch.equal(path, torch.stack([x[0] for x in singles]))
              and torch.equal(meta, torch.stack([x[1] for x in singles])))
        log(f"planner kernels, scene axis ({B} x {name}): eccentricities {ecc}, path lengths "
            f"{len_p.tolist()} (max_len {max_len}), equal to the plain versions and to single "
            f"launches {ok}")
        if not ok:
            raise AssertionError(f"the planner kernels' scene axis disagrees ({name})")
        n = L * H
        out[("bfs", name)] = dict(
            ms=kernels.device_ms(lambda: kernels.bfs_field_scenes(blocked, start), 50),
            plain_ms=wall_ms(lambda: bfs_distance_field_scenes_plain(blocked, start, L, H), 2),
            single_ms=kernels.device_ms(lambda: [kernels.bfs_field(b, st) for b, st
                                                 in zip(blocked, start)], 50),
            bound=bound_ms(B * (4 * n + 16 + 4 * n), B * n * OPS_BFS_NODE, PEAK_INT32_OPS),
            library_ms=None, ceiling=None, shape=f"{B} x {name} lattices")
        out[("walk", name)] = dict(
            ms=kernels.device_ms(lambda: kernels.extract_path_scenes(dist, blocked, goal,
                                                                     max_len), 50),
            plain_ms=wall_ms(lambda: extract_path_scenes_plain(dist_p, blocked, goal, L, H,
                                                               max_len), 2),
            single_ms=kernels.device_ms(lambda: [kernels.extract_path(d, b, g, max_len) for d, b, g
                                                 in zip(dist, blocked, goal)], 50),
            bound=bound_ms(sum(16 + 4 + e * BYTES_WALK_STEP + 8 * max_len + 8 for e in ecc),
                           sum(e * OPS_WALK_STEP for e in ecc), PEAK_INT32_OPS),
            library_ms=None, ceiling=None, shape=f"{B} x {name} lattices")
    for key, r in out.items():
        log(f"  {key[0]} scene axis {key[1]}: {r['ms']:.4f} ms (single launches "
            f"{r['single_ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound'][0]:.4g} ms by {r['bound'][1]}, library {r['library_ms']}) at "
            f"{r['shape']}")
    rows = []
    for name, key, src, rep in (
            ("ray_hits_pinhole_scenes", ("k1", 4), "raytrace.cu",
             "nextbestpath_tpu/ops/raytrace.py:288 (vmapped)"),
            ("min_sq_dists_scenes", ("k3", 4), "coverage.cu",
             "nextbestpath_tpu/ops/coverage.py:134 (vmapped)"),
            ("bfs_field_scenes", ("bfs", "17x17"), "plan.cu",
             "nextbestpath_tpu/planning/grid_paths.py:102 (XLA while_loop, vmapped)"),
            ("extract_path_scenes", ("walk", "17x17"), "plan.cu",
             "nextbestpath_tpu/planning/grid_paths.py:160 (XLA while_loop, vmapped)")):
        r = out[key]
        rows.append(dict(name=name, route="cuda", source=f"nextbestpath_tpu_torch/csrc/{src}",
                         replaces=rep, max_abs_err=0.0, ms=r["ms"], plain_ms=r["plain_ms"],
                         bound_ms=r["bound"][0], bound_by=r["bound"][1],
                         ceiling_ms=r["ceiling"], library_ms=r["library_ms"], shape=r["shape"]))
    return rows


def multi_scene_phase(params, small, dev, smi):
    """Phase 10 (module docstring). Returns the launches by kernel of its
    three counted paths: {"batch": ..., "interleaved": ..., "walk": ...}."""
    import numpy as np
    import torch
    from nextbestpath_tpu_torch import kernels
    from nextbestpath_tpu_torch.draws import TorchDraws
    from nextbestpath_tpu_torch.eval.nbp_planning import (MAIN_PATH_WARMUP_POSES,
                                                          seeded_nbp)
    from nextbestpath_tpu_torch.eval.random_walk import ScanRandomWalk
    from nextbestpath_tpu_torch.eval.scan_rollout import (BatchedScanRollout,
                                                          ScanRollout, run_interleaved)

    t_phase = time.perf_counter()
    B, n_poses, seed = 4, 6, scene_seeds(1)[0]
    scenes = padded_scenes(params, B)
    zero = dict.fromkeys(kernels.LAUNCHES, 0)

    # (a) The true batch as graphs, counts from 0 before its construction.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    batch = BatchedScanRollout(scenes, seeded_nbp(), params=params, device=dev)
    built = dict(kernels.LAUNCHES)
    batch.run(n_poses=MAIN_PATH_WARMUP_POSES, seed=seed)
    setup = dict(kernels.LAUNCHES)
    res = batch.run(n_poses=n_poses, seed=seed)
    after = dict(kernels.LAUNCHES)
    run_l = {k: after[k] - setup[k] for k in after}
    flags = batch.regen_poses
    any_regen = sum(any(f) for f in flags)
    mixed = sum(any(f) and not all(f) for f in flags)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    log(f"phase 10(a) true batch, {B} x simple {scene_seeds(B)} padded to "
        f"{scenes[0].pose_l}x{scenes[0].pose_h}, f32 seeded NBP, {n_poses} poses after "
        f"{MAIN_PATH_WARMUP_POSES} [{smi}]: {res[0].wall_time_s / n_poses * 1e3:.2f} ms a pose "
        f"of {B} scenes ({res[0].steps_per_sec:.2f} scene-poses/s), flags {flags} "
        f"({any_regen} any-regeneration poses, {mixed} mixed), replays {batch.replays}, host "
        f"reads {batch.host_reads}, peak {peak:.0f} MiB; launches: construction {built}, "
        f"run {run_l}")
    for i, r in enumerate(res):
        log(f"  scene {i}: coverage {[round(c, 4) for c in r.coverage_evolution]}, points "
            f"{r.n_points}")
        rises(f"true batch scene {i}", r.coverage_evolution)
    R = batch.max_plan_retries
    want = dict(zero, ray_hits_pinhole_scenes=1 + 2 * n_poses, min_sq_dists_scenes=n_poses,
                bfs_field_scenes=R * any_regen, extract_path_scenes=R * any_regen)
    if (built != dict(zero, ray_hits=B) or run_l != want or batch.host_reads != n_poses
            or batch.replays != {"pre": n_poses, "plan": any_regen, "post": n_poses}):
        raise AssertionError(f"true batch: construction {built} (expected K2 {B}), run "
                             f"{run_l} (expected {want}), replays {batch.replays}, host reads "
                             f"{batch.host_reads}")
    batch_l = dict(after)
    batch._use_graphs = False
    eager = batch.run(n_poses=n_poses, seed=seed)
    batch._use_graphs = True
    same = all(e.coverage_evolution == g.coverage_evolution
               and np.array_equal(e.cam_positions, g.cam_positions)
               and e.n_points == g.n_points for e, g in zip(eager, res))
    log(f"phase 10(a) true batch captured vs eager: bit for bit {same}")
    if not same or batch.regen_poses != flags:
        raise AssertionError("the captured true batch differs from the eager one")
    singles = [ScanRollout(a, seeded_nbp(), params=params, scene=sc, device=dev)
               for a, sc in zip(scenes, batch.scenes)]
    solo = []
    for i, r in enumerate(singles):
        r.run(n_poses=MAIN_PATH_WARMUP_POSES, seed=seed + i)
        solo.append((r.run(n_poses=n_poses, seed=seed + i), list(r.regen_poses)))
    parted = []
    for i, ((s_res, s_flags), b_res) in enumerate(zip(solo, res)):
        if (s_res.coverage_evolution != b_res.coverage_evolution
                or not np.array_equal(s_res.cam_positions, b_res.cam_positions)
                or s_flags != [f[i] for f in flags]):
            diff = [k for k in range(n_poses)
                    if s_res.coverage_evolution[k] != b_res.coverage_evolution[k]]
            parted.append((i, diff[:1], s_flags))
    log(f"phase 10(a) true batch vs {B} single captured ScanRollouts: same trajectories and "
        f"coverage {not parted} (parted: {parted})")
    if parted:
        raise AssertionError(f"the true batch parts from single runs: {parted}")

    # (b) run_interleaved over the four captured single rollouts.
    kernels.reset_launch_counts()
    inter = run_interleaved(singles, n_poses=n_poses, seed=seed)
    inter_l = dict(kernels.LAUNCHES)
    same = all(x.coverage_evolution == s.coverage_evolution
               and np.array_equal(x.cam_positions, s.cam_positions)
               for x, (s, _) in zip(inter, solo))
    log(f"phase 10(b) run_interleaved over {B} captured ScanRollouts: bit for bit against "
        f"single runs {same}, {inter[0].wall_time_s / n_poses * 1e3:.2f} ms a pose of {B} "
        f"scenes, host reads {[r.host_reads for r in singles]}, launches {inter_l}")
    if not same or inter_l["min_sq_dists"] != B * n_poses:
        raise AssertionError("run_interleaved differs from single runs")

    # (c) ScanRandomWalk as graphs against eager.
    kernels.reset_launch_counts()
    walk = ScanRandomWalk(scenes, params=params, device=dev)
    walk.run(n_poses=MAIN_PATH_WARMUP_POSES, seed=seed)
    w_setup = dict(kernels.LAUNCHES)
    w_res = walk.run(n_poses=n_poses, seed=seed)
    walk_l = dict(kernels.LAUNCHES)
    w_run = {k: walk_l[k] - w_setup[k] for k in walk_l}
    reads, replays = walk.host_reads, dict(walk.replays)
    walk._use_graphs = False
    w_eager = walk.run(n_poses=n_poses, seed=seed)
    same = all(a.coverage_evolution == b.coverage_evolution
               and np.array_equal(a.cam_positions, b.cam_positions)
               for a, b in zip(w_res, w_eager))
    log(f"phase 10(c) ScanRandomWalk, {B} scenes, {n_poses} poses as one graph a pose: "
        f"{w_res[0].wall_time_s / n_poses * 1e3:.2f} ms a pose of {B} scenes, host reads "
        f"{reads}, replays {replays}, coverage "
        f"{[[round(c, 4) for c in r.coverage_evolution] for r in w_res]}; captured vs eager "
        f"bit for bit {same}; launches {w_run}")
    for i, r in enumerate(w_res):
        rises(f"walk scene {i}", r.coverage_evolution)
    if (not same or reads != 0 or replays != {"pose": n_poses}
            or w_run != dict(zero, ray_hits_pinhole_scenes=n_poses + 1,
                             min_sq_dists_scenes=n_poses)):
        raise AssertionError(f"ScanRandomWalk: launches {w_run}, reads {reads}")
    del batch, singles, walk
    torch.cuda.empty_cache()

    # (d) Aggregate poses/s at B = 4 and 8, three modes; and the folded
    # f32 U-Net's forward at the batches the true batch runs, called
    # eagerly (kernels.device_ms: a call whose host time outlasts its
    # device time reads as its host time) and replayed as a CUDA graph, as
    # the true batch's plan runs it (device time alone).
    from nextbestpath_tpu_torch.models.fold import fold_bn
    folded = fold_bn(seeded_nbp()).to(dev).eval()
    x = torch.rand(8, 256, 256, 5, generator=torch.Generator().manual_seed(0)).to(dev)
    unet_ms = {}
    with torch.no_grad():
        for b in (1, 2, 4, 8):
            xb = x[:b].contiguous()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                folded(xb)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                folded(xb)
            unet_ms[b] = (kernels.device_ms(lambda xb=xb: folded(xb), 3),
                          kernels.device_ms(graph.replay, 5))
            del graph
    log(f"phase 10(d) folded f32 U-Net forward ms (256x256x5, eager / as a graph) "
        f"[{smi}]: " + ", ".join(f"batch {b} {e:.2f} / {g:.2f}"
                                 for b, (e, g) in unet_ms.items()))
    del folded, x
    for n_b in (4, 8):
        sc_b = padded_scenes(params, n_b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rolls = [ScanRollout(a, seeded_nbp(), params=params, device=dev) for a in sc_b]
        for i, r in enumerate(rolls):
            r.run(n_poses=MAIN_PATH_WARMUP_POSES, seed=seed + i)
        rates = {}
        seq = [r.run(n_poses=30, seed=seed + 100 + i) for i, r in enumerate(rolls)]
        rates["sequential"] = n_b * 30 / sum(x.wall_time_s for x in seq)
        rates["interleaved"] = run_interleaved(rolls, n_poses=30, seed=seed + 100)[0].steps_per_sec
        peak_single = torch.cuda.max_memory_allocated() / 2 ** 20
        del rolls
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tb = BatchedScanRollout(sc_b, seeded_nbp(), params=params, device=dev)
        tb.run(n_poses=MAIN_PATH_WARMUP_POSES, seed=seed)
        out = tb.run(n_poses=30, seed=seed + 100)
        rates["true batch"] = out[0].steps_per_sec
        peak_batch = torch.cuda.max_memory_allocated() / 2 ** 20
        any_b = sum(any(f) for f in tb.regen_poses)
        del tb
        torch.cuda.empty_cache()
        log(f"phase 10(d) B = {n_b}, 30 poses [{smi}]: aggregate poses/s "
            + ", ".join(f"{k} {v:.2f}" for k, v in rates.items())
            + f"; true batch any-regeneration poses {any_b} of 30; peak memory {peak_single:.0f} "
              f"MiB ({n_b} ScanRollouts) and {peak_batch:.0f} MiB (true batch)")

    # (e) A small batched rollout on the card against the CPU.
    from nextbestpath_tpu_torch.assets import (generate_scene, pack_generated_scene,
                                               pad_assets_to_common)
    s_pair = pad_assets_to_common([pack_generated_scene(generate_scene("simple", seed=s),
                                                        params=small) for s in (4, 5)])
    runs = {}
    for d in ("cuda", "cpu"):
        b2 = BatchedScanRollout(s_pair, seeded_nbp(), params=small, device=d,
                                make_draws=lambda s, d=d: TorchDraws(s, torch.device(d), "cpu"))
        runs[d] = (b2.run(n_poses=8, seed=4), b2.regen_poses)
    (g, gf), (c, cf) = runs["cuda"], runs["cpu"]
    diff = max(abs(x - y) for a, b in zip(g, c)
               for x, y in zip(a.coverage_evolution, b.coverage_evolution))
    same = gf == cf and all(a.cam_positions.shape == b.cam_positions.shape
                            and float(np.abs(a.cam_positions - b.cam_positions).max()) < 1e-4
                            for a, b in zip(g, c))
    log(f"phase 10(e) small true batch (2 padded scenes, 32x56, 8 poses) card vs CPU: flags "
        f"{gf}, coverage max diff {diff:.2e}, same decisions {same}")
    if diff > TOL_COVERAGE or not same:
        raise AssertionError("the card's small true batch disagrees with the CPU's")
    log(f"phase 10 wall time {time.perf_counter() - t_phase:.1f} s [{smi}]")
    return {"batch": batch_l, "interleaved": inter_l, "walk": walk_l}


@contextlib.contextmanager
def cards_visible(visible):
    """CUDA_VISIBLE_DEVICES as the script found it (None: unset) inside the
    block, for the processes started there; this process keeps its card."""
    mine = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is None:
        os.environ.pop("CUDA_VISIBLE_DEVICES", None)
    else:
        os.environ["CUDA_VISIBLE_DEVICES"] = visible
    try:
        yield
    finally:
        if mine is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES", None)
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = mine


def card_count(visible) -> int:
    """The cards the script found visible (CUDA_VISIBLE_DEVICES, else
    nvidia-smi's list)."""
    if visible is not None:
        return len([v for v in visible.split(",") if v.strip()])
    out = subprocess.run(["nvidia-smi", "-L"], capture_output=True, text=True,
                         check=True).stdout
    return len([ln for ln in out.splitlines() if ln.startswith("GPU ")])


def dp_phase(entries, micro9_ms, visible, smi):
    """Phase 11 (module docstring): ``parallel/dryrun.py::chip_phase``.
    ``entries``: phase 9's replay entries; ``micro9_ms``: phase 9's bf16
    micro step. Returns rank 0's launches by kernel of (a)'s driver run."""
    from nextbestpath_tpu_torch.parallel.dryrun import chip_phase

    t_phase = time.perf_counter()
    n_cards = card_count(visible)
    with cards_visible(visible):
        res = chip_phase(list(entries), n_cards)
    a = res["a"]
    log(f"phase 11(a) run_training_nbp_dp under NCCL, {n_cards} rank(s), one a card, bf16 "
        f"full-width NBP, simple 8.. one a rank, 2 epochs of 16 poses, held-out eval "
        f"[{smi}]: {a['driver_s']:.2f} s; wrote {a['files']}; log {json.dumps(a['log'])}; "
        f"launches on rank 0 {a['launches']}; weights the same bits on every rank "
        f"{a['same_bits']}")
    log(f"phase 11(a) micro step of 8, bf16, 256x256x5 [{smi}]: DP over {n_cards} rank(s) "
        f"{[round(x, 2) for x in a['micro_dp_ms']]} ms against one process "
        f"{[round(x, 2) for x in a['micro_single_ms']]} ms in the same process (passes "
        f"single, DP, DP, single; phase 9's bf16 step {micro9_ms:.2f} ms); a micro step's "
        f"collectives alone: {a['n_bn']} BatchNorm all-reduces forward and back "
        f"{a['bn_all_reduce_ms']:.4f} ms, the gradient bucket ({a['n_params']} + 1 f32) "
        f"{a['grad_all_reduce_ms']:.4f} ms; collection {a['collect_ms']:.2f} ms a pose "
        f"({a['collect_rate']:.2f} poses/s over {n_cards} card(s)); eval "
        f"{a['eval_rate']:.2f} poses/s; peak {a['peak_mib']:.0f} MiB")
    for tag in ("b", "c"):
        if tag in res:
            log(f"phase 11({tag}) {'2 gloo ranks sharing card 0' if tag == 'b' else f'NCCL over {n_cards} cards'} "
                f"[{smi}]: {json.dumps(res[tag])}")
    if n_cards < 2:
        log("phase 11(c) skipped: one card visible")
    want = ("ray_hits_pinhole", "ray_hits", "min_sq_dists", "bfs_field", "extract_path")
    if any(a["launches"][k] <= 0 for k in want):
        raise AssertionError(f"the dp path did not launch every kernel: {a['launches']}")
    log(f"phase 11 wall time {time.perf_counter() - t_phase:.1f} s [{smi}]")
    return a["launches"]


def phase9_card_vs_cpu(small, s_assets):
    """One small-config collection (f32 NBP) on the card and on the CPU with
    one CPU generator's draws: the same decisions, coverage within 1e-3."""
    import numpy as np
    import torch
    from nextbestpath_tpu_torch.draws import TorchDraws
    from nextbestpath_tpu_torch.eval.nbp_planning import seeded_nbp
    from nextbestpath_tpu_torch.train.scan_collection import ScanCollection

    runs = {}
    for d in ("cuda", "cpu"):
        m = seeded_nbp()
        c2 = ScanCollection([s_assets], m, params=small, device=d,
                            make_draws=lambda s, d=d: TorchDraws(s, torch.device(d), "cpu"))
        runs[d] = (c2.run(0, m, seed=4, n_poses=8), c2.plan_poses)
    (g, g_plans), (c, c_plans) = runs["cuda"], runs["cpu"]
    diff = float(np.abs(g.coverage - c.coverage).max())
    same = (g_plans == c_plans and np.array_equal(g.rot, c.rot)
            and np.array_equal(g.valid, c.valid) and np.array_equal(g.planned, c.planned)
            and float(np.abs(g.pose5 - c.pose5).max()) < 1e-4)
    log(f"phase 9 small collection card vs CPU (32x56, 8 poses, plans {g_plans}): coverage "
        f"{[round(float(x), 4) for x in g.coverage]} vs "
        f"{[round(float(x), 4) for x in c.coverage]}, max diff {diff:.2e}, same decisions {same}")
    if diff > TOL_COVERAGE or not same:
        raise AssertionError("the card's small collection disagrees with the CPU's")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", default=None,
                    help="another checkout whose K2 to time at phase 3's K2 shapes")
    args = ap.parse_args()
    # The smoke runs on one card: expose only the first visible one (phase
    # 11's NCCL ranks, other processes, see every card).
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    all_cards = visible
    os.environ["CUDA_VISIBLE_DEVICES"] = (visible.split(",")[0]
                                          if visible is not None else "0")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2

    from nextbestpath_tpu_torch import kernels
    from nextbestpath_tpu_torch.assets import generate_scene, pack_generated_scene
    from nextbestpath_tpu_torch.config import default_params
    from nextbestpath_tpu_torch.draws import TorchDraws
    from nextbestpath_tpu_torch.eval.nbp_planning import (
        MAIN_PATH_SEED, MAIN_PATH_WARMUP_POSES, NBPPlanningRollout,
        main_path_move, main_path_setup, seeded_nbp)
    from nextbestpath_tpu_torch.eval.scan_rollout import ScanRollout
    from nextbestpath_tpu_torch.geometry.cameras import (CameraIntrinsics,
                                                         get_camera_RT)
    from nextbestpath_tpu_torch.ops.coverage import min_sq_dists_plain
    from nextbestpath_tpu_torch.ops.raytrace import (frame_rays, pinhole_tri_soa,
                                                     ray_hits_pinhole_plain,
                                                     ray_hits_plain, tris_to_soa)

    # 1. Device.
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"device: {kind} (count {torch.cuda.device_count()}), torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)

    # 2. Build.
    t0 = time.perf_counter()
    kernels.build()
    info = kernels.BUILD_INFO
    log(f"build: {time.perf_counter() - t0:.2f} s (compiled={info['compiled']}) "
        f"-> {os.path.relpath(str(info['path']), ROOT)}")
    for line in str(info["log"]).splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # 3. Kernels against their plain versions at the main path's shapes.
    params, assets, model = main_path_setup()
    log(f"scene simple/{MAIN_PATH_SEED}: {assets.n_tris} triangles padded to "
        f"{assets.tris.shape[0]}, lattice {assets.pose_l}x{assets.pose_h}, "
        f"{assets.n_azim} azimuths, {len(assets.gt_surface)} GT points")
    soa = tris_to_soa(torch.from_numpy(assets.tris).to(dev))
    n_tris = torch.tensor([assets.n_tris], dtype=torch.int32, device=dev)
    nt = assets.n_tris
    rows = []

    intr = CameraIntrinsics(int(params.image_height), int(params.image_width),
                            float(params.fov_degrees), float(params.camera_znear),
                            float(params.zfar))
    zn, zf = float(intr.znear), float(intr.zfar)
    n_steps = int(params.n_interpolation_steps)
    poses = main_path_move(assets, n_steps, dev)
    R, T = get_camera_RT(poses[:, :3], poses[:, 3:])
    eyes, dirs4 = frame_rays(R, T, intr)
    ph4 = pinhole_tri_soa(soa, eyes)
    dirs1, ph1 = dirs4[-1:].contiguous(), ph4[-1:].contiguous()
    k1 = {}
    for b, (d, ph) in ((1, (dirs1, ph1)), (n_steps, (dirs4, ph4))):
        got = kernels.ray_hits_pinhole(d, ph, n_tris, zn, zf)
        want = ray_hits_pinhole_plain(d, ph, n_tris, zn, zf)
        err = compare_hits(f"K1 ray_hits_pinhole ({b} frame{'s' * (b > 1)}, one launch)",
                           got, want, d.shape[0] * d.shape[1])
        n = d.shape[0] * d.shape[1]
        ops = n * nt * OPS_K1
        k1[b] = dict(
            err=err, n=n, ops=ops,
            bound=bound_ms(n * 12 + ph.numel() * 4 + n * 12, ops),
            ms=kernels.device_ms(lambda: kernels.ray_hits_pinhole(d, ph, n_tris, zn, zf), 50),
            plain_ms=kernels.device_ms(lambda: ray_hits_pinhole_plain(d, ph, n_tris, zn, zf), 3))
    b4, b1 = k1[n_steps], k1[1]
    rows.append(dict(
        name="ray_hits_pinhole", route="cuda",
        source="nextbestpath_tpu_torch/csrc/raytrace.cu",
        replaces="nextbestpath_tpu/ops/raytrace.py:234",
        max_abs_err=max(b1["err"], b4["err"]),
        ms=b4["ms"], plain_ms=b4["plain_ms"], bound_ms=b4["bound"][0],
        bound_by=b4["bound"][1], ceiling_ms=ceiling_ms(b4["ops"]), library_ms=None,
        ms_per_frame=b4["ms"] / n_steps, b1_ms=b1["ms"], b1_plain_ms=b1["plain_ms"],
        b1_bound_ms=b1["bound"][0], b1_ceiling_ms=ceiling_ms(b1["ops"]),
        shape=f"{n_steps} frames x {b1['n']} rays x {nt} tris in one launch"))

    # K2 at the scene tables' one launch (the main path's shape), the inside
    # test alone, the `insane` scene's tables and a frame's rays with an
    # origin each (k2_cases), and at n_tris = 0: the launch and the block
    # scheduling alone, the floor under the small shapes.
    k2, k2_plain = {}, {}
    cases = k2_cases(assets, eyes[-1], dirs4[-1], zn, zf)
    for case in cases:
        o, d, c_soa, c_nt = case["origins"], case["dirs"], case["soa"], case["n_tris"]
        n, lo, hi = o.shape[0], case["t_min"], case["t_max"]
        k2_plain[case["name"]] = want = ray_hits_plain(o, d, c_soa, case["nt"], lo, hi)
        err = compare_hits(f"K2 ray_hits ({case['name']})",
                           kernels.ray_hits(o, d, c_soa, c_nt, lo, hi), want, n)
        zero = torch.zeros_like(c_nt)
        ops = n * case["nt"] * OPS_K2
        k2[case["name"]] = dict(
            err=err, n=n, nt=case["nt"], lanes=kernels.ray_hits_lanes(n),
            bound=bound_ms(n * 24 + 9 * case["nt"] * 4 + n * 12, ops),
            ceiling=ceiling_ms(ops),
            ms=kernels.device_ms(lambda: kernels.ray_hits(o, d, c_soa, c_nt, lo, hi), 50),
            plain_ms=kernels.device_ms(lambda: ray_hits_plain(o, d, c_soa, case["nt"], lo, hi), 2),
            floor_ms=kernels.device_ms(lambda: kernels.ray_hits(o, d, c_soa, zero, lo, hi), 50))
    for name, r in k2.items():
        log(f"  ray_hits {name}: {r['n']} rays x {r['nt']} tris, G = {r['lanes']} lanes a ray: "
            f"{r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms, bound {r['bound'][0]:.5f} ms by "
            f"{r['bound'][1]}, no-FMA ceiling {r['ceiling']:.5f} ms, n_tris = 0 floor "
            f"{r['floor_ms']:.4f} ms)")
    if args.against:
        time_k2_against(args.against, cases, k2_plain)
    tab = k2["tables"]
    rows.append(dict(
        name="ray_hits", route="cuda",
        source="nextbestpath_tpu_torch/csrc/raytrace.cu",
        replaces="nextbestpath_tpu/ops/raytrace.py:127",
        max_abs_err=max(r["err"] for r in k2.values()),
        ms=tab["ms"], plain_ms=tab["plain_ms"], bound_ms=tab["bound"][0],
        bound_by=tab["bound"][1], ceiling_ms=tab["ceiling"], library_ms=None,
        shape=f"{tab['n']} rays x {tab['nt']} tris (the scene tables in one launch)"))

    gen = torch.Generator(device="cpu").manual_seed(0)
    g = torch.from_numpy(assets.gt_surface).to(dev).contiguous()
    n_s = 40960
    samp = g[torch.randint(0, g.shape[0], (n_s,), generator=gen).to(dev)]
    samp = (samp + 0.5 * torch.randn(n_s, 3, generator=gen).to(dev)).contiguous()
    tiling = kernels.min_sq_dists_tiling(g.shape[0], n_s, dev)
    log(f"K3 tiling at {g.shape[0]} GT x {n_s} samples: {tiling}")
    # The full count; the early poses' layout (a count below the sample
    # size, the rows past it at the sentinel, the loop cut at the count,
    # which is no multiple of the tile or the split); and an empty buffer.
    n_part = 12345
    part = torch.where((torch.arange(n_s, device=dev) < n_part)[:, None], samp,
                       torch.full_like(samp, 1e9)).contiguous()
    counts = {}
    err = 0.0
    for label, s_in, c in (("full", samp, n_s), ("partial", part, n_part),
                           ("empty", samp, 0)):
        count = torch.tensor([c], dtype=torch.int32, device=dev)
        d2_k = kernels.min_sq_dists(g, s_in, count)
        d2_p = min_sq_dists_plain(g, s_in, count)
        e = float((d2_k - d2_p).abs().max())
        log(f"K3 min_sq_dists ({label}): {g.shape[0]} GT x {n_s} samples, {c} valid, "
            f"max_abs_err(d^2) {e:.3e}, covered(<1) {float((d2_k < 1).float().mean()):.4f}")
        if not torch.equal(d2_k, d2_p):
            raise AssertionError(f"K3 disagrees with its plain version ({label} count)")
        err = max(err, e)
        counts[label] = (s_in, count)
    s_full, c_full = counts["full"]
    s_part, c_part = counts["partial"]
    ops = g.shape[0] * n_s * OPS_K3
    b, by = bound_ms(g.numel() * 4 + samp.numel() * 4 + g.shape[0] * 4, ops)
    rows.append(dict(
        name="min_sq_dists", route="cuda",
        source="nextbestpath_tpu_torch/csrc/coverage.cu",
        replaces="nextbestpath_tpu/ops/coverage.py:109",
        max_abs_err=err,
        ms=kernels.device_ms(lambda: kernels.min_sq_dists(g, s_full, c_full), 20),
        plain_ms=kernels.device_ms(lambda: min_sq_dists_plain(g, s_full, c_full), 3),
        bound_ms=b, bound_by=by, ceiling_ms=ceiling_ms(ops),
        library_ms=kernels.device_ms(lambda: torch.cdist(g, samp).min(dim=1), 5),
        partial_ms=kernels.device_ms(lambda: kernels.min_sq_dists(g, s_part, c_part), 20),
        partial_ceiling_ms=ceiling_ms(g.shape[0] * n_part * OPS_K3),
        shape=f"{g.shape[0]} GT x {n_s} samples ({n_part} valid for partial_ms)"))
    for r in rows:
        log(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms, "
            f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}, no-FMA ceiling "
            f"{r['ceiling_ms']:.4f} ms, library {r['library_ms']}) at {r['shape']}")
    rows += plan_kernel_rows(assets, soa, n_tris, int(params.max_path_len), dev)
    rows += scene_kernel_rows(params, intr, dev)
    k1_row, k3_row = rows[0], rows[2]
    log(f"  ray_hits_pinhole: {k1_row['ms_per_frame']:.4f} ms a frame in the "
        f"{n_steps}-frame launch; one frame alone {k1_row['b1_ms']:.4f} ms (plain "
        f"{k1_row['b1_plain_ms']:.3f} ms, bound {k1_row['b1_bound_ms']:.4f} ms, "
        f"ceiling {k1_row['b1_ceiling_ms']:.4f} ms)")
    log(f"  min_sq_dists: {k3_row['partial_ms']:.4f} ms at {n_part} valid samples "
        f"(ceiling {k3_row['partial_ceiling_ms']:.4f} ms)")

    # 4. The main path: the planning rollout at full width.
    warm = NBPPlanningRollout(assets, model, params=params, seed=MAIN_PATH_SEED,
                              shared_rng=True, device=dev)
    warm.run(n_poses=MAIN_PATH_WARMUP_POSES)
    del warm
    n_poses = 6
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    roll = NBPPlanningRollout(assets, model, params=params, seed=MAIN_PATH_SEED,
                              shared_rng=True, device=dev)
    t_construct = time.perf_counter() - t0
    res = roll.run(n_poses=n_poses)
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    cov = res.coverage_evolution
    log(f"rollout simple/{MAIN_PATH_SEED}, {n_poses} poses: coverage {[round(c, 4) for c in cov]}, "
        f"auc {res.auc:.4f}, points {res.n_points}")
    log(f"rollout: construction (scene tables included) {t_construct * 1e3:.1f} ms, {res.wall_time_s / n_poses * 1e3:.1f} "
        f"ms/pose ({res.steps_per_sec:.2f} poses/s), peak memory {peak:.0f} MiB, "
        f"launches {launches}")
    # Rises: the stride subsample of the metric can dip for one pose (a
    # stride sharing a factor with the count), so the best later pose is
    # held against the first.
    rises("rollout", cov)
    for name, k in launches.items():
        # The scene-axis launchers run on phase 10's path, not this one.
        if k <= 0 and not name.endswith("_scenes"):
            raise AssertionError(f"kernel {name} was not launched on the main path")
    want_launches = {"ray_hits_pinhole": 1 + 2 * n_poses, "ray_hits": 1,
                     "min_sq_dists": n_poses}
    for name, k in want_launches.items():
        if launches[name] != k:
            raise AssertionError(f"kernel {name} launched {launches[name]} times on "
                                 f"the main path, expected {k}")
    host_ms = res.wall_time_s / n_poses * 1e3

    # 5. Reference check: a small rollout on the card and on the CPU.
    small = default_params(image_height=32, image_width=56, points_per_frame=256,
                           full_pc_capacity=65536, n_gt_surface_points=2048,
                           max_path_len=32, pc2img_size=[64, 64],
                           value_map_size=[16, 16])
    s_assets = pack_generated_scene(generate_scene("simple", seed=4), params=small)
    results = {}
    for d in ("cuda", "cpu"):
        m = seeded_nbp()
        r = NBPPlanningRollout(s_assets, m, params=small, device=d, shared_rng=True,
                               draws=TorchDraws(8, torch.device(d), "cpu"))
        results[d] = r.run(n_poses=4)
    c_gpu = results["cuda"].coverage_evolution
    c_cpu = results["cpu"].coverage_evolution
    diff = max(abs(a - b) for a, b in zip(c_gpu, c_cpu))
    same_path = (results["cuda"].cam_positions.shape == results["cpu"].cam_positions.shape
                 and float(abs(results["cuda"].cam_positions
                               - results["cpu"].cam_positions).max()) < 1e-4)
    log(f"reference check (32x56, 4 poses): card {c_gpu} vs cpu {c_cpu}, "
        f"max diff {diff:.2e}, same trajectory {same_path}")
    if diff > TOL_COVERAGE or not same_path:
        raise AssertionError("the card's small rollout disagrees with the CPU's")

    # 6. The scan rollout on the main path, its pose step replayed as CUDA
    # graphs. Counts are zeroed before its construction (the scene's K2
    # launch) and read after the warm-up run, which captures the graphs,
    # and after the measured run.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    scan = ScanRollout(assets, model, params=params, device=dev)
    t_construct = time.perf_counter() - t0
    t0 = time.perf_counter()
    scan.run(n_poses=MAIN_PATH_WARMUP_POSES, seed=MAIN_PATH_SEED)
    t_warm = time.perf_counter() - t0
    setup = dict(kernels.LAUNCHES)
    res = scan.run(n_poses=n_poses, seed=MAIN_PATH_SEED)
    scan_launches = dict(kernels.LAUNCHES)
    run_launches = {k: scan_launches[k] - setup[k] for k in setup}
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    cov = res.coverage_evolution
    n_regen = sum(scan.regen_poses)
    scan_ms = res.wall_time_s / n_poses * 1e3
    log(f"scan rollout simple/{MAIN_PATH_SEED}, {n_poses} poses: coverage "
        f"{[round(c, 4) for c in cov]}, auc {res.auc:.4f}, points {res.n_points}, "
        f"regeneration poses {scan.regen_poses}")
    log(f"scan rollout: construction {t_construct * 1e3:.1f} ms, warm-up of "
        f"{MAIN_PATH_WARMUP_POSES} poses with the capture {t_warm * 1e3:.1f} ms, "
        f"{scan_ms:.2f} ms/pose ({res.steps_per_sec:.2f} poses/s) against the host "
        f"rollout's {host_ms:.2f} ms/pose, peak memory {peak:.0f} MiB; graph launches "
        f"{scan.graph_launches}, replays {scan.replays}, host reads {scan.host_reads}; "
        f"launches: construction and warm-up {setup}, run {run_launches}")
    rises("scan rollout", cov)
    retries = scan.max_plan_retries
    want_run = dict(dict.fromkeys(kernels.LAUNCHES, 0),
                    ray_hits_pinhole=1 + 2 * n_poses, min_sq_dists=n_poses,
                    bfs_field=retries * n_regen, extract_path=retries * n_regen)
    want_replays = {"pre": n_poses, "plan": n_regen, "post": n_poses}
    if (run_launches != want_run or setup["ray_hits"] != 1 or n_regen < 1
            or scan.replays != want_replays or scan.host_reads != n_poses):
        raise AssertionError(
            f"scan rollout: launches {run_launches} (expected {want_run}), K2 "
            f"{setup['ray_hits']} at construction (expected 1), replays "
            f"{scan.replays} (expected {want_replays}), host reads "
            f"{scan.host_reads} (expected {n_poses})")
    for r in rows:
        key = r["name"]
        r["launches"] = launches[key] + scan_launches[key]
        r["launches_by_path"] = {"host": launches[key], "scan": scan_launches[key]}

    # The captured step against the same step run eagerly on the card and
    # on the CPU, on the small configuration with one CPU generator's draws.
    small_scan_check("scan reference check", s_assets, small)

    # 7. The evaluation CLI's path, the capture options and the baseline.
    by_path = cli_phase(params, model, small, s_assets, dev)

    # 8. Training: collection, the training step, the driver.
    by_path["train"], f32_train = train_phase(params, assets, dev, smi)

    # 9. The scan trainer: collection as graphs, K3 on padded GT, the bf16
    # step, the driver with a resume, the card against the CPU.
    by_path["scan_train"], db9, micro9 = scan_train_phase(params, assets, small, s_assets,
                                                          dev, smi, f32_train)
    # 10. Several scenes on one card: the true batch, run_interleaved and
    # the batched random walk; the three modes' rates at B = 4 and 8.
    by_path.update(multi_scene_phase(params, small, dev, smi))
    # 11. Several processes: the DP trainer under NCCL on every card, the
    # parity checks on two gloo ranks sharing card 0 (and under NCCL on
    # two or more cards).
    by_path["dp"] = dp_phase(db9.entries, micro9, all_cards, smi)
    for r in rows:
        for path, counts in by_path.items():
            r["launches_by_path"][path] = counts[r["name"]]
            r["launches"] += counts[r["name"]]
        if r["launches"] <= 0:
            raise AssertionError(f"kernel {r['name']} was launched on no main path")

    log(smi)
    keys = ("name", "route", "source", "replaces", "launches", "launches_by_path",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "ceiling_ms",
            "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
