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
   nbp_extract_path at the main path's lattice, the procgen ``insane``/8
   and ``hard``/8 GT lattices, a 58x58 maze and the thin 4096x1 and
   1x4096 lattices, each with its eccentricity, their skip flags, and on
   the scene axis with mixed skip flags),
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
   micro step (its loss and gradients, a CUDA graph replayed from its
   second call on) and of the optimizer step, steady (a second epoch),
   and the peak memory; one accumulation cycle of
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
   full width (7 micro steps of 8) beside phase 8's f32 one, and its micro
   step replayed as a CUDA graph equal to the eager step bit for bit
   (loss, gradients, running statistics); the driver for
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

12. the MACARONS greedy next-best-view evaluation
   (``eval/macarons_nbv.py``, ``eval/object_nbv.py``) on the main path's
   scene with the default config (20000 proxy points, 1024 point-cloud and
   proxy tokens, 20 candidates) and SconeOcc and SconeVis at their
   published widths with seeded weights, in f32: (a) the learned rollout
   for 10 poses after a 1-pose warm-up, counts set to 0 just before it and
   read just after (K2 once for the tables, K1 once for the initial move
   and once a pose, K3 once a pose), coverage rising, its ms a pose and
   peak memory, then 3 poses under the profiler for the device ms of each
   stage (coverage, carve, occupancy, the Gumbel draw, gains, move), and
   the Gumbel noise's draw alone (device ms and memory); (b) the oracle
   mode for 3 poses (K1 also once a pose for the 20 candidate frames, K3
   also once a pose for the covered points and the scene-axis K3 once a
   pose for the candidates); (c) the object NBV for 4 views (K2 once a
   view); (d) small runs (32x56, 2 poses; the object NBV at 8 candidates)
   on the card against the CPU with one CPU generator's draws: the same
   picks, coverage within 1e-3; (e) the kernels at the shapes only these
   paths give them, against their plain versions bit for bit, with their
   times and bounds (K1 on the oracle's 20 frames in one launch, K3 on the
   2M-slot buffer, the scene-axis K3 on the 20 candidates' frames against
   one GT, K2 on the object's visibility rays).

13. the MACARONS online trainer (``train/train_macarons.py::
   train_macarons_online``) on the main path's scene at ``default_params()``
   (256x456 RGB-D frames, 20000 proxy points, 512 + 512 tokens, a
   262144-point surface store) with seeded ManyDepth (96 planes),
   SconeOcc and SconeVis at the published widths, in f32 without TF32:
   (a) perfect depth, the CLI's default, 8 poses after a 2-pose warm-up,
   counts set to 0 just before and read just after (K2 once, K1 1 + 3 a
   pose, K3 once a pose), coverage rising, finite losses, ms a pose, then
   2 poses under the profiler for the device ms of each stage; (b)
   ``learn_depth`` for 6 poses (the same counts), the depth step's and
   ``depth_infer``'s device ms, the step's peak memory and finite
   losses, ``render_rgbd``'s ms; (c) the full stack (learned and
   predicted depth, a memory holding another trajectory, one replay loop
   a pose, the remap every 3 poses) for 6 poses, its ms, and 4 poses
   under the profiler for the stage split (the replay and the remap must
   run); (d) ``TINY``
   (128 + 128 tokens) on the card against the CPU with the same weights
   and one CPU generator's draws: 3 perfect-depth poses (the same gains)
   and 3 of the full stack (the same picks; the remap at the second
   pose), coverage within 1e-3, losses within 1e-3 relative, and one
   depth step on the same frames (losses within 1e-3 relative, the
   gradient as close to the CPU's as the CPU's f32 gradient is to its
   f64 one); (e) K1 (one RGB-D frame with its index, a move's four
   frames), K2 (the scene tables) and K3 (the coverage call on a move's
   buffer) at the trainer's shapes against their plain versions bit for
   bit.

14. the pretrainers (``train/pretrain_depth.py``, ``train/pretrain_scone.py``,
   what ``pretrain_depth_torch.py`` and ``pretrain_scone_torch.py`` run):
   (a) ``pretrain_depth`` at ``default_params()`` (256x456 RGB-D frames,
   seeded ManyDepth with 96 planes in train mode, f32 without TF32), batch
   2, on ``simple`` 8 and 9 with the held-out ``simple``/708, 20 steps
   evaluated every 10, counts set to 0 just before and read just after
   (K2 once a scene, K1 three times a sample built, the held-out batch
   included), finite losses, ms a step and peak memory, both checkpoints
   read back, the steady ms a step (10- and 20-step runs), then 3 steps
   under the profiler for the device ms of its stages (batch, step,
   eval); (b) ``pretrain_scone`` both ways on 4 object and 2 interior
   samples at the default sizes, 20 occupancy and 20 visibility steps of
   4, the builders' ms a sample and the steps' ms and device ms,
   counts as the code gives them (K1 once a view; K2 twice an object
   sample, three times an interior one and once a walklet move tried);
   (c) at 64x114 on the card against the CPU with the same weights and
   one CPU generator's draws: 8 walks equal, 3 depth steps' losses and
   the held-out error within 1e-3 relative, a sample of each kind (the
   same decisions, points within 1e-5 of their scale) and 3 occupancy and
   visibility steps within 1e-3; (d) K1 (one 256x456 RGB-D frame with its
   index) and K2 (an interior sample's sight and candidate rays, the
   lattice's inside test) against their plain versions bit for bit, and
   the point-cloud planner's edge test on the ``insane`` lattice against
   2M points (its ms and memory; on 5,000 points the CPU's edges);
15. the policy-quality tools (``tools/*_torch.py``), their ``main``s on
   the card against a seeded full-width NBP that ``save_nbp`` writes into
   a temporary directory, each with the counts set to 0 just before and
   read just after: (a) the held-out NBP-vs-random table in bf16 on
   ``simple`` and ``normal``, 1 scene and 1 seed each, 8 poses; (b) the
   promotion gate with A against A in both modes (KEEP, equal means),
   then the batch's scenes against single-scene runs at the batch's
   seeds (AUCs within 1e-3); (c) the 101-pose protocol's driver at 4
   poses through its two processes, one level's file missing so that it
   falls back, each process loading the library this run built; (d) the
   per-level fine-tune, 2 epochs of 8 poses from the checkpoint, its
   tables at 40 poses; (e) the
   MACARONS quality table at ``--tiny``; (f) one scene head to head
   without a plot; (g) 101 poses of the main path's scan rollout at full
   width, past the point buffer's capacity: the count must end at
   capacity, runs of 40 and 70 poses from the same seed must give the
   same curve and keep their rows as the full buffer's prefix, and the
   exact coverage of the buffer (every GT point against every stored
   point) must never fall. The rollout's own metric, the JAX package's
   fixed-size stride subsample, can fall as the cloud grows with
   revisited points (JAX's does too); its falls are printed.

16. the research probes (``tools/*_torch.py``), their ``main``s in-process
   at full width, each with the counts set to 0 just before and read just
   after (every kernel of its path launched): (a) the oracle NBV against
   the random walk on one held-out ``simple`` scene, 5 poses; (b) the
   value decoder's share, a seeded full-width checkpoint in bf16, one
   held-out scene a level, 10 poses as it is and with ``value_flat``;
   then the captured ``value_flat`` rollout of the main path equal to its
   eager run bit for bit; (c) the suffix labels' reliability, a branch
   at pose 5 with 2 continuations of 5 poses; then that branch through
   the collection's ``begin`` / ``advance`` / ``snapshot`` / ``restore``
   / ``force_replan``: both continuations' row 0 at the mid-state's pose
   and planned, their paths and row-0 labels different (their draws
   are), and a restore replaying a continuation bit for bit; (d)
   ManyDepth on one window, 12 frames and 10 steps (96 planes); (e)
   online depth learning, 6 poses a run; (f) the eval gap on a seeded
   depth checkpoint that the phase writes, one trial, the plain and
   textured errors equal (procgen faces are one grey).

17. the Gumbel-max token draw's kernels (``csrc/gumbel.cu``): (a) G1
   (``kernels.gumbel_noise``) against the eager chain (``torch.rand``,
   ``clamp``, ``log``, ``neg``, ``log``, ``neg``) on two generators of one
   state, bit for bit, at (4,), the NBV cell's 20 x (2048, 20000) in one
   launch, (1024, 20000) and two odd shapes, and a ``torch.rand`` after
   both equal; (b) G2 (``kernels.gumbel_argmax``) on a seeded field of
   20,000 proxy points and 20 candidates, four of them blind, and on an
   all-masked one: its tokens equal ``torch.argmax(noise + logits)`` of
   the batched log-probabilities, and ``sample_proxy_points``'s (a token
   apart only where the two scores lie within f32 rounding); (c) both
   timed at the cell's shapes against their bound (the noise's bytes once)
   and the eager versions they replace.

Phase 3 also holds the scene-axis launches (K1, K3 and the planner
kernels over B scenes, one count, lattice, start or goal a scene) against
their plain versions and against stacked single-scene launches, bit for
bit, at B = 4 and 8 (K3 also at B = 1), K1 at an ``insane``/8 move and at
the pretrainers' 64x114 and 32x56 frames (no multiple of its 8 x 16 pixel
tile), and K3's plan as the card makes it against its host model; it
prints each K1 row's share of pairs tested after the cull
(``ops/raytrace.py::pinhole_tested_share``). K1's bound is the bytes the
function needs (``k1_bound``), or its tested pairs' operations where they
are more; the all-pairs operations the TPU kernel does are
``all_pairs_ops_ms`` in the kernels JSON.

The line before the last lists the kernels as JSON; the last line is the
device JSON. Imports nothing of JAX and reads nothing that git ignores.

    python3 chip_smoke.py --phase 14    (or 15, 16, 17)

runs phases 1, 2 and 14 (the pretrainers), 15 (the quality tools), 16
(the research probes) or 17 (the Gumbel draw's kernels) alone, a quick
check; it prints no kernels or device JSON.

    python3 chip_smoke.py --against DIR

also times K1, K1s, K2, K3, K3s and the planner kernels of another
checkout of this repo (its own ``nextbestpath_tpu_torch/kernels.py``, built
into its own ``_build/``) at phase 3's shapes (K1 at a move's four frames,
one frame and an ``insane``/8 move; K1s at B = 4; K3 at the full and the
partial count; K3s at B = 4 and 8; K2 at its four shapes; the planner
kernels at 17x17, ``insane``/8 and the maze) and at phase 12(e)'s (K1 on
the 20 candidate frames, K3 on the 2M-slot buffer, K3s on the 20
candidates), each held to this tree's plain version, in the order DIR,
this tree, this tree, DIR, and prints one JSON line a run, kernel and
shape (``time_against``).
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import importlib.util
import inspect
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

# K1's bytes as the function needs them: a ray's direction read and its
# t, count and index written (24 B), and each frame's pinhole SoA read once
# (40 B a triangle).
BYTES_K1_RAY, BYTES_K1_TRI = 24, 40

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
TOL_MACARONS_LOSS = 1e-3  # TINY trainer: card vs CPU losses, relative


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


def gt_lattice(a, dev):
    """The GT edge table (4, L, H) of scene ``a``, built on the card (K2),
    and its start node (2,) int64."""
    import torch
    from nextbestpath_tpu_torch.ops.raytrace import tris_to_soa
    from nextbestpath_tpu_torch.sim.tables import build_scene_tables

    tables = build_scene_tables(tris_to_soa(torch.from_numpy(a.tris).to(dev)),
                                torch.tensor([a.n_tris], dtype=torch.int32, device=dev),
                                torch.from_numpy(a.pose_origin).to(dev), a.pose_l, a.pose_h)
    start = torch.tensor([int(a.start_cam_idx[0]), int(a.start_cam_idx[2])],
                         dtype=torch.int64, device=dev)
    return tables.gt_edge_blocked.contiguous(), start


def plan_cases(assets, insane, hard, dev):
    """The planner kernels' lattices at phase 3, each (name, blocked, start):
    the main path's 17x17 GT edge table from its start pose, the procgen
    ``insane``/8 (58x58) and ``hard``/8 (40x40) GT tables from theirs, a
    58x58 serpentine maze from a corner, and the long thin open lattices
    4096x1 and 1x4096 (the kernel's one-block path) from an end."""
    import torch
    zero = torch.zeros(2, dtype=torch.int64, device=dev)
    thin = torch.zeros((4, 4096, 1), dtype=torch.bool, device=dev)
    return [("main", *gt_lattice(assets, dev)), ("insane", *gt_lattice(insane, dev)),
            ("maze", serpentine(58, 58, dev), zero), ("hard", *gt_lattice(hard, dev)),
            ("4096x1", thin, zero),
            ("1x4096", thin.reshape(4, 1, 4096).contiguous(), zero)]


# The planner shapes that phase 3 times (and ``--against`` times in both
# trees); the others are held to the plain versions and timed alone.
PLAN_TIMED = ("main", "insane", "maze")


def plan_kernel_rows(cases, max_len, dev):
    """nbp_bfs_field and nbp_extract_path against their plain versions,
    integer-exact, at ``cases`` (plan_cases), the path from each case's
    farthest reachable node (past max_len on the maze, the procgen
    lattices and the thin ones); the skip flag (all INF; path -1, length 0,
    unreachable) and a clear flag (the outputs without one). Times both
    kernels at every case, the plain versions at PLAN_TIMED, and P1 at
    the case's shape with every edge blocked (its floor: the launch,
    staging the flags, the masks, no level). Returns the
    kernels JSON rows at the main path's case and the PLAN_TIMED cases of
    both kernels for ``time_against``."""
    import torch
    from nextbestpath_tpu_torch import kernels
    from nextbestpath_tpu_torch.planning.grid_paths import (
        INF, bfs_distance_field_plain, extract_path_plain)

    out, against = {}, []
    yes = torch.ones((), dtype=torch.bool, device=dev)
    no = torch.zeros((), dtype=torch.bool, device=dev)
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
        skip_d = kernels.bfs_field(blocked, st, yes)
        skip_p, skip_m = kernels.extract_path(dist_k, blocked, goal, max_len, yes)
        clear = kernels.extract_path(dist_k, blocked, goal, max_len, no)
        skips = (bool((skip_d == INF).all()) and bool((skip_p == -1).all())
                 and skip_m.tolist() == [0, 0]
                 and torch.equal(kernels.bfs_field(blocked, st, no), dist_k)
                 and torch.equal(clear[0], path_k) and torch.equal(clear[1], meta_k))
        log(f"planner kernels ({name}): {L}x{H} lattice, {int(reach.sum())} reachable, "
            f"eccentricity {ecc}, path length {int(len_p)} of {ecc} (max_len {max_len}), "
            f"equal to the plain versions: {same}; skip flags: {skips}")
        if not (same and skips):
            raise AssertionError(f"the planner kernels disagree with their plain versions ({name})")
        n = L * H
        timed = name in PLAN_TIMED
        if timed:
            def path_ok(got, path_p=path_p, len_p=len_p, reach_p=reach_p):
                return (torch.equal(got[0], path_p) and int(got[1][0]) == int(len_p)
                        and bool(got[1][1]) == bool(reach_p))
            at = f"{name}, {L}x{H} lattice"
            against += [("bfs_field", at, lambda kern, b=blocked, s=st: kern.bfs_field(b, s),
                         dist_p),
                        ("extract_path", at,
                         lambda kern, d=dist_p, b=blocked, g=goal: kern.extract_path(d, b, g,
                                                                                     max_len),
                         path_ok)]
        walled = torch.ones_like(blocked)
        out[name] = dict(
            ecc=ecc,
            shape=f"{L}x{H} lattice, eccentricity {ecc}, path to the farthest node "
                  f"(max_len {max_len})",
            bfs=dict(ms=kernels.device_ms(lambda: kernels.bfs_field(blocked, st), 50),
                     skip_ms=kernels.device_ms(lambda: kernels.bfs_field(blocked, st, yes), 50),
                     floor_ms=kernels.device_ms(lambda: kernels.bfs_field(walled, st), 50),
                     plain_ms=wall_ms(lambda: bfs_distance_field_plain(blocked, st, L, H), 5)
                     if timed else None,
                     bound=bound_ms(4 * n + 16 + 4 * n, n * OPS_BFS_NODE, PEAK_INT32_OPS)),
            walk=dict(ms=kernels.device_ms(
                          lambda: kernels.extract_path(dist_k, blocked, goal, max_len), 50),
                      skip_ms=kernels.device_ms(
                          lambda: kernels.extract_path(dist_k, blocked, goal, max_len, yes), 50),
                      plain_ms=wall_ms(lambda: extract_path_plain(
                          dist_p, blocked, goal, L, H, max_len), 5) if timed else None,
                      bound=bound_ms(16 + 4 + ecc * BYTES_WALK_STEP + 8 * max_len + 8,
                                     ecc * OPS_WALK_STEP, PEAK_INT32_OPS)))
        for k in ("bfs", "walk"):
            r = out[name][k]
            plain_s = f"{r['plain_ms']:.3f} ms" if r["plain_ms"] is not None else "not timed"
            floor_s = f", every edge blocked {r['floor_ms']:.4f} ms" if k == "bfs" else ""
            log(f"  {k} ({name}, eccentricity {ecc}): {r['ms']:.4f} ms, skipped "
                f"{r['skip_ms']:.4f} ms{floor_s} (plain {plain_s}, bound "
                f"{r['bound'][0]:.3g} ms by {r['bound'][1]})")
    main = out["main"]
    rows = [dict(name=name, route="cuda", source="nextbestpath_tpu_torch/csrc/plan.cu",
                 replaces=rep, max_abs_err=0.0, ms=main[k]["ms"],
                 plain_ms=main[k]["plain_ms"], bound_ms=main[k]["bound"][0],
                 bound_by=main[k]["bound"][1], ceiling_ms=None, library_ms=None,
                 shape=main["shape"], skip_ms=main[k]["skip_ms"],
                 **{f"{c}_ms": out[c][k]["ms"] for c in out if c != "main"})
            for name, k, rep in (
                ("bfs_field", "bfs", "nextbestpath_tpu/planning/grid_paths.py:102 (XLA while_loop)"),
                ("extract_path", "walk", "nextbestpath_tpu/planning/grid_paths.py:160 (XLA while_loop)"))]
    return rows, against


def other_kernels(tree):
    """``nextbestpath_tpu_torch/kernels.py`` of the checkout ``tree``, built
    into its own ``_build/``."""
    spec = importlib.util.spec_from_file_location(
        "_other_kernels", os.path.join(tree, "nextbestpath_tpu_torch", "kernels.py"))
    other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    other.build()
    return other


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


def k2_cases(assets, insane, eye, dirs, znear, zfar):
    """K2's inputs at phase 3: ``tables``, the 7 L H rays of the main path's
    planner tables in the one launch of sim/tables.py::build_scene_tables;
    ``inside``, their first 3 L H, the inside test alone; ``insane``, the
    tables of the procgen ``insane`` scene ``insane`` (seed 8, 58x58
    lattice, 2,784 triangles); ``frame``, the rays ``dirs`` (N, 3) of one frame of the main
    path's move, each with its own copy of ``eye`` (3,) as its origin, in
    (znear, zfar). Dicts of origins, dirs, soa, the triangle count as an int
    (nt) and as a device tensor (n_tris), t_min and t_max."""
    import torch
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
    return [main, tables("inside", assets, 3 * assets.pose_l * assets.pose_h),
            tables("insane", insane), frame]


def k1_bound(n_rays, counts, share):
    """K1's bound over frames of n_rays rays with triangle counts ``counts``
    (one a frame), of which a share ``share`` of the pairs is tested: the
    larger of the bytes the function needs (the rays read, the outputs
    written, each frame's SoA once) over the memory rate and the tested
    pairs' operations over the f32 rate, as (ms, "bytes" or "operations"),
    and the all-pairs operations' time alone (what the TPU kernel does)."""
    pairs = n_rays * sum(counts)
    bound = bound_ms(len(counts) * n_rays * BYTES_K1_RAY + sum(counts) * BYTES_K1_TRI,
                     share * pairs * OPS_K1)
    return bound, pairs * OPS_K1 / PEAK_F32_FLOPS * 1e3


def check_k3_plan(label, counts, n_g, n_s):
    """K3's plan as the card makes it (kernels.min_sq_dists_device_plan) on
    ``counts`` (int32 on the card, one a scene) against its host model
    (kernels.min_sq_dists_plan): the counter at 0, the chunk and the prefix
    of the items over the scenes equal."""
    from nextbestpath_tpu_torch import kernels
    counts = counts.reshape(-1)
    plan = kernels.min_sq_dists_plan(counts.tolist(), n_g, n_s, kernels.min_sq_dists_blocks())
    want = [0, plan["chunk"]] + plan["prefix"]
    dev_plan = kernels.min_sq_dists_device_plan(counts, n_g, n_s).tolist()
    if dev_plan != want:
        raise AssertionError(f"{label}: K3's plan on the card {dev_plan[:12]} differs from its "
                             f"host model {want[:12]}")
    return plan


def k1_call(kern, dirs, ph, nt, zn, zf, width, scenes=False):
    """K1 (``scenes``: its scene axis) of the kernels module ``kern``, with
    the frames' width where the launcher takes one (a checkout from before
    the pixel tiles takes none)."""
    fn = kern.ray_hits_pinhole_scenes if scenes else kern.ray_hits_pinhole
    if "width" in inspect.signature(fn).parameters:
        return fn(dirs, ph, nt, zn, zf, width)
    return fn(dirs, ph, nt, zn, zf)


def time_against(tree, cases):
    """Kernels of the checkout ``tree`` and of this one at ``cases``, each
    (kernel, shape, run, want): ``run(kern)`` launches the kernel of the
    kernels module ``kern``; ``want`` is this tree's plain version's result
    (compared with torch.equal) or a function that checks a result. Each
    run is checked and timed in the order tree, this, this, tree; one JSON
    line a run and case."""
    import torch
    from nextbestpath_tpu_torch import kernels
    other = other_kernels(tree)
    for label, kern in ((tree, other), (".", kernels), (".", kernels), (tree, other)):
        for name, shape, run, want in cases:
            got = run(kern)
            if callable(want):
                ok = want(got)
            else:
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                ok = all(torch.equal(g, w) for g, w in zip(got, want))
            if not ok:
                raise AssertionError(f"{name} of {label} disagrees with the plain "
                                     f"version at {shape}")
            print(json.dumps(dict(tree=label, kernel=name, shape=shape,
                                  ms=kernels.device_ms(lambda: run(kern), 50))), flush=True)


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


def kernel_device_ms(fn, k=6):
    """One call of ``fn`` under the profiler: the device ms of all its
    kernels and the k largest by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from nextbestpath_tpu_torch.profile_rollout import _is_annotation
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not _is_annotation(e):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:k]
    return sum(by_name.values()), [(name[:60], ms) for name, ms in top]


def prewrite_memory(mem, path, H, W, n_proxy):
    """Another trajectory (slot 1) already in the memory: 8 depth maps of
    H x W and an occupancy snapshot of n_proxy proxy points, from a seed."""
    import numpy as np
    rng = np.random.default_rng(7)
    for i in range(8):
        d = rng.uniform(2.0, 30.0, (H, W)).astype(np.float32)
        mem.save_depth(path, 1, i, d, np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    mem.save_occupancy(path, 1, rng.uniform(0, 40, size=(n_proxy, 3)),
                       rng.uniform(size=(n_proxy, 1)), rng.uniform(size=(n_proxy, 1)),
                       rng.uniform(size=(n_proxy, 98)), np.ones((n_proxy, 1)))


def finite(label, values, n=None):
    import math
    if (n is not None and len(values) != n) or not all(math.isfinite(v) for v in values):
        raise AssertionError(f"{label}: expected {n} finite values, got {values}")


def macarons_train_phase(params, assets, dev, smi):
    """Phase 13 (module docstring). Returns the launches by kernel of its
    three counted paths: {"macarons_train", "macarons_depth",
    "macarons_full"}."""
    import shutil
    import tempfile

    import torch
    from nextbestpath_tpu_torch import kernels
    from nextbestpath_tpu_torch.assets import generate_scene, pack_generated_scene
    from nextbestpath_tpu_torch.config import default_params
    from nextbestpath_tpu_torch.draws import TorchDraws
    from nextbestpath_tpu_torch.eval.nbp_planning import MAIN_PATH_SEED
    from nextbestpath_tpu_torch.geometry.cameras import CameraIntrinsics
    from nextbestpath_tpu_torch.models.macarons import Macarons
    from nextbestpath_tpu_torch.sim.memory import Memory
    from nextbestpath_tpu_torch.sim.sensor import capture_rgbd
    from nextbestpath_tpu_torch.train.train_macarons import (
        AUG_SHAPES, MACARONS_STAGES, TINY, MacaronsTrainState, make_depth_steps,
        train_macarons_online)

    t_phase = time.perf_counter()
    zero = dict.fromkeys(kernels.LAUNCHES, 0)
    seed = MAIN_PATH_SEED
    H, W = int(params.image_height), int(params.image_width)

    # One seeded bundle a frame size, reused: a state takes the modules'
    # variables when it is made, and training never writes them in place.
    base = Macarons.create(seed, image_height=H, image_width=W, device=dev)
    base_tiny = Macarons.create(seed, image_height=32, image_width=56)

    def state(p=params, d=dev):
        m = base if int(p.image_height) == H else base_tiny
        return MacaronsTrainState.create(seed, params=p, model=m, device=d)

    def counted(run):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        return (res, dict(kernels.LAUNCHES), torch.cuda.max_memory_allocated() / 2 ** 20,
                time.perf_counter() - t0)

    def train(st, n_poses, p=params, **kw):
        return train_macarons_online(assets, st, params=p, n_poses=n_poses, seed=seed,
                                     verbose=False, **kw)

    def launches_for(n):
        # K2 the scene tables; K1 the first move, then a pose's frame, its
        # move's four frames (one launch) and the arrival frame; K3 the metric.
        # G1 the proxy tokens' noise.
        return dict(zero, ray_hits=1, ray_hits_pinhole=1 + 3 * n, min_sq_dists=n,
                    gumbel_noise=n)

    def lap(label, t0):
        log(f"phase 13({label}) wall time {time.perf_counter() - t0:.1f} s")
        return time.perf_counter()

    # (a) Perfect depth, the CLI's default, after a 2-pose warm-up.
    t_part = time.perf_counter()
    train(state(), 2)
    n_a = 8
    st = state()
    n_depth = sum(v.numel() for v in st.model.depth_vars.values())
    n_occ = sum(v.numel() for v in st.model.occ_vars.values())
    n_vis = sum(v.numel() for v in st.model.vis_vars.values())
    logs, la, peak, wall = counted(lambda: train(st, n_a))
    cov = logs["coverage"]
    log(f"phase 13(a) MACARONS online trainer, perfect depth, simple/{seed}, {H}x{W}, "
        f"{int(params.points_per_frame)} points a frame, {int(params.n_proxy_points)} proxy "
        f"points, 512 + 512 tokens, SconeOcc {n_occ:,} / SconeVis {n_vis:,} parameters "
        f"(ManyDepth {n_depth:,}, unused), {n_a} poses [{smi}]: {wall / n_a * 1e3:.2f} ms a "
        f"pose, peak memory {peak:.0f} MiB, coverage {[round(c, 4) for c in cov]}, gains "
        f"{logs['gain']}, occ loss {[round(v, 4) for v in logs['occ_loss']]}, cov loss "
        f"{[round(v, 4) for v in logs['cov_loss']]}, launches {la}")
    rises("phase 13(a)", cov)
    finite("phase 13(a) occ loss", logs["occ_loss"], n_a)
    finite("phase 13(a) cov loss", logs["cov_loss"], n_a)
    expect_launches("phase 13(a)", la, launches_for(n_a))
    st = state()
    stage, prof_ms = nbv_stage_ms(lambda: train(st, 2), 2, MACARONS_STAGES)
    log(f"phase 13(a) device ms a pose by stage (2 poses profiled, {prof_ms:.2f} ms a pose "
        f"under the profiler, the scene tables included) [{smi}]: "
        + ", ".join(f"{k} {v:.3f}" for k, v in stage.items()))
    t_part = lap("a", t_part)

    # (b) Online depth learning with the full-width seeded ManyDepth.
    n_b = 6
    st = state()
    logs_b, lb, peak_b, wall_b = counted(lambda: train(st, n_b, learn_depth=True))
    log(f"phase 13(b) learn_depth, ManyDepth {n_depth:,} parameters at {H}x{W}, 96 planes, "
        f"{n_b} poses [{smi}]: {wall_b / n_b * 1e3:.2f} ms a pose, peak memory {peak_b:.0f} "
        f"MiB, depth loss {[round(v, 5) for v in logs_b['depth_loss']]}, coverage "
        f"{[round(c, 4) for c in logs_b['coverage']]}, launches {lb}")
    finite("phase 13(b) depth loss", logs_b["depth_loss"], n_b - 3)
    expect_launches("phase 13(b)", lb, launches_for(n_b))
    intr = CameraIntrinsics(H, W, float(params.fov_degrees), float(params.camera_znear),
                            float(params.zfar))
    soa = tris_to_soa_on(assets, dev)
    n_tris = torch.tensor([assets.n_tris], dtype=torch.int32, device=dev)
    colors = torch.from_numpy(assets.tri_colors).to(dev)
    poses = start_neighbour_poses(assets, dev)
    frames = [capture_rgbd(soa, n_tris, p5, intr, tri_colors=colors) for p5 in poses]
    step, infer = make_depth_steps(st.model, st.depth_tx, intr, params)
    aug = TorchDraws(0, dev).uniforms("depth", AUG_SHAPES)
    tgt, R, T = frames[1][0], frames[1][2], frames[1][3]
    alphas = [frames[0], frames[2], frames[3]]
    xa = torch.stack([f[0] for f in alphas])
    Ra = torch.stack([f[2] for f in alphas])
    Ta = torch.stack([f[3] for f in alphas])

    def depth_step():
        return step(st.model.depth_vars, st.depth_opt_state, tgt, R, T, xa, Ra, Ta, aug)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    _, _, photo, reg = depth_step()
    step_peak = (torch.cuda.max_memory_allocated() - mem0) / 2 ** 20
    finite("phase 13(b) depth step losses", [float(photo), float(reg)], 2)
    step_ms = kernels.device_ms(depth_step, reps=3)
    infer_ms = kernels.device_ms(lambda: infer(st.model.depth_vars, tgt, R, T, xa[:2], Ra[:2],
                                               Ta[:2]), reps=5)

    def render():
        return capture_rgbd(soa, n_tris, poses[1], intr, tri_colors=colors)

    render_ms = kernels.device_ms(render, reps=20)
    log(f"phase 13(b) depth_step (jitter, flip, ManyDepth forward and backward, photometric + "
        f"regularity, Adam) [{smi}]: {step_ms:.2f} device ms, peak {step_peak:.0f} MiB over "
        f"the live tensors, photometric {float(photo):.5f}, regularity {float(reg):.5f}; "
        f"depth_infer {infer_ms:.2f} device ms; render_rgbd {render_ms:.4f} device ms a frame")
    for label, fn in (("depth_step", depth_step), ("render_rgbd", render)):
        total, top = kernel_device_ms(fn)
        log(f"phase 13(b) {label} under the profiler [{smi}]: {total:.3f} device ms in "
            f"kernels; the largest: " + "; ".join(f"{k} {v:.3f}" for k, v in top))
    t_part = lap("b", t_part)

    # (c) The whole stack: learned and predicted depth, a memory holding
    # another trajectory, one replay loop a pose, the remap every 3 poses.
    p_c = default_params(remap_every_n_poses=3)
    n_c = 6
    tmp = tempfile.mkdtemp(prefix="macarons_memory_")
    try:
        def full_stack(st, path, n=n_c):
            mem = Memory([path], n_trajectories=2, current_epoch=0)
            prewrite_memory(mem, path, H, W, int(params.n_proxy_points))
            return train(st, n, p=p_c, learn_depth=True, use_perfect_depth=False,
                         memory=mem, scene_memory_path=path, memory_replay_loops=1), mem

        st = state()
        (logs_c, mem), lc, peak_c, wall_c = counted(lambda: full_stack(st, tmp))
        log(f"phase 13(c) full stack (learn_depth, predicted depth, memory replay 1 loop, "
            f"remap every 3), {n_c} poses [{smi}]: {wall_c / n_c * 1e3:.2f} ms a pose "
            f"(memory writes included), peak memory {peak_c:.0f} MiB, coverage "
            f"{[round(c, 4) for c in logs_c['coverage']]}, depth loss "
            f"{[round(v, 5) for v in logs_c['depth_loss']]}, replay occ "
            f"{[round(v, 4) for v in logs_c['replay_occ_loss']]}, replay cov "
            f"{[round(v, 4) for v in logs_c['replay_cov_loss']]}, launches {lc}")
        finite("phase 13(c) replay occ loss", logs_c["replay_occ_loss"], n_c)
        finite("phase 13(c) replay cov loss", logs_c["replay_cov_loss"], n_c)
        finite("phase 13(c) depth loss", logs_c["depth_loss"], n_c - 3)
        expect_launches("phase 13(c)", lc, launches_for(n_c))
        if mem.n_frames(tmp, 0) != n_c or mem.n_depths(tmp, 0) != n_c:
            raise AssertionError("phase 13(c): the memory does not hold the trajectory")
        shutil.rmtree(tmp)
        os.makedirs(tmp)
        # 4 poses: the remap runs at the fourth (pose index 3).
        st_c = state()
        n_prof = 4
        stage_c, prof_c = nbv_stage_ms(lambda: full_stack(st_c, tmp, n_prof), n_prof,
                                       MACARONS_STAGES)
        log(f"phase 13(c) device ms a pose by stage ({n_prof} poses profiled, {prof_c:.2f} ms a "
            f"pose under the profiler) [{smi}]: "
            + ", ".join(f"{k} {v:.3f}" for k, v in stage_c.items()))
        if not stage_c.get("replay", 0) > 0 or "remap" not in stage_c:
            raise AssertionError(f"phase 13(c): the replay or the remap did not run: {stage_c}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t_part = lap("c", t_part)

    # (d) TINY on the card against the CPU: 3 poses of (a) and of (c) (the
    # remap at the second pose), the same seeded weights and one CPU
    # generator's draws, then one depth step on the same frames.
    tiny = default_params(**TINY)
    tiny_c = default_params(**TINY, remap_every_n_poses=2)
    t_assets = pack_generated_scene(generate_scene("simple", seed=2), params=tiny)
    # The CPU tests' token counts: the CPU's SCONE steps bound the phase.
    tiny_tokens = dict(n_tokens=128, n_proxy_tokens=128)
    runs = {}
    for d in ("cuda", "cpu"):
        dd = torch.device(d)
        runs[d, "a"] = train_macarons_online(
            t_assets, state(tiny, dd), params=tiny, n_poses=3, seed=3, verbose=False,
            draws=TorchDraws(3, dd, "cpu"), **tiny_tokens)
        path = tempfile.mkdtemp(prefix="macarons_memory_")
        try:
            mem = Memory([path], n_trajectories=2, current_epoch=0)
            prewrite_memory(mem, path, 32, 56, 128)
            runs[d, "c"] = train_macarons_online(
                t_assets, state(tiny_c, dd), params=tiny_c, n_poses=3, seed=3, verbose=False,
                draws=TorchDraws(3, dd, "cpu"), learn_depth=True, use_perfect_depth=False,
                memory=mem, scene_memory_path=path, memory_replay_loops=1, **tiny_tokens)
            runs[d, "c_poses"] = mem.load_poses(path)
        finally:
            shutil.rmtree(path, ignore_errors=True)
    for mode in ("a", "c"):
        g, c = runs["cuda", mode], runs["cpu", mode]
        diff = max(abs(a - b) for a, b in zip(g["coverage"], c["coverage"]))
        keys = ("occ_loss", "cov_loss", "replay_occ_loss", "replay_cov_loss")
        loss_err = max([abs(a - b) / max(abs(b), 1e-6) for k in keys
                        for a, b in zip(g[k], c[k])] + [0.0])
        # Perfect depth: the same gains. Predicted depth: the same picks
        # (the poses the memory keeps); a gain counts points that the
        # predicted depth's error mask (a threshold) may keep or drop.
        if mode == "a":
            same = g["gain"] == c["gain"]
        else:
            same = (runs["cuda", "c_poses"] == runs["cpu", "c_poses"]
                    and all(abs(a - b) <= 2 for a, b in zip(g["gain"], c["gain"])))
        same = same and all(len(g[k]) == len(c[k]) for k in keys)
        log(f"phase 13(d) TINY {'perfect depth' if mode == 'a' else 'full stack'}, "
            f"{len(g['coverage'])} poses, "
            f"card vs CPU: coverage {g['coverage']} vs {c['coverage']} (max diff {diff:.2e}), "
            f"gains {g['gain']} vs {c['gain']}, same picks {same}, largest relative loss "
            f"difference {loss_err:.2e}")
        if diff > TOL_COVERAGE or not same or loss_err > TOL_MACARONS_LOSS:
            raise AssertionError("phase 13(d): the card's trainer disagrees with the CPU's")
    tiny_depth_step_check(tiny, t_assets, state)
    t_part = lap("d", t_part)
    macarons_kernel_checks(params, assets, dev, smi)
    lap("e", t_part)
    log(f"phase 13 wall time {time.perf_counter() - t_phase:.1f} s [{smi}]")
    return {"macarons_train": la, "macarons_depth": lb, "macarons_full": lc}


def pretrain_phase(dev, smi):
    """Phase 14 (module docstring). Returns the launches by kernel of its
    two counted paths: {"pretrain_depth": ..., "pretrain_scone": ...}."""
    import tempfile

    import torch
    from nextbestpath_tpu_torch import kernels
    from nextbestpath_tpu_torch.assets import generate_scene, pack_generated_scene
    from nextbestpath_tpu_torch.config import default_params
    from nextbestpath_tpu_torch.geometry.cameras import CameraIntrinsics
    from nextbestpath_tpu_torch.models.manydepth import ManyDepth, flax_init_
    from nextbestpath_tpu_torch.train import pretrain_scone as PS
    from nextbestpath_tpu_torch.train.pretrain_depth import (
        DEPTH_STAGES, load_depth_checkpoint, pretrain_depth)

    t_phase = time.perf_counter()
    zero = dict.fromkeys(kernels.LAUNCHES, 0)
    params = default_params()
    H, W = int(params.image_height), int(params.image_width)
    scenes = [pack_generated_scene(generate_scene("simple", seed=s), params=params)
              for s in (8, 9)]
    ev = pack_generated_scene(generate_scene("simple", seed=708), params=params)

    def counted(run):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        return (res, dict(kernels.LAUNCHES), torch.cuda.max_memory_allocated() / 2 ** 20,
                time.perf_counter() - t0)

    # (a) The depth pretrainer at full width: batch 2, 96 planes.
    n_steps, batch = 20, 2
    with tempfile.TemporaryDirectory(prefix="depth_pre_") as tmp:
        def depth_run(steps=n_steps, out=tmp):
            model = flax_init_(ManyDepth(CameraIntrinsics(H, W)), 8)
            return pretrain_depth(scenes, ev, steps=steps, batch=batch, seed=8, out_dir=out,
                                  log_dir=out, eval_every=10, image_height=H, image_width=W,
                                  params=params, model=model, verbose=False, device=dev)

        depth_run(2, os.path.join(tmp, "warm"))
        (model, best), la, peak, wall = counted(depth_run)
        with open(os.path.join(tmp, "depth_pre_loss.json")) as f:
            log_a = json.load(f)
        losses = log_a["loss"]
        log(f"phase 14(a) pretrain_depth, ManyDepth at {H}x{W}, 96 planes, batch {batch}, "
            f"simple/8-9 + held-out simple/708, {n_steps} steps, eval every 10 [{smi}]: "
            f"{wall / n_steps * 1e3:.2f} ms a step (scene tables, the held-out batch and 2 "
            f"evaluations with their checkpoints included), peak memory {peak:.0f} MiB, loss "
            f"{losses[0]:.5f} -> {losses[-1]:.5f}, held-out error "
            f"{[round(e['err'], 4) for e in log_a['eval_err']]}, launches {la}")
        finite("phase 14(a) losses", losses, n_steps)
        finite("phase 14(a) held-out errors", [e["err"] for e in log_a["eval_err"]], 2)
        # A sample's walk: K1 its three frames, G1 its cell and two moves.
        expect_launches("phase 14(a)", la, dict(zero, ray_hits=len(scenes) + 1,
                                                ray_hits_pinhole=3 * batch * (n_steps + 1),
                                                gumbel_noise=3 * batch * (n_steps + 1)))
        for name in ("depth_pre_best.ckpt", "depth_pre_latest.ckpt"):
            back = ManyDepth(CameraIntrinsics(H, W)).to(dev)
            load_depth_checkpoint(os.path.join(tmp, name), back)
            if name.endswith("latest.ckpt") and not all(
                    torch.equal(v, model.state_dict()[k])
                    for k, v in back.state_dict().items()):
                raise AssertionError("phase 14(a): the latest checkpoint does not read back")
        # Steady steps: two runs that evaluate only at their last step,
        # 10 steps apart, so that the set-up and the evaluation cancel.
        walls = []
        for steps in (10, 20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model_s = flax_init_(ManyDepth(CameraIntrinsics(H, W)), 8)
            pretrain_depth(scenes, ev, steps=steps, batch=batch, seed=8,
                           out_dir=os.path.join(tmp, "steady"), log_dir=os.path.join(tmp, "steady"),
                           eval_every=1000, image_height=H, image_width=W, params=params,
                           model=model_s, verbose=False, device=dev)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        steady_ms = (walls[1] - walls[0]) / 10 * 1e3
        stage, prof_ms = nbv_stage_ms(lambda: depth_run(3, os.path.join(tmp, "prof")), 3,
                                      DEPTH_STAGES)
        log(f"phase 14(a) steady {steady_ms:.2f} ms a step (batch and step, from 10- and 20-step "
            f"runs); device ms a step by stage (3 steps profiled, {prof_ms:.2f} ms a step under "
            f"the profiler, tables, the held-out batch and an evaluation included) [{smi}]: "
            + ", ".join(f"{k} {v:.3f}" for k, v in stage.items()))

    # (b) The SCONE pretrainers ("both") on 4 object and 2 interior samples.
    def build_samples():
        out, times = [], []
        for seed in range(4):
            t0 = time.perf_counter()
            out.append(PS.make_pretrain_sample(seed, device=dev))
            times.append(time.perf_counter() - t0)
        for seed in range(2):
            t0 = time.perf_counter()
            out.append(PS.make_interior_sample(seed, scenes=2, device=dev))
            times.append(time.perf_counter() - t0)
        return out, times

    build_samples()
    PS._SCENE_CACHE.clear()
    (samples, times), lb_samples, _, _ = counted(build_samples)
    n_sc = 20

    def scone_run():
        t0 = time.perf_counter()
        _, occ_l = PS.pretrain_scone_occ(n_steps=n_sc, samples=samples, batch=4,
                                         verbose=False, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, vis_l = PS.pretrain_scone_vis(n_steps=n_sc, samples=samples, batch=4,
                                         verbose=False, device=dev)
        torch.cuda.synchronize()
        return occ_l, vis_l, t1 - t0, time.perf_counter() - t1

    (occ_l, vis_l, t_occ, t_vis), lb_steps, peak_b, _ = counted(scone_run)
    lb = {k: lb_samples[k] + lb_steps[k] for k in lb_samples}
    occ_dev, _ = kernel_device_ms(lambda: PS.pretrain_scone_occ(
        n_steps=1, samples=samples, batch=4, verbose=False, device=dev))
    vis_dev, _ = kernel_device_ms(lambda: PS.pretrain_scone_vis(
        n_steps=1, samples=samples, batch=4, verbose=False, device=dev))
    log(f"phase 14(b) pretrain_scone both, 4 object + 2 interior samples (1024 partial "
        f"points, 512 queries, 16 candidates, 64x114 depth frames) [{smi}]: a sample "
        f"{[round(t * 1e3, 1) for t in times]} ms (object, object, object, object, interior, "
        f"interior; the first interior one packs its scene), occupancy {n_sc} steps of 4 "
        f"{t_occ / n_sc * 1e3:.2f} ms a step, {occ_dev:.3f} device ms in kernels (loss "
        f"{occ_l[0]:.4f} -> {occ_l[-1]:.4f}), visibility {t_vis / n_sc * 1e3:.2f} ms a step, "
        f"{vis_dev:.3f} device ms ({vis_l[0]:.4f} -> {vis_l[-1]:.4f}), "
        f"peak memory of the steps {peak_b:.0f} MiB, launches {lb}")
    finite("phase 14(b) occ losses", occ_l, n_sc)
    finite("phase 14(b) vis losses", vis_l, n_sc)
    # A sample: K1 once a view; an object sample K2 twice (the inside test
    # and the candidates' visibility rays), an interior one three times
    # (the sight carving, the candidates' inside test, their coverage
    # rays) and once a walklet move tried (one to four a move).
    k2_lo, k2_hi = 4 * 2 + 2 * (3 + 3), 4 * 2 + 2 * (3 + 4 * 3)
    if (lb["ray_hits_pinhole"] != 4 * 3 + 2 * 4 or not k2_lo <= lb["ray_hits"] <= k2_hi
            or lb_steps["ray_hits"] or lb_steps["ray_hits_pinhole"]):
        raise AssertionError(f"phase 14(b): launches {lb_samples} building the samples "
                             f"(K1 20, K2 {k2_lo}-{k2_hi} expected), {lb_steps} training")

    # (c) TINY on the card against the CPU, one CPU generator's draws.
    pretrain_tiny_check(dev, smi)
    # (d) K1 and K2 at this path's shapes against their plain versions.
    pretrain_kernel_checks(params, scenes[0], samples[4], dev, smi)
    log(f"phase 14 wall time {time.perf_counter() - t_phase:.1f} s [{smi}]")
    return {"pretrain_depth": la, "pretrain_scone": lb}


def pretrain_tiny_check(dev, smi):
    """Phase 14(c): the depth pretrainer's walks and 3 steps at 64x114, and
    a sample of each kind with 3 occupancy and visibility steps, on the
    card and on the CPU with the same weights and one CPU generator's
    draws."""
    import tempfile

    import numpy as np
    import torch
    from nextbestpath_tpu_torch.assets import generate_scene, pack_generated_scene
    from nextbestpath_tpu_torch.config import default_params
    from nextbestpath_tpu_torch.draws import TorchDraws
    from nextbestpath_tpu_torch.geometry.cameras import CameraIntrinsics
    from nextbestpath_tpu_torch.models.manydepth import ManyDepth, flax_init_
    from nextbestpath_tpu_torch.models.scone import SconeOcc, SconeVis
    from nextbestpath_tpu_torch.train import pretrain_scone as PS
    from nextbestpath_tpu_torch.train.pretrain_depth import (_sample_walk,
                                                             depth_scene_from_assets,
                                                             pretrain_depth)

    tiny = default_params(image_height=64, image_width=114, points_per_frame=256,
                          full_pc_capacity=16384, n_gt_surface_points=1024)
    sc = [pack_generated_scene(generate_scene("simple", seed=8), params=tiny)]
    ev = pack_generated_scene(generate_scene("simple", seed=708), params=tiny)
    walks, runs, samples, losses = {}, {}, {}, {}
    for d in ("cuda", "cpu"):
        dd = torch.device(d)
        draws = TorchDraws(8, dd, "cpu")
        scene = depth_scene_from_assets(sc[0], dd)
        walks[d] = torch.stack([torch.stack(_sample_walk(scene, draws, sc[0].n_azim, 3,
                                                         step=b)).cpu() for b in range(8)])
        with tempfile.TemporaryDirectory() as tmp:
            model = flax_init_(ManyDepth(CameraIntrinsics(64, 114)), 0)
            pretrain_depth(sc, ev, steps=3, batch=1, seed=8, out_dir=tmp, log_dir=tmp,
                           eval_every=3, image_height=64, image_width=114, params=tiny,
                           model=model, draws=TorchDraws(8, dd, "cpu"), verbose=False,
                           device=dd)
            with open(os.path.join(tmp, "depth_pre_loss.json")) as f:
                runs[d] = json.load(f)
        small = dict(n_partial=256, n_query=128, n_candidates=4, n_views=2)
        samples[d] = [PS.make_pretrain_sample(0, **small, device=dd,
                                              draws=TorchDraws(0, dd, "cpu")),
                      PS.make_interior_sample(1, **small, scenes=2, device=dd,
                                              draws=TorchDraws(1, dd, "cpu"))]
        torch.manual_seed(0)
        occ, vis = SconeOcc(seq_len=256), SconeVis()
        kw = dict(n_steps=3, seed=0, samples=samples["cuda"], batch=2, verbose=False,
                  device=dd)
        losses[d] = (PS.pretrain_scone_occ(model=occ, draws=TorchDraws(0, dd, "cpu"), **kw)[1]
                     + PS.pretrain_scone_vis(model=vis, draws=TorchDraws(0, dd, "cpu"), **kw)[1])
    same_walks = torch.equal(walks["cuda"], walks["cpu"])
    g, c = runs["cuda"], runs["cpu"]
    vals_g = g["loss"] + [e["err"] for e in g["eval_err"]]
    vals_c = c["loss"] + [e["err"] for e in c["eval_err"]]
    depth_err = max(abs(a - b) / max(abs(b), 1e-6) for a, b in zip(vals_g, vals_c))
    same_samples, pts_err = True, 0.0
    for a, b in zip(samples["cuda"], samples["cpu"]):
        for f in ("query_x", "query_occ", "candidate_cams", "gt_coverage"):
            same_samples = same_samples and np.array_equal(getattr(a, f), getattr(b, f))
        for f in ("partial_pc", "view_harmonics"):
            x, y = getattr(a, f), getattr(b, f)
            pts_err = max(pts_err, float(np.abs(x - y).max() / np.abs(y).max()))
    scone_err = max(abs(a - b) / max(abs(b), 1e-6)
                    for a, b in zip(losses["cuda"], losses["cpu"]))
    log(f"phase 14(c) 64x114 card vs CPU [{smi}]: 8 walks equal {same_walks}; depth losses "
        f"{[round(v, 6) for v in g['loss']]} vs {[round(v, 6) for v in c['loss']]}, held-out "
        f"error {vals_g[-1]:.6f} vs {vals_c[-1]:.6f} (largest relative difference "
        f"{depth_err:.2e}); samples' decisions equal {same_samples}, points and harmonics "
        f"within {pts_err:.2e} of their scale; SCONE losses largest relative difference "
        f"{scone_err:.2e}")
    if (not same_walks or depth_err > TOL_MACARONS_LOSS or not same_samples
            or pts_err > 1e-5 or scone_err > TOL_MACARONS_LOSS):
        raise AssertionError("phase 14(c): the card's pretrainers disagree with the CPU's")


def pretrain_kernel_checks(params, assets, interior, dev, smi):
    """Phase 14(d): K1 and K2 at the pretrainers' shapes against their
    plain versions bit for bit: one 256x456 RGB-D frame of the depth
    pretrainer with its index, and an interior sample's sight rays (4
    cameras x 512 queries), candidate rays (16 x 512) and lattice inside
    test."""
    import numpy as np
    import torch
    from nextbestpath_tpu_torch import kernels
    from nextbestpath_tpu_torch.geometry.cameras import CameraIntrinsics, get_camera_RT
    from nextbestpath_tpu_torch.ops.raytrace import (frame_rays, inside_test_rays,
                                                     pinhole_tri_soa,
                                                     ray_hits_pinhole_plain, ray_hits_plain)
    from nextbestpath_tpu_torch.planning.grid_paths import lattice_positions
    from nextbestpath_tpu_torch.train import pretrain_scone as PS

    intr = CameraIntrinsics(int(params.image_height), int(params.image_width),
                            float(params.fov_degrees), float(params.camera_znear),
                            float(params.zfar))
    soa = tris_to_soa_on(assets, dev)
    n_tris = torch.tensor([assets.n_tris], dtype=torch.int32, device=dev)
    pose = start_neighbour_poses(assets, dev)[0]
    R, T = get_camera_RT(pose[None, :3], pose[None, 3:])
    eye, dirs = frame_rays(R, T, intr)
    ph = pinhole_tri_soa(soa, eye)
    dirs = dirs.contiguous()
    compare_hits(f"phase 14(d) K1 ray_hits_pinhole (one {intr.image_height}x"
                 f"{intr.image_width} RGB-D frame, with its index)",
                 kernels.ray_hits_pinhole(dirs, ph, n_tris, intr.znear, intr.zfar,
                                          intr.image_width),
                 ray_hits_pinhole_plain(dirs, ph, n_tris, intr.znear, intr.zfar),
                 dirs.shape[1])
    i_assets, i_soa = PS._interior_scene(0, dev)
    i_n = torch.tensor([i_assets.n_tris], dtype=torch.int32, device=dev)
    rng = np.random.default_rng(0)
    pos = lattice_positions(torch.from_numpy(i_assets.pose_origin).to(dev),
                            i_assets.pose_l, i_assets.pose_h).reshape(-1, 3)
    cams = pos[torch.from_numpy(rng.choice(pos.shape[0], 20, replace=False)).to(dev)]
    gt = torch.from_numpy(i_assets.gt_surface[:512]).to(dev)
    for label, c in (("sight rays, 4 cameras x 512 queries", cams[:4]),
                     ("candidate rays, 16 x 512", cams[4:])):
        o = c.repeat_interleave(gt.shape[0], dim=0).contiguous()
        d = (gt.repeat(c.shape[0], 1) - o).contiguous()
        compare_hits(f"phase 14(d) K2 ray_hits ({label})",
                     kernels.ray_hits(o, d, i_soa, i_n, 1e-4, 0.999),
                     ray_hits_plain(o, d, i_soa, i_assets.n_tris, 1e-4, 0.999), o.shape[0])
    o, d = inside_test_rays(pos)
    o, d = o.contiguous(), d.contiguous()
    compare_hits(f"phase 14(d) K2 ray_hits (the inside test of {pos.shape[0]} lattice points)",
                 kernels.ray_hits(o, d, i_soa, i_n, 1e-6, 3.4e38),
                 ray_hits_plain(o, d, i_soa, i_assets.n_tris, 1e-6, 3.4e38), o.shape[0])
    if not (np.isfinite(interior.partial_pc).all() and 0 < interior.query_occ.mean() < 1):
        raise AssertionError("phase 14(d): the interior sample is degenerate")
    edge_blocked_check(dev, smi)


def edge_blocked_check(dev, smi):
    """Phase 14(d), last: the point-cloud planner's edge test
    (``planning/bidirectional.py::pc_edge_blocked``, chunked over the
    points) on the ``insane`` lattice against a 2M-point buffer: its ms
    and peak memory, and on a 5,000-point share the same edges as the
    CPU's."""
    import numpy as np
    import torch
    from nextbestpath_tpu_torch.assets import generate_scene, pack_generated_scene
    from nextbestpath_tpu_torch.config import default_params
    from nextbestpath_tpu_torch.planning.bidirectional import pc_edge_blocked
    from nextbestpath_tpu_torch.planning.grid_paths import lattice_positions

    a = pack_generated_scene(generate_scene("insane", seed=8),
                             params=default_params(n_gt_surface_points=2048))
    pos = lattice_positions(torch.from_numpy(a.pose_origin), a.pose_l, a.pose_h)
    rng = np.random.default_rng(0)
    verts = a.tris[:a.n_tris].reshape(-1, 3)
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    n = 2 ** 21
    pts = torch.from_numpy(rng.uniform(lo, hi, (n, 3)).astype(np.float32))
    valid = torch.from_numpy(rng.random(n) < 0.9)
    pos_d, pts_d, valid_d = pos.to(dev), pts.to(dev), valid.to(dev)
    pc_edge_blocked(pos_d, pts_d[:4096], valid_d[:4096])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    full = pc_edge_blocked(pos_d, pts_d, valid_d)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = (torch.cuda.max_memory_allocated() - mem0) / 2 ** 20
    k = 5000
    got = pc_edge_blocked(pos_d, pts_d[:k], valid_d[:k]).cpu()
    want = pc_edge_blocked(pos, pts[:k], valid[:k])
    log(f"phase 14(d) pc_edge_blocked, insane/8 lattice {a.pose_l}x{a.pose_h} "
        f"({4 * a.pose_l * a.pose_h} edges) against {n:,} points [{smi}]: {ms:.1f} ms, "
        f"peak {peak:.0f} MiB over the inputs, {int(full.sum())} edges blocked; on "
        f"{k:,} points the card's edges equal the CPU's: {torch.equal(got, want)}")
    if not torch.equal(got, want):
        raise AssertionError("phase 14(d): pc_edge_blocked on the card differs from the CPU's")


def tiny_depth_step_check(tiny, t_assets, state):
    """Phase 13(d)'s depth step: one step of the seeded TINY ManyDepth on
    the card and on the CPU, on the same frames and draws, and on the CPU
    in f64. The losses within TOL_MACARONS_LOSS relative; the gradient
    (Adam's first moment after one step from zero, over 1 - b1) as close
    to the CPU's as the CPU's f32 gradient is to its f64 one (the step's
    own f32 rounding: the sampler's floors and the min over the
    supervision frames make it far from smooth)."""
    import torch
    from nextbestpath_tpu_torch.draws import TorchDraws
    from nextbestpath_tpu_torch.geometry.cameras import CameraIntrinsics
    from nextbestpath_tpu_torch.sim.sensor import capture_rgbd
    from nextbestpath_tpu_torch.train.train_macarons import AUG_SHAPES, make_depth_steps
    intr = CameraIntrinsics(32, 56, float(tiny.fov_degrees), float(tiny.camera_znear),
                            float(tiny.zfar))
    cpu = torch.device("cpu")
    soa = tris_to_soa_on(t_assets, cpu)
    n_tris = torch.tensor([t_assets.n_tris], dtype=torch.int32)
    colors = torch.from_numpy(t_assets.tri_colors)
    frames = [capture_rgbd(soa, n_tris, p5, intr, tri_colors=colors)
              for p5 in start_neighbour_poses(t_assets, cpu)]
    aug = TorchDraws(0, cpu).uniforms("depth", AUG_SHAPES)
    out = {}
    for d, dt in (("cuda", torch.float32), ("cpu", torch.float32), ("cpu", torch.float64)):
        st = state(tiny, torch.device(d))
        step, _ = make_depth_steps(st.model, st.depth_tx, intr, tiny)
        on = lambda x: x.to(d, dt)  # noqa: E731
        dvars = {k: on(v) if v.is_floating_point() else v
                 for k, v in st.model.depth_vars.items()}
        tgt, alphas = frames[1], [frames[0], frames[2], frames[3]]
        _, opt, photo, reg = step(
            dvars, st.depth_tx.init(dvars), on(tgt[0]), on(tgt[2]), on(tgt[3]),
            *(on(torch.stack([f[i] for f in alphas])) for i in (0, 2, 3)),
            [[on(u) for u in aug[0]], on(aug[1])])
        g = torch.cat([v.reshape(-1) for _, v in sorted(opt.mu.items())]).cpu().double()
        out[d, dt] = (float(photo), float(reg), g / (1 - st.depth_tx.b1))
    (pg, rg, gg), (pc, rc, gc), (_, _, g64) = out.values()
    loss_err = max(abs(pg - pc) / max(abs(pc), 1e-6), abs(rg - rc) / max(abs(rc), 1e-6))
    grad_err = float(torch.linalg.norm(gg - gc) / torch.linalg.norm(gc))
    f32_err = float(torch.linalg.norm(gc - g64) / torch.linalg.norm(g64))
    log(f"phase 13(d) TINY depth step, card vs CPU: photometric {pg:.6f} vs {pc:.6f}, "
        f"regularity {rg:.6f} vs {rc:.6f} (largest relative difference {loss_err:.2e}), "
        f"the gradient's relative difference {grad_err:.2e} (the CPU's f32 against its "
        f"f64: {f32_err:.2e}; norm {float(torch.linalg.norm(gc)):.4e})")
    if loss_err > TOL_MACARONS_LOSS or not grad_err <= f32_err:
        raise AssertionError("phase 13(d): the card's depth step disagrees with the CPU's")


def tris_to_soa_on(assets, dev):
    import torch
    from nextbestpath_tpu_torch.ops.raytrace import tris_to_soa
    return tris_to_soa(torch.from_numpy(assets.tris).to(dev))


def start_neighbour_poses(assets, dev):
    """Four poses at the start position and its lattice neighbours, the
    azimuth stepping round: (4,) of (5,) tensors, frames that overlap."""
    import numpy as np
    import torch
    start = np.asarray(assets.start_cam_idx)
    out = []
    for k in range(4):
        i = start.copy()
        i[0] = min(max(i[0] + (k % 2), 0), assets.pose_l - 1)
        i[4] = (i[4] + k // 2) % assets.n_azim
        out.append(torch.tensor(assets.pose_from_idx(i), dtype=torch.float32, device=dev))
    return out


def macarons_kernel_checks(params, assets, dev, smi):
    """Phase 13(e): K1, K2 and K3 at the trainer's shapes against their
    plain versions bit for bit: one RGB-D frame (the index the shader reads
    included), a move's four frames in one launch, the scene tables, and
    the coverage metric's call on a buffer the trainer's first move fills."""
    import torch
    from nextbestpath_tpu_torch import kernels
    from nextbestpath_tpu_torch.draws import TorchDraws
    from nextbestpath_tpu_torch.geometry.cameras import CameraIntrinsics, get_camera_RT
    from nextbestpath_tpu_torch.ops.coverage import (_S_SENTINEL, min_sq_dists_plain,
                                                     n_sample_for, subsample_buffer)
    from nextbestpath_tpu_torch.ops.raytrace import (frame_rays, pinhole_tri_soa,
                                                     ray_hits_pinhole_plain, ray_hits_plain)
    from nextbestpath_tpu_torch.sim.rollout import (TrajectoryBuffer, interpolate_move,
                                                    move_and_capture)
    from nextbestpath_tpu_torch.sim.sensor import PointBuffer
    from nextbestpath_tpu_torch.sim.tables import table_rays
    from nextbestpath_tpu_torch.planning.grid_paths import lattice_positions

    intr = CameraIntrinsics(int(params.image_height), int(params.image_width),
                            float(params.fov_degrees), float(params.camera_znear),
                            float(params.zfar))
    zn, zf = float(intr.znear), float(intr.zfar)
    soa = tris_to_soa_on(assets, dev)
    n_tris = torch.tensor([assets.n_tris], dtype=torch.int32, device=dev)
    poses = start_neighbour_poses(assets, dev)
    # One RGB-D frame.
    R, T = get_camera_RT(poses[0][None, :3], poses[0][None, 3:])
    eye, dirs = frame_rays(R, T, intr)
    ph = pinhole_tri_soa(soa, eye)
    dirs = dirs.contiguous()
    compare_hits("phase 13(e) K1 ray_hits_pinhole (one render_rgbd frame, with its index)",
                 kernels.ray_hits_pinhole(dirs, ph, n_tris, zn, zf, intr.image_width),
                 ray_hits_pinhole_plain(dirs, ph, n_tris, zn, zf), dirs.shape[1])
    # A move's four frames in one launch, then its points in a buffer.
    n_steps = int(params.n_interpolation_steps)
    mv = interpolate_move(poses[0], poses[1], n_steps, assets.n_azim)
    R4, T4 = get_camera_RT(mv[:, :3], mv[:, 3:])
    eye4, dirs4 = frame_rays(R4, T4, intr)
    ph4 = pinhole_tri_soa(soa, eye4)
    dirs4 = dirs4.contiguous()
    compare_hits(f"phase 13(e) K1 ray_hits_pinhole (the move's {n_steps} frames, one launch)",
                 kernels.ray_hits_pinhole(dirs4, ph4, n_tris, zn, zf, intr.image_width),
                 ray_hits_pinhole_plain(dirs4, ph4, n_tris, zn, zf),
                 dirs4.shape[0] * dirs4.shape[1])
    # The scene tables.
    pos = lattice_positions(torch.from_numpy(assets.pose_origin).to(dev), assets.pose_l,
                            assets.pose_h)
    o, d = table_rays(pos)
    o, d = o.contiguous(), d.contiguous()
    compare_hits("phase 13(e) K2 ray_hits (the scene tables)",
                 kernels.ray_hits(o, d, soa, n_tris, 1e-6, 3.4e38),
                 ray_hits_plain(o, d, soa, assets.n_tris, 1e-6, 3.4e38), o.shape[0])
    # The coverage metric's K3 call on the buffer of a first move.
    draws = TorchDraws(0, dev)
    pc = PointBuffer.create(int(params.full_pc_capacity), dev)
    traj = TrajectoryBuffer.create(8, dev)
    n_px = intr.image_height * intr.image_width
    move_and_capture(soa, n_tris, poses[0], poses[1], pc, traj,
                     [draws.uniform("move", (n_px,)) for _ in range(n_steps)], intr,
                     n_steps=n_steps, n_azim=assets.n_azim,
                     n_slots=int(params.points_per_frame),
                     gathering_factor=float(params.gathering_factor),
                     sensor_range=float(params.sensor_range))
    gt = torch.from_numpy(assets.gt_surface).to(dev).contiguous()
    n_sample = n_sample_for(gt.shape[0], pc.capacity)
    idx, valid = subsample_buffer(draws.uniform("cov", (pc.capacity,)), pc.count, n_sample)
    samp = torch.where(valid[:, None], pc.points[idx],
                       torch.full_like(pc.points[idx], _S_SENTINEL)).contiguous()
    got = kernels.min_sq_dists(gt, samp, pc.count)
    want = min_sq_dists_plain(gt, samp, pc.count)
    log(f"phase 13(e) K3 min_sq_dists (the coverage call: {gt.shape[0]} GT x {n_sample} "
        f"samples, {int(pc.count)} valid) [{smi}]: bit for bit {torch.equal(got, want)}")
    if not torch.equal(got, want):
        raise AssertionError("phase 13(e): K3 differs from its plain version at the "
                             "trainer's coverage call")



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

    def timed(m, d, idx, sw):
        # The micro step's loss and gradients (from its second call on a
        # graph replay, which runs no hook), between two events.
        mark("fwd")
        flags_seen.append(torch.backends.cudnn.allow_tf32)
        same.append(torch.equal(model.final1.weight, w0))
        out = TT._loss_and_grads(m, d, idx, sw)
        mark("fwd_end")
        return out

    def on_forward(*_):
        flags_seen.append(torch.backends.cudnn.allow_tf32)
        saved.append(-torch.cuda.memory_allocated())

    def on_forward_end(*_):
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
            _, loss = TT.train_epoch_ds(state, ds, list(range(56)), random.Random(epoch),
                                        loss_and_grads=timed)
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
        f"{sum(micro_ms) / len(micro_ms):.2f} ms a micro step (loss, gradients and "
        f"accumulation; {[round(m, 2) for m in micro_ms]}; the graph of the loss and "
        f"gradients {sum(fwd_ms) / len(fwd_ms):.2f}), optimizer step {opt_ms:.2f} ms, peak memory "
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
    ``n`` staged entries (``train_epoch_ds``), from CUDA events around
    each micro step's loss and gradients (a graph replay) and at the
    optimizer step: (micro step ms, loss and gradients ms, peak GiB)."""
    import random

    import torch
    from nextbestpath_tpu_torch.train import train_nbp as TT

    marks = []

    def mark(tag):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((tag, ev))

    def timed(*args):
        mark("fwd")
        out = TT._loss_and_grads(*args)
        mark("fwd_end")
        return out

    hooks = [state.optimizer.register_step_pre_hook(lambda *_: mark("opt"))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        for epoch in range(epochs):
            marks.clear()
            TT.train_epoch_ds(state, ds, list(range(n)), random.Random(epoch),
                              loss_and_grads=timed)
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
                min_sq_dists=n_poses, bfs_field=plans, extract_path=plans,
                gumbel_noise=n_poses)
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
    from nextbestpath_tpu_torch.device import cudnn_f32
    from nextbestpath_tpu_torch.eval.nbp_planning import seeded_nbp
    from nextbestpath_tpu_torch.train import train_nbp as TT

    data = (db.entries * (56 // len(db.entries) + 1))[:56]
    tm = seeded_nbp(dtype=torch.bfloat16).to(dev).train()
    state = TT.init_train_state(tm)
    ds, _ = TT.build_device_dataset(data, dev)
    micro, fwd, peak = micro_step_times(state, ds, 56)
    steps = int(state.optimizer.state[state.params[0]]["step"])
    # The captured micro step against the same step dispatched eagerly,
    # from the same state: loss, gradients and running statistics.
    snap = {k: v.clone() for k, v in tm.state_dict().items()}
    idx, sw = next(TT._micro_chunks(list(range(8)), 8, device=dev))
    outs = []
    for fn in (TT._loss_and_grads, TT._eager_loss_and_grads):
        tm.load_state_dict(snap)
        with cudnn_f32():
            loss, grads = fn(tm, ds, idx, sw)
        outs.append([loss.clone()] + [g.clone() for g in grads]
                    + [b.clone() for b in tm.buffers()])
    same = all(torch.equal(a, b) for a, b in zip(*outs))
    log(f"phase 9 bf16 micro step replayed as a graph against eager, full width: "
        f"bit for bit {same} (loss {float(outs[0][0])!r} / {float(outs[1][0])!r})")
    if not same:
        raise AssertionError("the graphed micro step differs from the eager one")
    log(f"phase 9 bf16 training step, full-width NBP, 256x256x5, micro batch 8 [{smi}]: "
        f"{micro:.2f} ms a micro step, loss and gradients {fwd:.2f} ms, peak {peak:.2f} GiB; "
        f"phase 8's f32 step {f32['micro_ms']:.2f} ms, loss and gradients "
        f"{f32['fwd_ms']:.2f} ms, "
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
    scenes' GT edge tables) and B = 4 58x58 mazes, also with mixed skip
    flags. The JSON rows take B = 4, the batch of phase 10; B = 8 is logged
    beside."""
    import torch
    from nextbestpath_tpu_torch import kernels
    from nextbestpath_tpu_torch.eval.nbp_planning import main_path_move
    from nextbestpath_tpu_torch.geometry.cameras import get_camera_RT
    from nextbestpath_tpu_torch.ops.coverage import min_sq_dists_scenes_plain
    from nextbestpath_tpu_torch.ops.raytrace import (frame_rays, pinhole_tested_share,
                                                     pinhole_tri_soa,
                                                     ray_hits_pinhole_scenes_plain,
                                                     tris_to_soa)
    from nextbestpath_tpu_torch.planning.grid_paths import (
        INF, bfs_distance_field_scenes_plain, extract_path_scenes_plain)
    from nextbestpath_tpu_torch.sim.tables import build_scene_tables

    zn, zf = float(intr.znear), float(intr.zfar)
    n_steps = int(params.n_interpolation_steps)
    scenes = padded_scenes(params, 8)
    out, against = {}, []
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
        W = intr.image_width
        got = kernels.ray_hits_pinhole_scenes(dirs, ph, nt, zn, zf, W)
        want = ray_hits_pinhole_scenes_plain(dirs, ph, nt, zn, zf)
        single = [kernels.ray_hits_pinhole(dirs[k:k + n_steps], ph[k:k + n_steps],
                                           nt[k], zn, zf, W)
                  for k in range(0, len(counts), n_steps)]
        single = tuple(torch.cat([x[i] for x in single]) for i in range(3))
        compare_hits(f"K1 ray_hits_pinhole_scenes ({B} scenes x {n_steps} frames, one "
                     f"launch)", got, want, dirs.shape[0] * dirs.shape[1])
        if not all(torch.equal(g, w) for g, w in zip(got, single)):
            raise AssertionError(f"K1's scene axis differs from single launches (B={B})")
        share = pinhole_tested_share(dirs, ph, nt, W)
        bound, all_pairs = k1_bound(dirs.shape[1], counts, share)
        ops = share * dirs.shape[1] * sum(counts) * OPS_K1
        out[("k1", B)] = dict(
            ms=kernels.device_ms(
                lambda: kernels.ray_hits_pinhole_scenes(dirs, ph, nt, zn, zf, W), 30),
            plain_ms=kernels.device_ms(
                lambda: ray_hits_pinhole_scenes_plain(dirs, ph, nt, zn, zf), 2),
            single_ms=kernels.device_ms(lambda: [
                kernels.ray_hits_pinhole(dirs[k:k + n_steps], ph[k:k + n_steps], nt[k], zn, zf,
                                         W)
                for k in range(0, len(counts), n_steps)], 20),
            bound=bound, all_pairs=all_pairs, share=share,
            library_ms=None, ceiling=ceiling_ms(ops),
            shape=f"{B} scenes x {n_steps} frames x {dirs.shape[1]} rays x "
                  f"{counts[0]} tris, a count a frame")
        if B == 4:
            against.append(("ray_hits_pinhole_scenes", out[("k1", B)]["shape"],
                            lambda kern, d=dirs, ph=ph, c=nt: k1_call(kern, d, ph, c, zn, zf, W,
                                                                      scenes=True), want))

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
        plan = check_k3_plan(f"K3s (B={B})", c3, g3.shape[1], n_s)
        log(f"K3 min_sq_dists_scenes ({B} scenes x {g3.shape[1]} GT x {n_s} samples, counts "
            f"{c_list}): equal to the plain version and to single launches {ok}; plan chunk "
            f"{plan['chunk']}, items {plan['items']} on {plan['blocks']} blocks (the plan "
            f"kernel's equal)")
        if not ok:
            raise AssertionError(f"K3's scene axis disagrees (B={B})")
        against.append(("min_sq_dists_scenes", f"{B} scenes, counts {c_list}",
                         lambda kern, g3=g3, s3=s3, c3=c3: kern.min_sq_dists_scenes(g3, s3, c3),
                         want))
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
        del gs, ss
    # One scene on the scene axis (B = 1), at a count that is no multiple of
    # a tile.
    g1, s1, c1 = g3[:1].contiguous(), s3[1:2].contiguous(), c3[1:2].contiguous()
    got = kernels.min_sq_dists_scenes(g1, s1, c1)
    ok = (torch.equal(got, min_sq_dists_scenes_plain(g1, s1, c1))
          and torch.equal(got[0], kernels.min_sq_dists(g1[0], s1[0], c1)))
    check_k3_plan("K3s (B=1)", c1, g1.shape[1], s1.shape[1])
    log(f"K3 min_sq_dists_scenes (1 scene, count {int(c1[0])}): equal to the plain version and "
        f"to a single launch {ok}")
    if not ok:
        raise AssertionError("K3's scene axis disagrees (B=1)")

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
        # Mixed skip flags: the skipped scenes' defined results, the others'
        # as without flags.
        skip = torch.tensor([False, True, False, True], device=dev)
        dist_s = kernels.bfs_field_scenes(blocked, start, skip)
        path_s, meta_s = kernels.extract_path_scenes(dist_s, blocked, goal, max_len, skip)
        dist_sp = bfs_distance_field_scenes_plain(blocked, start, L, H, skip)
        path_sp, len_sp, reach_sp = extract_path_scenes_plain(dist_sp, blocked, goal, L, H,
                                                              max_len, skip)
        keep = ~skip
        ok_skip = (torch.equal(dist_s, dist_sp) and torch.equal(path_s, path_sp)
                   and torch.equal(meta_s[:, 0], len_sp)
                   and torch.equal(meta_s[:, 1] != 0, reach_sp)
                   and torch.equal(dist_s[keep], dist[keep])
                   and torch.equal(path_s[keep], path[keep])
                   and torch.equal(meta_s[keep], meta[keep]))
        log(f"planner kernels, scene axis ({B} x {name}): eccentricities {ecc}, path lengths "
            f"{len_p.tolist()} (max_len {max_len}), equal to the plain versions and to single "
            f"launches {ok}; skip flags {skip.tolist()} equal to the plain versions {ok_skip}")
        if not (ok and ok_skip):
            raise AssertionError(f"the planner kernels' scene axis disagrees ({name})")
        n = L * H
        out[("bfs", name)] = dict(
            ms=kernels.device_ms(lambda: kernels.bfs_field_scenes(blocked, start), 50),
            plain_ms=wall_ms(lambda: bfs_distance_field_scenes_plain(blocked, start, L, H), 2),
            single_ms=kernels.device_ms(lambda: [kernels.bfs_field(b, st) for b, st
                                                 in zip(blocked, start)], 50),
            mixed_skip_ms=kernels.device_ms(lambda: kernels.bfs_field_scenes(blocked, start,
                                                                             skip), 50),
            bound=bound_ms(B * (4 * n + 16 + 4 * n), B * n * OPS_BFS_NODE, PEAK_INT32_OPS),
            library_ms=None, ceiling=None, shape=f"{B} x {name} lattices")
        out[("walk", name)] = dict(
            ms=kernels.device_ms(lambda: kernels.extract_path_scenes(dist, blocked, goal,
                                                                     max_len), 50),
            plain_ms=wall_ms(lambda: extract_path_scenes_plain(dist_p, blocked, goal, L, H,
                                                               max_len), 2),
            single_ms=kernels.device_ms(lambda: [kernels.extract_path(d, b, g, max_len) for d, b, g
                                                 in zip(dist, blocked, goal)], 50),
            mixed_skip_ms=kernels.device_ms(lambda: kernels.extract_path_scenes(
                dist, blocked, goal, max_len, skip), 50),
            bound=bound_ms(sum(16 + 4 + e * BYTES_WALK_STEP + 8 * max_len + 8 for e in ecc),
                           sum(e * OPS_WALK_STEP for e in ecc), PEAK_INT32_OPS),
            library_ms=None, ceiling=None, shape=f"{B} x {name} lattices")
    for key, r in out.items():
        mixed = (f", flags {[False, True, False, True]} {r['mixed_skip_ms']:.4f} ms"
                 if "mixed_skip_ms" in r else "")
        culled = (f", all pairs' operations {r['all_pairs']:.4f} ms, pairs tested "
                  f"{r['share']:.4f}" if "share" in r else "")
        log(f"  {key[0]} scene axis {key[1]}: {r['ms']:.4f} ms (single launches "
            f"{r['single_ms']:.4f} ms{mixed}, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound'][0]:.4g} ms by {r['bound'][1]}{culled}, library {r['library_ms']}) at "
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
                         ceiling_ms=r["ceiling"], library_ms=r["library_ms"], shape=r["shape"],
                         tested_share=r.get("share"), all_pairs_ops_ms=r.get("all_pairs")))
    return rows, against


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
                             min_sq_dists_scenes=n_poses, gumbel_noise=B * n_poses)):
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


def nbv_stage_ms(run, n_poses, stage_names=None):
    """Device ms a pose of each stage range of the rollout ``run()``
    (``torch.profiler``; ``profile_rollout.py``'s split: the activities
    that start inside a range's device extent), and the profiled wall.
    ``stage_names``: the ranges to report (default the NBV's)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from nextbestpath_tpu_torch.eval.macarons_nbv import NBV_STAGES
    from nextbestpath_tpu_torch.profile_rollout import (_device_spans,
                                                        _stage_device_us)
    stage_names = stage_names or NBV_STAGES
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernel_spans, stages = _device_spans(prof)
    out = {name: _stage_device_us(kernel_spans, stages[name]) / 1e3 / n_poses
           for name in stage_names if name in stages}
    return out, wall / n_poses * 1e3


def nbv_phase(params, assets, dev, smi, against=None):
    """Phase 12 (module docstring). Returns the launches by kernel of its
    three counted paths: {"nbv": ..., "nbv_oracle": ..., "object_nbv": ...}."""
    import torch
    from nextbestpath_tpu_torch import kernels
    from nextbestpath_tpu_torch.assets import generate_scene, pack_generated_scene
    from nextbestpath_tpu_torch.assets.objects import generate_object
    from nextbestpath_tpu_torch.config import default_params
    from nextbestpath_tpu_torch.draws import TorchDraws
    from nextbestpath_tpu_torch.eval.macarons_nbv import (
        C_MAX, NBV_SMALL, NBV_SMALL_TOKENS, macarons_nbv_rollout, seeded_scone)
    from nextbestpath_tpu_torch.eval.nbp_planning import MAIN_PATH_SEED
    from nextbestpath_tpu_torch.eval.object_nbv import object_nbv_rollout

    t_phase = time.perf_counter()
    zero = dict.fromkeys(kernels.LAUNCHES, 0)
    occ, vis = seeded_scone()
    n_occ = sum(p.numel() for p in occ.parameters())
    n_vis = sum(p.numel() for p in vis.parameters())

    def nbv(n_poses, oracle=False):
        return macarons_nbv_rollout(assets, None if oracle else occ,
                                    None if oracle else vis, params=params,
                                    n_poses=n_poses, seed=MAIN_PATH_SEED,
                                    oracle=oracle, device=dev)

    def counted(run):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        res = run()
        return res, dict(kernels.LAUNCHES), torch.cuda.max_memory_allocated() / 2 ** 20

    # (a) The learned NBV at full width after a 1-pose warm-up.
    nbv(1)
    n_poses = 10
    res, nbv_l, peak = counted(lambda: nbv(n_poses))
    cov = res.coverage_evolution
    ms = res.wall_time_s / n_poses * 1e3
    log(f"phase 12(a) learned NBV simple/{MAIN_PATH_SEED}, SconeOcc ({n_occ:,} parameters) and "
        f"SconeVis ({n_vis:,}) seeded, f32, {int(params.n_proxy_points)} proxy points, 1024 "
        f"tokens, {C_MAX} candidates, {n_poses} poses [{smi}]: {ms:.2f} ms a pose "
        f"({res.steps_per_sec:.2f} poses/s), peak memory {peak:.0f} MiB, coverage "
        f"{[round(c, 4) for c in cov]}, points {res.n_points}, launches {nbv_l}")
    rises("phase 12(a) learned NBV", cov)
    expect_launches("phase 12(a)", nbv_l, dict(zero, ray_hits=1, ray_hits_pinhole=1 + n_poses,
                                               min_sq_dists=n_poses, gumbel_noise=n_poses,
                                               gumbel_argmax=n_poses))
    stage, prof_ms = nbv_stage_ms(lambda: nbv(3), 3)
    log(f"phase 12(a) learned NBV device ms a pose by stage (3 poses profiled, {prof_ms:.2f} "
        f"ms a pose under the profiler, scene tables included) [{smi}]: "
        + ", ".join(f"{k} {v:.3f}" for k, v in stage.items()))

    # The Gumbel noise alone: C_MAX x (1024 tokens x P proxies) f32.
    n_proxy = int(params.n_proxy_points)
    shapes = [(1024, n_proxy)] * C_MAX
    draws = TorchDraws(1, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    noise = draws.gumbels("gain", shapes)
    g_peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    del noise
    g_ms = kernels.device_ms(lambda: draws.gumbels("gain", shapes), reps=5)
    g_bytes = C_MAX * 1024 * n_proxy * 4
    log(f"phase 12(a) Gumbel draw of {C_MAX} x (1024 x {n_proxy}) f32 ({g_bytes / 2 ** 30:.2f} GiB) "
        f"[{smi}]: {g_ms:.3f} device ms, peak {g_peak:.0f} MiB over the live tensors, "
        f"its write alone at the memory rate {g_bytes / PEAK_BYTES * 1e3:.3f} ms")

    # (b) The oracle mode: 20 candidate frames in one K1 launch a pose.
    n_or = 3
    nbv(1, oracle=True)
    res, or_l, peak = counted(lambda: nbv(n_or, oracle=True))
    cov = res.coverage_evolution
    ms = res.wall_time_s / n_or * 1e3
    log(f"phase 12(b) oracle NBV simple/{MAIN_PATH_SEED}, {n_or} poses [{smi}]: {ms:.2f} ms a "
        f"pose, peak memory {peak:.0f} MiB, coverage {[round(c, 4) for c in cov]}, launches {or_l}")
    rises("phase 12(b) oracle NBV", cov)
    expect_launches("phase 12(b)", or_l, dict(zero, ray_hits=1, ray_hits_pinhole=1 + 2 * n_or,
                                              min_sq_dists=2 * n_or, min_sq_dists_scenes=n_or))
    stage, prof_ms = nbv_stage_ms(lambda: nbv(n_or, oracle=True), n_or)
    log(f"phase 12(b) oracle NBV device ms a pose by stage ({n_or} poses profiled, "
        f"{prof_ms:.2f} ms a pose under the profiler) [{smi}]: "
        + ", ".join(f"{k} {v:.3f}" for k, v in stage.items()))

    # (c) The object NBV: K2 once a view.
    obj = generate_object(seed=6)
    n_views = 4
    object_nbv_rollout(obj, vis, n_views=2, seed=0, device=dev)
    t0 = time.perf_counter()
    (curve, chosen), obj_l, peak = counted(
        lambda: object_nbv_rollout(obj, vis, n_views=n_views, seed=0, device=dev,
                                   return_views=True))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n_views * 1e3
    log(f"phase 12(c) object NBV procobj_6 ({obj.n_tris} triangles, 2048 surface points, 32 "
        f"candidates, 512 tokens), {n_views} views [{smi}]: {ms:.2f} ms a view, peak memory "
        f"{peak:.0f} MiB, curve {[round(c, 4) for c in curve]}, views {chosen}, launches {obj_l}")
    if not (curve[-1] > curve[0] > 0.0 and len(set(chosen)) == n_views):
        raise AssertionError(f"phase 12(c): the object NBV does not progress: {curve} {chosen}")
    expect_launches("phase 12(c)", obj_l, dict(zero, ray_hits=n_views))

    # (d) Small runs on the card against the CPU, one CPU generator's draws.
    small = default_params(**NBV_SMALL)
    s_assets = pack_generated_scene(generate_scene("simple", seed=6), params=small)
    runs = {}
    for d in ("cuda", "cpu"):
        s_occ, s_vis = seeded_scone(small=True)
        for oracle in (False, True):
            runs[d, oracle] = macarons_nbv_rollout(
                s_assets, s_occ, s_vis, params=small, n_poses=2, seed=1, oracle=oracle,
                draws=TorchDraws(1, torch.device(d), "cpu"), device=d, **NBV_SMALL_TOKENS)
        runs[d, "object"] = object_nbv_rollout(generate_object(seed=6, n_gt_surface_points=512),
                                               s_vis, n_views=4, n_candidates=8, n_tokens=64,
                                               seed=0, device=d, return_views=True)
    for mode in (False, True):
        g, c = runs["cuda", mode], runs["cpu", mode]
        diff = max(abs(a - b) for a, b in zip(g.coverage_evolution, c.coverage_evolution))
        same = (g.cam_positions.shape == c.cam_positions.shape and g.n_points == c.n_points
                and float(abs(g.cam_positions - c.cam_positions).max()) < 1e-4)
        log(f"phase 12(d) small {'oracle' if mode else 'learned'} NBV (32x56, 2 poses) card vs CPU: "
            f"card {g.coverage_evolution} vs cpu {c.coverage_evolution}, max diff {diff:.2e}, "
            f"same picks {same}")
        if diff > TOL_COVERAGE or not same:
            raise AssertionError("phase 12(d): the card's small NBV rollout disagrees with the CPU's")
    (gc, gv), (cc, cv) = runs["cuda", "object"], runs["cpu", "object"]
    log(f"phase 12(d) small object NBV card vs CPU: curves {gc} / {cc}, views {gv} / {cv}")
    if gv != cv or max(abs(a - b) for a, b in zip(gc, cc)) > 0:
        raise AssertionError("phase 12(d): the card's object NBV disagrees with the CPU's")
    nbv_kernel_checks(params, assets, obj, res.n_points, dev, smi, against)
    log(f"phase 12 wall time {time.perf_counter() - t_phase:.1f} s [{smi}]")
    return {"nbv": nbv_l, "nbv_oracle": or_l, "object_nbv": obj_l}


def gumbel_phase(params, assets, dev, smi):
    """Phase 17 (module docstring). Returns the kernels' rows G1 and G2."""
    import torch
    from nextbestpath_tpu_torch import kernels
    from nextbestpath_tpu_torch.draws import TorchDraws
    from nextbestpath_tpu_torch.eval.macarons_nbv import C_MAX
    from nextbestpath_tpu_torch.geometry.cameras import (CameraIntrinsics, get_camera_RT,
                                                         points_in_fov_mask)
    from nextbestpath_tpu_torch.sim.coverage_gain import (candidate_logits,
                                                          sample_proxy_points)

    t_phase = time.perf_counter()
    tiny = torch.finfo(torch.float32).tiny
    n_proxy, n_tok = int(params.n_proxy_points), 2048

    def eager(gen, shape):
        u = torch.rand(shape, generator=gen, device=dev).clamp(min=tiny)
        return -torch.log(-torch.log(u))

    # (a) G1 against the eager chain, on two generators of one state.
    for label, shapes in (("(4,)", [(4,)]), (f"{C_MAX} x (2048, {n_proxy})",
                                            [(n_tok, n_proxy)] * C_MAX),
                          (f"(1024, {n_proxy})", [(1024, n_proxy)]),
                          ("(3, 12345) and (1, 7)", [(3, 12345), (1, 7)])):
        gen = torch.Generator(device=dev).manual_seed(2 ** 40 + 25)
        ref = torch.Generator(device=dev)
        ref.set_state(gen.get_state())
        got = kernels.gumbel_noise(gen, shapes)
        bad = 0
        for g in got:
            bad += int((g != eager(ref, g.shape)).sum())
        after = torch.equal(torch.rand(4096, generator=gen, device=dev),
                            torch.rand(4096, generator=ref, device=dev))
        log(f"phase 17(a) G1 gumbel_noise {label}, one launch: elements unequal to the eager "
            f"chain {bad}, the stream after it equal {after}")
        if bad or not after:
            raise AssertionError(f"phase 17(a): G1 differs from the eager chain at {label}")
        del got

    # (b) G2 against the plain draw on seeded fields: proxy points in the
    # scene's box, candidates inside it, the last four far outside (no
    # point in view); then every candidate masked out (uniform draws).
    intr = CameraIntrinsics(int(params.image_height), int(params.image_width),
                            float(params.fov_degrees), float(params.camera_znear),
                            float(params.zfar))
    g = torch.Generator(device=dev).manual_seed(17)
    lo = torch.tensor(assets.settings.scene.x_min, dtype=torch.float32, device=dev)
    hi = torch.tensor(assets.settings.scene.x_max, dtype=torch.float32, device=dev)
    pts = lo + (hi - lo) * torch.rand((n_proxy, 3), generator=g, device=dev)
    occ = torch.rand((n_proxy, 1), generator=g, device=dev)
    pose5 = torch.cat([lo + (hi - lo) * torch.rand((C_MAX, 3), generator=g, device=dev),
                       torch.zeros((C_MAX, 1), device=dev),
                       360.0 * torch.rand((C_MAX, 1), generator=g, device=dev)], dim=1)
    pose5[-4:, 0] += 1000.0
    R, T = get_camera_RT(pose5[:, :3], pose5[:, 3:])
    in_fov = points_in_fov_mask(pts[None], R[:, None], T[:, None], intr,
                                fov_range=float(params.sensor_range))
    noise = TorchDraws(5, dev).gumbels("gain", [(n_tok, n_proxy)] * C_MAX)
    for label, masks in (("seeded field", in_fov),
                         ("all masked", torch.zeros_like(in_fov))):
        logits = candidate_logits(occ, masks, 0.1)
        got = kernels.gumbel_argmax(noise, logits)
        off_argmax = off_plain = ties = 0
        gap = 0.0
        for c in range(C_MAX):
            off_argmax += int((got[c] != torch.argmax(noise[c] + logits[c], dim=-1)).sum())
            plain = sample_proxy_points(noise[c], occ, masks[c], 0.1)
            diff = torch.nonzero(got[c] != plain).flatten()
            off_plain += int(diff.numel())
            if diff.numel():
                # The plain draw's own scores of both tokens (f64 sums of
                # its f32 log-probabilities).
                w = torch.where((occ[:, 0] > 0.1) & masks[c], occ[:, 0], 0.0)
                lp = torch.log(torch.clamp(w / torch.clamp(w.sum(), min=1e-12), min=1e-12))
                rows = noise[c][diff].double() + lp.double()[None]
                d = (rows.gather(1, plain[diff, None]) - rows.gather(1, got[c][diff, None]))
                gap = max(gap, float(d.abs().max()))
                ties += int(diff.numel())
        seen = int(masks.any(dim=1).sum())
        log(f"phase 17(b) G2 gumbel_argmax, {label} ({seen} of {C_MAX} candidates see a "
            f"point), {C_MAX} x {n_tok} tokens over {n_proxy} points: tokens unequal to "
            f"torch.argmax(noise + logits) {off_argmax}, to sample_proxy_points {off_plain} "
            f"(their scores {gap:.3g} apart)")
        if off_argmax or (off_plain and gap > 1e-5):
            raise AssertionError(f"phase 17(b): G2's tokens differ on the {label}")
    if not 0 < int(in_fov.any(dim=1).sum()) < C_MAX:
        raise AssertionError("phase 17(b): the seeded field should leave some candidates blind")

    # (c) Times at the NBV cell's shapes, against the bound (the noise's
    # bytes written once, read once) and the eager chain they replace.
    shapes = [(n_tok, n_proxy)] * C_MAX
    n_el = C_MAX * n_tok * n_proxy
    draws = TorchDraws(9, dev)
    g1_ms = kernels.device_ms(lambda: draws.gumbels("gain", shapes), reps=5)
    gen = torch.Generator(device=dev).manual_seed(9)
    g1_plain = kernels.device_ms(lambda: [eager(gen, s) for s in shapes], reps=3)
    logits = candidate_logits(occ, in_fov, 0.1)
    g2_ms = kernels.device_ms(lambda: kernels.gumbel_argmax(noise, logits), reps=10)
    g2_plain = kernels.device_ms(lambda: torch.stack([
        sample_proxy_points(noise[c], occ, in_fov[c], 0.1) for c in range(C_MAX)]), reps=3)
    # G1 also takes two logarithms an element at the SFU rate (16 a clock
    # an SM, 132 SMs at 1.98 GHz); below its bytes at these shapes.
    sfu_ms = 2 * n_el / (16 * 132 * 1.98e9) * 1e3
    g1_bound = bound_ms(4 * n_el, 0)
    g2_bound = bound_ms(4 * n_el + 4 * C_MAX * n_proxy + 8 * C_MAX * n_tok, 0)
    log(f"phase 17(c) G1 {C_MAX} x (2048 x {n_proxy}) [{smi}]: {g1_ms:.4f} ms (eager chain "
        f"{g1_plain:.3f} ms), bound {g1_bound[0]:.4f} ms by bytes (logarithms at the SFU "
        f"rate {sfu_ms:.4f} ms); G2: {g2_ms:.4f} ms (plain, a candidate at a time "
        f"{g2_plain:.3f} ms), bound {g2_bound[0]:.4f} ms by bytes")
    log(f"phase 17 wall time {time.perf_counter() - t_phase:.1f} s [{smi}]")
    row = dict(route="cuda", source="nextbestpath_tpu_torch/csrc/gumbel.cu",
               replaces="none (jax.random.categorical in nextbestpath_tpu/sim/"
                        "coverage_gain.py sample_proxy_points, fused by XLA)",
               launches=0, max_abs_err=0.0)
    return [dict(row, name="gumbel_noise", launches_by_path={}, ms=g1_ms,
                 plain_ms=g1_plain, bound_ms=g1_bound[0], bound_by=g1_bound[1]),
            dict(row, name="gumbel_argmax", launches_by_path={}, ms=g2_ms,
                 plain_ms=g2_plain, bound_ms=g2_bound[0], bound_by=g2_bound[1])]


def nbv_kernel_checks(params, assets, obj, n_points, dev, smi, against=None):
    """Phase 12(e): the kernels at the shapes only the NBV paths give them,
    against their plain versions bit for bit, with their times and
    bounds: K1 on the oracle's 20 candidate frames in one launch, K3 on
    the 2M-slot buffer up to the oracle run's last count (its covered
    points' shape), the scene-axis K3 on the 20 candidates' frames
    against one GT, and K2 on the object NBV's visibility rays. With
    ``against`` (another checkout), the first three are also timed there
    and here (``time_against``)."""
    import numpy as np
    import torch
    from nextbestpath_tpu_torch import kernels
    from nextbestpath_tpu_torch.eval.macarons_nbv import C_MAX, ROT_SHIFTS
    from nextbestpath_tpu_torch.geometry.cameras import CameraIntrinsics, get_camera_RT
    from nextbestpath_tpu_torch.ops.coverage import (min_sq_dists_plain,
                                                     min_sq_dists_scenes_plain)
    from nextbestpath_tpu_torch.ops.raytrace import (frame_rays, pinhole_tested_share,
                                                     pinhole_tri_soa,
                                                     ray_hits_pinhole_plain,
                                                     ray_hits_plain, tris_to_soa)
    from nextbestpath_tpu_torch.planning.grid_paths import DIRS

    intr = CameraIntrinsics(int(params.image_height), int(params.image_width),
                            float(params.fov_degrees), float(params.camera_znear),
                            float(params.zfar))
    zn, zf = float(intr.znear), float(intr.zfar)
    soa = tris_to_soa(torch.from_numpy(assets.tris).to(dev))
    n_tris = torch.tensor([assets.n_tris], dtype=torch.int32, device=dev)
    start = np.asarray(assets.start_cam_idx)
    idx = []
    for dl, dh in DIRS:
        for shift in ROT_SHIFTS:
            i = start.copy()
            i[0] = min(max(i[0] + dl, 0), assets.pose_l - 1)
            i[2] = min(max(i[2] + dh, 0), assets.pose_h - 1)
            i[4] = (i[4] + shift) % assets.n_azim
            idx.append(i)
    poses = torch.tensor(assets.pose_from_idx(np.stack(idx)), dtype=torch.float32,
                         device=dev)
    R, T = get_camera_RT(poses[:, :3], poses[:, 3:])
    eyes, dirs = frame_rays(R, T, intr)
    ph = pinhole_tri_soa(soa, eyes)
    dirs = dirs.contiguous()
    W = intr.image_width
    k1_want = ray_hits_pinhole_plain(dirs, ph, n_tris, zn, zf)
    err = compare_hits(f"phase 12(e) K1 ray_hits_pinhole ({C_MAX} candidate frames, one launch)",
                       kernels.ray_hits_pinhole(dirs, ph, n_tris, zn, zf, W), k1_want,
                       dirs.shape[0] * dirs.shape[1])
    share = pinhole_tested_share(dirs, ph, n_tris, W)
    bound, all_pairs = k1_bound(dirs.shape[1], [assets.n_tris] * C_MAX, share)
    ops = share * dirs.shape[0] * dirs.shape[1] * assets.n_tris * OPS_K1
    ms = kernels.device_ms(lambda: kernels.ray_hits_pinhole(dirs, ph, n_tris, zn, zf, W), 20)
    plain = kernels.device_ms(lambda: ray_hits_pinhole_plain(dirs, ph, n_tris, zn, zf), 1, 0)
    log(f"phase 12(e) K1 {C_MAX} frames x {dirs.shape[1]} rays x {assets.n_tris} tris [{smi}]: "
        f"{ms:.4f} ms (plain {plain:.2f} ms, bound {bound[0]:.4f} ms by {bound[1]}, the tested "
        f"pairs' no-FMA ceiling {ceiling_ms(ops):.4f} ms, all pairs' operations "
        f"{all_pairs:.4f} ms), max_abs_err {err:.1e}, pairs tested {share:.4f}")

    # K3 over the buffer's capacity, its loop cut at the count; the
    # candidates' frames (a count each) against one GT on the scene axis.
    gen = torch.Generator(device="cpu").manual_seed(12)
    gt = torch.from_numpy(assets.gt_surface).to(dev)
    lo = gt.amin(0).cpu()
    span = (gt.amax(0) - gt.amin(0)).cpu()
    cap = int(params.full_pc_capacity)
    s = (lo + span * torch.rand((cap, 3), generator=gen)).to(dev)
    got = kernels.min_sq_dists(gt, s, n_points)
    want = min_sq_dists_plain(gt, s, n_points)
    same = bool(torch.equal(got, want))
    plan = check_k3_plan("phase 12(e) K3", torch.tensor([n_points], dtype=torch.int32,
                                                        device=dev), gt.shape[0], cap)
    ms = kernels.device_ms(lambda: kernels.min_sq_dists(gt, s, n_points), 10)
    plain = kernels.device_ms(lambda: min_sq_dists_plain(gt, s, n_points), 1, 0)
    ops = gt.shape[0] * n_points * OPS_K3
    bound = bound_ms((gt.shape[0] + n_points) * 12 + gt.shape[0] * 4, ops)
    log(f"phase 12(e) K3 {gt.shape[0]} GT x {cap} slots, {n_points} valid [{smi}]: bit for bit "
        f"{same}, {ms:.4f} ms (plain {plain:.2f} ms, bound {bound[0]:.4f} ms by {bound[1]}, "
        f"ceiling {ceiling_ms(ops):.4f} ms), plan chunk {plan['chunk']}, {plan['items']} items")
    n_slots = int(params.points_per_frame)
    counts = torch.randint(0, n_slots + 1, (C_MAX,), generator=gen).to(torch.int32)
    counts[:2] = torch.tensor([n_slots, 0], dtype=torch.int32)
    sc = (lo + span * torch.rand((C_MAX, n_slots, 3), generator=gen)).to(dev)
    g = gt.expand(C_MAX, -1, -1).contiguous()
    counts = counts.to(dev)
    got = kernels.min_sq_dists_scenes(g, sc, counts)
    want_s = min_sq_dists_scenes_plain(g, sc, counts)
    same_s = bool(torch.equal(got, want_s))
    check_k3_plan("phase 12(e) K3s", counts, gt.shape[0], n_slots)
    ms_s = kernels.device_ms(lambda: kernels.min_sq_dists_scenes(g, sc, counts), 10)
    plain_s = kernels.device_ms(lambda: min_sq_dists_scenes_plain(g, sc, counts), 1, 0)
    pairs = gt.shape[0] * int(counts.sum())
    bound = bound_ms(g.numel() * 4 + int(counts.sum()) * 12 + g.shape[0] * g.shape[1] * 4,
                     pairs * OPS_K3)
    log(f"phase 12(e) K3 scene axis {C_MAX} x {gt.shape[0]} GT x {n_slots} samples, counts "
        f"{int(counts.min())}-{int(counts.max())} [{smi}]: bit for bit {same_s}, {ms_s:.4f} ms "
        f"(plain {plain_s:.2f} ms, bound {bound[0]:.4f} ms by {bound[1]}, ceiling "
        f"{ceiling_ms(pairs * OPS_K3):.4f} ms)")
    if against:
        time_against(against, [
            ("ray_hits_pinhole", f"{C_MAX} candidate frames",
             lambda kern: k1_call(kern, dirs, ph, n_tris, zn, zf, W), k1_want),
            ("min_sq_dists", f"{gt.shape[0]} GT x {cap} slots, {n_points} valid",
             lambda kern: kern.min_sq_dists(gt, s, n_points), want),
            ("min_sq_dists_scenes", f"{C_MAX} x {gt.shape[0]} GT x {n_slots} samples",
             lambda kern: kern.min_sq_dists_scenes(g, sc, counts), want_s)])

    # K2 on one view's visibility rays of the object.
    o_soa = tris_to_soa(torch.from_numpy(obj.tris).to(dev))
    surface = torch.from_numpy(obj.gt_surface[:2048]).to(dev)
    cam = torch.from_numpy(obj.x_max * 1.5).to(dev)
    origins = cam.expand(surface.shape[0], 3).contiguous()
    vdirs = (surface - origins).contiguous()
    err2 = compare_hits("phase 12(e) K2 ray_hits (object visibility)",
                        kernels.ray_hits(origins, vdirs, o_soa, obj.n_tris, 1e-4, 0.999),
                        ray_hits_plain(origins, vdirs, o_soa, obj.n_tris, 1e-4, 0.999),
                        surface.shape[0])
    ms = kernels.device_ms(lambda: kernels.ray_hits(origins, vdirs, o_soa, obj.n_tris,
                                                    1e-4, 0.999), 20)
    plain = kernels.device_ms(lambda: ray_hits_plain(origins, vdirs, o_soa, obj.n_tris,
                                                     1e-4, 0.999), 3)
    ops = surface.shape[0] * obj.n_tris * OPS_K2
    bound = bound_ms(surface.shape[0] * 24 + o_soa.numel() * 4 + surface.shape[0] * 12, ops)
    log(f"phase 12(e) K2 {surface.shape[0]} visibility rays x {obj.n_tris} tris [{smi}]: "
        f"{ms:.4f} ms (plain {plain:.3f} ms, bound {bound[0]:.5f} ms by {bound[1]}, ceiling "
        f"{ceiling_ms(ops):.5f} ms), max_abs_err {err2:.1e}")
    if not (same and same_s):
        raise AssertionError("phase 12(e): K3 differs from its plain version at the NBV shapes")


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


def load_tool(name):
    """A tool of ``tools/``, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        f"tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def stderr_into(path):
    """The process's standard error, its children's too, into ``path``
    inside the block."""
    sys.stderr.flush()
    saved = os.dup(2)
    with open(path, "w") as f:
        os.dup2(f.fileno(), 2)
    try:
        yield
    finally:
        sys.stderr.flush()
        os.dup2(saved, 2)
        os.close(saved)


def run_tool(label, name, argv, tmp):
    """A tool's ``main(argv)`` with the launch counts set to 0 just before
    and read just after; its "# " lines on stderr are logged. Returns
    (its dict, the launches, the seconds, its stderr)."""
    from nextbestpath_tpu_torch import kernels

    err_path = os.path.join(tmp, f"{name}.err")
    tool = load_tool(name)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with stderr_into(err_path):
        out = tool.main(argv)
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    err = open(err_path).read()
    for line in err.splitlines():
        if line.startswith("# "):
            log(f"  {label} {line}")
    return out, launches, seconds, err


def finite_rows(label, table, keys):
    for diff, row in table.items():
        vals = [row[k] for k in keys]
        if not all(v == v and 0.0 <= v <= 1.0 for v in vals):
            raise AssertionError(f"{label}: {diff} row out of range: {row}")


def tools_phase(dev, smi):
    """Phase 15 (module docstring). Returns the launches by kernel of its
    counted paths."""
    import shutil
    import tempfile

    import torch
    from nextbestpath_tpu_torch import kernels
    from nextbestpath_tpu_torch.config import default_params
    from nextbestpath_tpu_torch.eval.heldout import held_out_assets
    from nextbestpath_tpu_torch.eval.nbp_planning import (MAIN_PATH_SEED,
                                                          main_path_setup,
                                                          seeded_nbp)
    from nextbestpath_tpu_torch.eval.quality import load_policy
    from nextbestpath_tpu_torch.eval.scan_rollout import (BatchedScanRollout,
                                                          ScanRollout)
    from nextbestpath_tpu_torch.utils.checkpoint import save_nbp

    t_phase = time.perf_counter()
    by_path = {}
    row_keys = ("nbp_auc", "rw_auc", "nbp_final", "rw_final")
    with tempfile.TemporaryDirectory(prefix="nbp_tools_") as tmp:
        ckpt = os.path.join(tmp, "nbp_best_val.ckpt")
        save_nbp(ckpt, seeded_nbp(), epoch=1)

        # (a) The held-out table at full width in bf16, simple and normal.
        n_a = 8
        ev, by_path["tools_eval"], t, _ = run_tool(
            "phase 15(a)", "eval_vs_random_r2_torch",
            ["--difficulties", "simple,normal", "--scenes-per-diff", "1",
             "--seeds", "1", "--poses", str(n_a), "--weights", ckpt,
             "--out", os.path.join(tmp, "ev.json")], tmp)
        if list(ev["per_difficulty"]) != ["simple", "normal"] or ev["weights_epoch"] != 1:
            raise AssertionError(f"phase 15(a): unexpected table {ev}")
        finite_rows("phase 15(a)", ev["per_difficulty"], row_keys)
        log(f"phase 15(a) eval_vs_random_r2_torch, bf16, simple + normal, 1 scene and 1 "
            f"seed each, {n_a} poses [{smi}]: {t:.1f} s; {ev['per_difficulty']}; launches "
            f"{by_path['tools_eval']}")

        # (b) The promotion gate, A against A, in both modes; then the
        # batch's scenes against single-scene runs at the batch's seeds.
        n_b = 6
        gate = {}
        for mode in ("sequential", "batched"):
            out, by_path[f"tools_gate_{mode}"], t, _ = run_tool(
                f"phase 15(b) {mode}", "compare_ckpts_torch",
                ["--ckpt-a", ckpt, "--ckpt-b", ckpt, "--scenes-per-diff", "1",
                 "--seeds", "1", "--poses", str(n_b), "--mode", mode,
                 "--out", os.path.join(tmp, f"gate_{mode}.json")], tmp)
            gate[mode] = out
            log(f"phase 15(b) compare_ckpts_torch A vs A, --mode {mode}, 4 held-out scenes "
                f"on the insane lattice, {n_b} poses [{smi}]: {t:.1f} s; verdict "
                f"{out['verdict']}, mean AUC {out['mean_auc_a']} vs {out['mean_auc_b']}, "
                f"{out['per_difficulty']}; launches {by_path[f'tools_gate_{mode}']}")
            if (out["verdict"] != "KEEP" or out["mean_auc_a"] != out["mean_auc_b"]
                    or any(r["a"] != r["b"] for r in out["per_difficulty"].values())
                    or not out["mean_auc_a"] > 0):
                raise AssertionError(f"phase 15(b): A against A in {mode} mode: {out}")
        params = default_params()
        assets = held_out_assets(params, scenes_per_diff=1)
        model, _ = load_policy(ckpt, "bfloat16", dev)
        batch = BatchedScanRollout(assets, model, params=params, device=dev).run(
            n_poses=n_b, seed=1000)
        singles = [ScanRollout(a, model, params=params, device=dev).run(
            n_poses=n_b, seed=1000 + i) for i, a in enumerate(assets)]
        gaps = [abs(b.auc - s.auc) for b, s in zip(batch, singles)]
        log(f"phase 15(b) the batched mode's scenes against single-scene runs at their seeds "
            f"(1000 + i; the sequential mode runs every scene from 1000): AUCs "
            f"{[round(b.auc, 5) for b in batch]} vs {[round(s.auc, 5) for s in singles]}, "
            f"max gap {max(gaps):.2e}")
        if max(gaps) > TOL_COVERAGE:
            raise AssertionError("phase 15(b): the batch's scenes disagree with single runs")
        del batch, singles, model

        # (c) The reference protocol's driver through its processes, one
        # level file missing: that level falls back to nbp_best_val.ckpt.
        shutil.copy(ckpt, os.path.join(tmp, "nbp_simple_best_auc.ckpt"))
        n_c = 4
        merged, _, t, err = run_tool(
            "phase 15(c)", "eval101_all_torch",
            ["--poses", str(n_c), "--scenes-per-diff", "1", "--seeds", "1",
             "--difficulties", "simple,normal",
             "--weights", os.path.join(tmp, "nbp_{level}_best_auc.ckpt"),
             "--out", os.path.join(tmp, "eval101.json")], tmp)
        procs = [ln for ln in err.splitlines() if ln.startswith("# kernels: ")]
        sub = dict.fromkeys(kernels.LAUNCHES, 0)
        for ln in procs:
            for k, v in ast.literal_eval(ln.split(" launches ", 1)[1]).items():
                sub[k] += v
        by_path["tools_eval101"] = sub
        log(f"phase 15(c) eval101_all_torch, simple + normal, {n_c} poses, two processes "
            f"[{smi}]: {t:.1f} s; {merged['per_difficulty']}; launches of its processes {sub}")
        if (list(merged["per_difficulty"]) != ["simple", "normal"]
                or "nbp_normal_best_auc.ckpt missing ->" not in err or len(procs) != 2
                or any("compiled=False" not in ln for ln in procs)):
            raise AssertionError("phase 15(c): eval101_all_torch's levels, fallback or "
                                 "library load went wrong")
        finite_rows("phase 15(c)", merged["per_difficulty"], row_keys)

        # (d) The per-level fine-tune from the checkpoint, then its table.
        ft, by_path["tools_finetune"], t, _ = run_tool(
            "phase 15(d)", "finetune_per_level_torch",
            ["--levels", "simple", "--epochs", "2", "--poses", "8",
             "--scenes-per-level", "1", "--eval-every", "1",
             "--eval-scenes-per-level", "1", "--eval-seeds", "1",
             "--init", ckpt, "--weights-dir", os.path.join(tmp, "ft_w"),
             "--log-dir", os.path.join(tmp, "ft_log"), "--db-root", os.path.join(tmp, "ft_db"),
             "--out", os.path.join(tmp, "ft.json")], tmp)
        log(f"phase 15(d) finetune_per_level_torch, simple, 2 epochs of 8 poses, tables at 40 "
            f"poses [{smi}]: "
            f"{t:.1f} s; {ft['per_difficulty']}; launches {by_path['tools_finetune']}")
        finite_rows("phase 15(d)", ft["per_difficulty"], row_keys)

        # (e) The MACARONS quality table at its tiny settings.
        mac, by_path["tools_macarons"], t, _ = run_tool(
            "phase 15(e)", "macarons_e2e_torch",
            ["--tiny", "--train-scenes", "1", "--train-poses", "4", "--eval-poses", "4",
             "--eval-scenes-per-diff", "1", "--eval-seeds", "1",
             "--save", os.path.join(tmp, "mac"), "--out", os.path.join(tmp, "mac.json")], tmp)
        log(f"phase 15(e) macarons_e2e_torch --tiny, 4 training and 4 evaluation poses "
            f"[{smi}]: {t:.1f} s; {mac['per_difficulty']}; launches {by_path['tools_macarons']}")
        finite_rows("phase 15(e)", mac["per_difficulty"],
                    ("nbv_auc", "rw_auc", "nbv_final", "rw_final"))
        if not all(os.path.exists(os.path.join(tmp, "mac", f"scone_{w}.ckpt"))
                   for w in ("occ", "vis")):
            raise AssertionError("phase 15(e): the trained SCONE weights were not saved")

        # (f) One scene head to head, no plot.
        nr, by_path["tools_nbp_vs_random"], t, _ = run_tool(
            "phase 15(f)", "compare_nbp_vs_random_torch",
            ["--weights", ckpt, "--poses", "8", "--out", os.path.join(tmp, "nr.json")], tmp)
        log(f"phase 15(f) compare_nbp_vs_random_torch, simple/8, 8 poses, f32 [{smi}]: "
            f"{t:.1f} s; NBP AUC {nr['nbp']['auc']:.4f}, random {nr['random_walk']['auc']:.4f}; "
            f"launches {by_path['tools_nbp_vs_random']}")
        if nr["weights"] != "trained(e1)" or len(nr["nbp"]["coverage_evolution"]) != 8:
            raise AssertionError(f"phase 15(f): unexpected result {nr}")
        rises("phase 15(f) NBP", nr["nbp"]["coverage_evolution"])
        rises("phase 15(f) random walk", nr["random_walk"]["coverage_evolution"])
        if any(f.endswith(".png") for f in os.listdir(tmp)):
            raise AssertionError("phase 15(f): a plot was drawn without --plot")

    # (g) The reference's horizon: 101 poses of the main path's scene at
    # full width, past the point buffer's capacity. The rollout's metric is
    # the JAX package's stride subsample of a fixed size, which falls as
    # the cloud grows with revisited points (as JAX's does); the exact
    # coverage of the buffer, every GT point against every stored point,
    # must not fall, and a run of the same seed keeps its earlier runs'
    # rows as their prefix: the rows past capacity are dropped.
    params, assets, model = main_path_setup()
    cap = int(params.full_pc_capacity)
    n_g = 101
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    roll = ScanRollout(assets, model, params=params, device=dev)
    res = roll.run(n_poses=n_g, seed=MAIN_PATH_SEED)
    by_path["horizon101"] = dict(kernels.LAUNCHES)
    cov = res.coverage_evolution
    n_regen = sum(roll.regen_poses)
    gt = torch.from_numpy(assets.gt_surface).to(dev).contiguous()

    def buffer_now():
        c = int(roll.state.pc.count)
        pts = roll.state.pc.points.contiguous()
        d2 = kernels.min_sq_dists(gt, pts, torch.tensor([c], dtype=torch.int32, device=dev))
        return c, pts[:c].clone(), float((torch.sqrt(d2) < 1.0).float().mean())

    full = buffer_now()
    earlier = {}
    for n in (40, 70):
        r = roll.run(n_poses=n, seed=MAIN_PATH_SEED)
        earlier[n] = buffer_now() + (r.coverage_evolution == cov[:n],)
    falls = [(i + 1, round(b - a, 5)) for i, (a, b) in enumerate(zip(cov, cov[1:])) if b < a]
    log(f"phase 15(g) scan rollout simple/{MAIN_PATH_SEED}, {n_g} poses, f32 [{smi}]: "
        f"{res.wall_time_s / n_g * 1e3:.2f} ms a pose, {n_regen} regeneration poses, points "
        f"{res.n_points} of {cap}; sampled coverage every 10 poses "
        f"{[round(c, 4) for c in cov[::10]]}, final {cov[-1]:.4f}, auc {res.auc:.4f}, "
        f"{len(falls)} poses below the one before (largest {min(f[1] for f in falls) if falls else 0}); "
        f"exact coverage of the buffer after 40 / 70 / 101 poses "
        f"{earlier[40][2]:.5f} / {earlier[70][2]:.5f} / {full[2]:.5f} at "
        f"{earlier[40][0]} / {earlier[70][0]} / {full[0]} points; launches {by_path['horizon101']}")
    ok = (res.n_points == cap == full[0] and all(0.0 <= c <= 1.0 for c in cov)
          and cov[-1] > cov[0] and earlier[40][0] < earlier[70][0] <= cap
          and earlier[40][2] <= earlier[70][2] <= full[2])
    for n, (c, pts, _, same_curve) in earlier.items():
        ok = ok and same_curve and torch.equal(pts, full[1][:c])
    if not ok:
        raise AssertionError(f"phase 15(g): the buffer must end at {cap} points, keep the "
                             f"earlier runs' rows and never lose exact coverage")
    log(f"phase 15 wall time {time.perf_counter() - t_phase:.1f} s [{smi}]")
    return by_path

def expect_kernels(label, launches, names):
    """Each kernel of ``names`` launched on the path at least once."""
    missing = [k for k in names if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"{label}: kernels {missing} not launched: {launches}")


def probes_phase(dev, smi):
    """Phase 16 (module docstring). Returns the launches by kernel of its
    counted paths."""
    import tempfile

    import numpy as np
    import torch
    from nextbestpath_tpu_torch import kernels
    from nextbestpath_tpu_torch.draws import TorchDraws
    from nextbestpath_tpu_torch.eval.nbp_planning import (MAIN_PATH_SEED,
                                                          main_path_setup,
                                                          seeded_nbp)
    from nextbestpath_tpu_torch.eval.scan_rollout import ScanRollout
    from nextbestpath_tpu_torch.geometry.cameras import CameraIntrinsics
    from nextbestpath_tpu_torch.models.manydepth import ManyDepth
    from nextbestpath_tpu_torch.train.pretrain_depth import save_depth_checkpoint
    from nextbestpath_tpu_torch.train.scan_collection import ScanCollection
    from nextbestpath_tpu_torch.utils.checkpoint import save_nbp

    t_phase = time.perf_counter()
    by_path = {}
    K1, K2, K3 = "ray_hits_pinhole", "ray_hits", "min_sq_dists"
    plan = ("bfs_field", "extract_path")
    with tempfile.TemporaryDirectory(prefix="nbp_probes_") as tmp:
        ckpt = os.path.join(tmp, "nbp_best_val.ckpt")
        save_nbp(ckpt, seeded_nbp(), epoch=1)

        # (a) The oracle NBV against the walk: one simple scene, 5 poses.
        n_a = 5
        orc, by_path["probe_oracle"], t, _ = run_tool(
            "phase 16(a)", "probe_nbv_oracle_torch",
            ["--eval-poses", str(n_a), "--eval-scenes-per-diff", "1",
             "--eval-seeds", "1", "--out", os.path.join(tmp, "oracle.json")], tmp)
        finite_rows("phase 16(a)", orc["per_difficulty"],
                    ("oracle_auc", "rw_auc", "oracle_final", "rw_final"))
        expect_kernels("phase 16(a)", by_path["probe_oracle"],
                       (K1, K2, "min_sq_dists_scenes", "ray_hits_pinhole_scenes"))
        log(f"phase 16(a) probe_nbv_oracle_torch, simple, 1 scene, 1 seed, {n_a} poses "
            f"[{smi}]: {t:.1f} s; {orc['per_difficulty']}; launches {by_path['probe_oracle']}")

        # (b) The value decoder's share: one scene a level, 10 poses a mode
        # in bf16; then the captured value_flat rollout against its eager
        # run on the main path's scene, bit for bit.
        n_b = 10
        val, by_path["probe_value"], t, _ = run_tool(
            "phase 16(b)", "probe_value_contribution_torch",
            ["--ckpt", ckpt, "--poses", str(n_b), "--scenes-per-diff", "1",
             "--seeds", "1", "--out", os.path.join(tmp, "value.json")], tmp)
        if set(val["per_difficulty"]) != {"simple", "normal", "hard", "insane"} or not all(
                v == v and 0.0 <= v for row in val["per_scene"].values() for v in row.values()):
            raise AssertionError(f"phase 16(b): unexpected result {val}")
        expect_kernels("phase 16(b)", by_path["probe_value"], (K1, K2, K3) + plan)
        log(f"phase 16(b) probe_value_contribution_torch, bf16, 1 scene a level, {n_b} "
            f"poses a mode [{smi}]: {t:.1f} s; {val['per_difficulty']}; launches "
            f"{by_path['probe_value']}")
        params, assets, model = main_path_setup()
        flat = ScanRollout(assets, model, params=params, value_flat=True, device=dev)
        got = flat.run(n_poses=n_b, seed=MAIN_PATH_SEED)
        flat._use_graphs = False
        want = flat.run(n_poses=n_b, seed=MAIN_PATH_SEED)
        plain = ScanRollout(assets, model, params=params, device=dev).run(
            n_poses=n_b, seed=MAIN_PATH_SEED)
        same = (got.coverage_evolution == want.coverage_evolution
                and np.array_equal(got.cam_positions, want.cam_positions)
                and got.n_points == want.n_points)
        log(f"phase 16(b) value_flat scan rollout simple/{MAIN_PATH_SEED}, {n_b} poses: "
            f"captured equal to eager {same}; auc {got.auc:.4f} against the trained-map "
            f"rollout's {plain.auc:.4f}, the same trajectory "
            f"{np.array_equal(got.cam_positions, plain.cam_positions)}")
        if not same:
            raise AssertionError("phase 16(b): the captured value_flat rollout differs "
                                 "from its eager run")

        # (c) The suffix labels' reliability: a branch at pose 5, two
        # continuations of 5 poses; then the branch itself, checked.
        lab, by_path["probe_labels"], t, _ = run_tool(
            "phase 16(c)", "probe_label_quality_torch",
            ["--ckpt", ckpt, "--branch-poses", "5", "--continuations", "2",
             "--cont-poses", "5", "--out", os.path.join(tmp, "labels.json")], tmp)
        expect_kernels("phase 16(c)", by_path["probe_labels"], (K1, K2, K3) + plan)
        entry = lab["branches"][0]
        log(f"phase 16(c) probe_label_quality_torch, bf16, branch at pose 5, 2 "
            f"continuations of 5 poses [{smi}]: {t:.1f} s; {entry}; launches "
            f"{by_path['probe_labels']}")
        if len(entry["labels_per_continuation"]) != 2 or entry["n_pixels_total"] <= 0:
            raise AssertionError(f"phase 16(c): unexpected report {entry}")
        # The branch with the collection's own steps: both continuations
        # start at the mid-state's pose and plan there (row 0), part where
        # their draws do, and a restore replays a continuation bit for bit.
        from nextbestpath_tpu_torch.eval.quality import load_policy
        from nextbestpath_tpu_torch.train.scan_collection import suffix_labels_from_out

        pol, _ = load_policy(ckpt, "bfloat16", dev)
        col = ScanCollection([assets], pol, params=params, device=dev)
        draws = col.begin(0, seed=777, n_poses=10)
        col.advance(5, draws, run_frozen=True)
        col.force_replan()
        snap = col.snapshot()
        mid_pose = col._pose5(col.state.cur).cpu().numpy()
        outs = []
        for k in range(2):
            col.restore(snap)
            outs.append(col.advance(5, TorchDraws(10_000 + 97 * k, dev)))
        col.restore(snap)
        again = col.advance(5, TorchDraws(10_000, dev))
        vms, rng = int(params.value_map_size[0]), tuple(params.prediction_range)
        rows0 = [[(i, px.tolist()) for i, px, _ in suffix_labels_from_out(o, vms, rng)
                  if i == 0] for o in outs]
        ok = (all(np.array_equal(o.pose5[0], mid_pose) and o.planned[0] for o in outs)
              and all(np.array_equal(a, b) for a, b in zip(again, outs[0]))
              and not np.array_equal(outs[0].pose5, outs[1].pose5)
              and rows0[0] != rows0[1])
        log(f"phase 16(c) branch at pose 5: row 0 at the mid-state's pose "
            f"{mid_pose.round(3).tolist()} in both continuations, planned "
            f"{[bool(o.planned[0]) for o in outs]}; their paths differ "
            f"{not np.array_equal(outs[0].pose5, outs[1].pose5)}, their row-0 labels "
            f"{[len(r[0][1]) if r else 0 for r in rows0]} pixels, differ "
            f"{rows0[0] != rows0[1]}; a restore replays continuation 0 bit for bit "
            f"{all(np.array_equal(a, b) for a, b in zip(again, outs[0]))}")
        if not ok:
            raise AssertionError("phase 16(c): the branch's continuations do not start at "
                                 "row 0 of the mid-state, part or replay")

        # (d) ManyDepth on one window: 12 frames, 10 steps.
        conv, by_path["probe_depth_conv"], t, _ = run_tool(
            "phase 16(d)", "depth_convergence_probe_torch",
            ["--frames", "12", "--steps", "10", "--eval-every", "5",
             "--out", os.path.join(tmp, "conv.json")], tmp)
        finite("phase 16(d) photometric losses", conv["photometric_curve"], 10)
        finite("phase 16(d) held-out errors", [e for _, e in conv["heldout_abs_err"]], 3)
        expect_kernels("phase 16(d)", by_path["probe_depth_conv"], (K1, K2))
        log(f"phase 16(d) depth_convergence_probe_torch, 256x456, 12 frames, 10 steps "
            f"[{smi}]: {t:.1f} s; {conv['summary']}; launches {by_path['probe_depth_conv']}")

        # (e) Online depth learning's quality: 6 poses a run.
        dq, by_path["probe_depth_quality"], t, _ = run_tool(
            "phase 16(e)", "depth_quality_probe_torch",
            ["--poses", "6", "--out", os.path.join(tmp, "dq.json")], tmp)
        summ = dq["summary"]
        finite("phase 16(e) summary", [v for v in summ.values()])
        if not (0.0 < summ["coverage_perfect_depth"] <= 1.0
                and 0.0 < summ["coverage_predicted_depth"] <= 1.0):
            raise AssertionError(f"phase 16(e): unexpected summary {summ}")
        expect_kernels("phase 16(e)", by_path["probe_depth_quality"], (K1, K2, K3))
        log(f"phase 16(e) depth_quality_probe_torch, 256x456, 6 poses a run [{smi}]: "
            f"{t:.1f} s; {summ}; launches {by_path['probe_depth_quality']}")

        # (f) The eval gap on a seeded checkpoint that this phase writes:
        # the procgen faces are one grey, so both renders score alike.
        torch.manual_seed(0)
        depth_ckpt = os.path.join(tmp, "depth.ckpt")
        save_depth_checkpoint(depth_ckpt, ManyDepth(CameraIntrinsics(
            image_height=int(params.image_height), image_width=int(params.image_width))),
            0, 0.0)
        gap, by_path["probe_depth_gap"], t, _ = run_tool(
            "phase 16(f)", "probe_depth_eval_gap_torch",
            ["--ckpt", depth_ckpt, "--trials", "1",
             "--out", os.path.join(tmp, "gap.json")], tmp)
        expect_kernels("phase 16(f)", by_path["probe_depth_gap"], (K1, K2))
        log(f"phase 16(f) probe_depth_eval_gap_torch, 256x456, 1 trial [{smi}]: {t:.1f} s; "
            f"{gap['trials']}; launches {by_path['probe_depth_gap']}")
        if not all(math.isfinite(r["plain_err"]) and r["plain_err"] == r["textured_err"]
                   for r in gap["trials"]):
            raise AssertionError(f"phase 16(f): plain and textured errors differ: {gap}")
    log(f"phase 16 wall time {time.perf_counter() - t_phase:.1f} s [{smi}]")
    return by_path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", default=None,
                    help="another checkout whose K2 and planner kernels to time at "
                         "phase 3's shapes")
    ap.add_argument("--phase", type=int, choices=[14, 15, 16, 17], default=None,
                    help="run phases 1, 2 and this one alone (no result line)")
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
    from nextbestpath_tpu_torch.ops.raytrace import (frame_rays, pinhole_tested_share,
                                                     pinhole_tri_soa,
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

    if args.phase == 14:
        pretrain_phase(dev, smi)
        return 0
    if args.phase == 15:
        tools_phase(dev, smi)
        return 0
    if args.phase == 16:
        probes_phase(dev, smi)
        return 0
    if args.phase == 17:
        g_params = default_params()
        gumbel_phase(g_params, pack_generated_scene(
            generate_scene("simple", seed=MAIN_PATH_SEED), params=g_params), dev, smi)
        return 0

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
    dirs4 = dirs4.contiguous()
    dirs1, ph1 = dirs4[-1:].contiguous(), ph4[-1:].contiguous()
    W = intr.image_width
    insane = pack_generated_scene(generate_scene("insane", seed=MAIN_PATH_SEED))
    i_soa = tris_to_soa(torch.from_numpy(insane.tris).to(dev))
    i_nt = torch.tensor([insane.n_tris], dtype=torch.int32, device=dev)
    i_poses = main_path_move(insane, n_steps, dev)
    i_eyes, i_dirs = frame_rays(*get_camera_RT(i_poses[:, :3], i_poses[:, 3:]), intr)
    i_dirs, i_ph = i_dirs.contiguous(), pinhole_tri_soa(i_soa, i_eyes)
    k1, against = {}, []
    for b, (d, ph, c_nt, tris) in ((1, (dirs1, ph1, n_tris, nt)),
                                   (n_steps, (dirs4, ph4, n_tris, nt)),
                                   ("insane", (i_dirs, i_ph, i_nt, insane.n_tris))):
        label = (f"{b} frame{'s' * (b != 1)}" if b != "insane"
                 else f"insane/{MAIN_PATH_SEED}, {n_steps} frames")
        got = kernels.ray_hits_pinhole(d, ph, c_nt, zn, zf, W)
        want = ray_hits_pinhole_plain(d, ph, c_nt, zn, zf)
        err = compare_hits(f"K1 ray_hits_pinhole ({label}, one launch, 8x16 tiles)",
                           got, want, d.shape[0] * d.shape[1])
        n = d.shape[0] * d.shape[1]
        share = pinhole_tested_share(d, ph, c_nt, W)
        bound, all_pairs = k1_bound(d.shape[1], [tris] * d.shape[0], share)
        k1[b] = dict(
            err=err, n=n, ops=share * n * tris * OPS_K1, tris=tris, bound=bound,
            all_pairs=all_pairs, share=share,
            ms=kernels.device_ms(lambda: kernels.ray_hits_pinhole(d, ph, c_nt, zn, zf, W), 50),
            plain_ms=kernels.device_ms(lambda: ray_hits_pinhole_plain(d, ph, c_nt, zn, zf),
                                       3 if b != "insane" else 1))
        against.append((
            "ray_hits_pinhole", label,
            lambda kern, d=d, ph=ph, c=c_nt: k1_call(kern, d, ph, c, zn, zf, W), want))
    for b, r in k1.items():
        log(f"  ray_hits_pinhole {b}: {r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound'][0]:.4f} ms by {r['bound'][1]}, the tested pairs' no-FMA ceiling "
            f"{ceiling_ms(r['ops']):.4f} ms, all pairs' operations {r['all_pairs']:.4f} ms); "
            f"pairs tested {r['share']:.4f} of {r['tris']} tris")
    # At frames that are no multiple of the tile: the pretrainers' 64x114
    # and 32x56.
    for hh, ww in ((64, 114), (32, 56)):
        s_intr = CameraIntrinsics(hh, ww, float(params.fov_degrees), zn, zf)
        s_eyes, s_dirs = frame_rays(R, T, s_intr)
        s_ph, s_dirs = pinhole_tri_soa(soa, s_eyes), s_dirs.contiguous()
        compare_hits(f"K1 ray_hits_pinhole ({n_steps} frames of {hh}x{ww})",
                     kernels.ray_hits_pinhole(s_dirs, s_ph, n_tris, zn, zf, ww),
                     ray_hits_pinhole_plain(s_dirs, s_ph, n_tris, zn, zf),
                     s_dirs.shape[0] * s_dirs.shape[1])
    b4, b1 = k1[n_steps], k1[1]
    rows.append(dict(
        name="ray_hits_pinhole", route="cuda",
        source="nextbestpath_tpu_torch/csrc/raytrace.cu",
        replaces="nextbestpath_tpu/ops/raytrace.py:234",
        max_abs_err=max(b1["err"], b4["err"]),
        ms=b4["ms"], plain_ms=b4["plain_ms"], bound_ms=b4["bound"][0],
        bound_by=b4["bound"][1], ceiling_ms=ceiling_ms(b4["ops"]), library_ms=None,
        tested_share=b4["share"], all_pairs_ops_ms=b4["all_pairs"],
        ms_per_frame=b4["ms"] / n_steps, b1_ms=b1["ms"], b1_plain_ms=b1["plain_ms"],
        b1_bound_ms=b1["bound"][0], b1_ceiling_ms=ceiling_ms(b1["ops"]),
        shape=f"{n_steps} frames x {b1['n']} rays x {nt} tris in one launch"))

    # K2 at the scene tables' one launch (the main path's shape), the inside
    # test alone, the `insane` scene's tables and a frame's rays with an
    # origin each (k2_cases), and at n_tris = 0: the launch and the block
    # scheduling alone, the floor under the small shapes.
    k2 = {}
    for case in k2_cases(assets, insane, eyes[-1], dirs4[-1], zn, zf):
        o, d, c_soa, c_nt = case["origins"], case["dirs"], case["soa"], case["n_tris"]
        n, lo, hi = o.shape[0], case["t_min"], case["t_max"]
        want = ray_hits_plain(o, d, c_soa, case["nt"], lo, hi)
        against.append((
            "ray_hits", f"{case['name']}, {n} rays x {case['nt']} tris",
            lambda kern, o=o, d=d, c_soa=c_soa, c_nt=c_nt, lo=lo, hi=hi: kern.ray_hits(
                o, d, c_soa, c_nt, lo, hi), want))
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
    n_blocks = kernels.min_sq_dists_blocks()
    c_one = torch.tensor([n_s], dtype=torch.int32, device=dev)
    log(f"K3: {n_blocks} resident blocks; plan at {g.shape[0]} GT x {n_s} samples, full "
        f"count: {kernels.min_sq_dists_plan([n_s], g.shape[0], n_s, n_blocks)}; the plan "
        f"alone (the fill kernel with no output, after a torch.full) "
        f"{kernels.device_ms(lambda: kernels.min_sq_dists_device_plan(c_one, g.shape[0], n_s), 50):.4f}"
        f" ms")
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
        check_k3_plan(f"K3 ({label} count)", count, g.shape[0], n_s)
        err = max(err, e)
        counts[label] = (s_in, count)
        if label != "empty":
            against.append(("min_sq_dists", f"{g.shape[0]} GT x {n_s} samples, {c} valid",
                             lambda kern, s_in=s_in, count=count: kern.min_sq_dists(g, s_in, count),
                             d2_p))
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
    # The planner kernels at the main path's lattice, the harder levels'
    # (the scene K2 took above, and ``hard``), a maze and the thin shapes.
    hard = pack_generated_scene(generate_scene("hard", seed=MAIN_PATH_SEED))
    max_len = int(params.max_path_len)
    plan_rows, plan_against = plan_kernel_rows(plan_cases(assets, insane, hard, dev),
                                               max_len, dev)
    rows += plan_rows
    scene_rows, scene_against = scene_kernel_rows(params, intr, dev)
    rows += scene_rows
    if args.against:
        time_against(args.against, against + plan_against + scene_against)
    del against, plan_against, scene_against
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
        # The scene-axis launchers run on phase 10's path, the Gumbel draw's
        # on the NBV's (phase 12), not this one.
        if k <= 0 and not name.endswith("_scenes") and not name.startswith("gumbel_"):
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
    # 12. The MACARONS greedy NBV: learned, oracle and object-level.
    by_path.update(nbv_phase(params, assets, dev, smi, args.against))
    # 13. The MACARONS online trainer: perfect depth, learned depth, the
    # full stack with the memory, the card against the CPU, the kernels.
    by_path.update(macarons_train_phase(params, assets, dev, smi))
    # 14. The pretrainers: depth at full width, SCONE on object and
    # interior samples, the card against the CPU, the kernels.
    by_path.update(pretrain_phase(dev, smi))
    # 15. The policy-quality tools' mains against a seeded checkpoint, and
    # a 101-pose rollout past the point buffer's capacity.
    by_path.update(tools_phase(dev, smi))
    # 16. The research probes' mains at full width: the oracle NBV, the
    # value_flat ablation, a collection branched from a mid-state, and
    # the three ManyDepth probes.
    by_path.update(probes_phase(dev, smi))
    # 17. The Gumbel-max token draw's kernels G1 and G2: bits, tokens, times.
    rows += gumbel_phase(params, assets, dev, smi)
    for r in rows:
        for path, counts in by_path.items():
            r["launches_by_path"][path] = counts[r["name"]]
            r["launches"] += counts[r["name"]]
        if r["launches"] <= 0:
            raise AssertionError(f"kernel {r['name']} was launched on no main path")

    log(smi)
    keys = ("name", "route", "source", "replaces", "launches", "launches_by_path",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "ceiling_ms",
            "library_ms", "tested_share", "all_pairs_ops_ms")
    print(json.dumps({"kernels": [{k: r.get(k) for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
