"""Where a pose's time goes: a planning rollout under ``torch.profiler``.

    python3 -m nextbestpath_tpu_torch.profile_rollout [--poses 6]
        [--rollout host|scan|cli|train|collect|dp] [--ranks N]
        [--difficulty simple|normal|hard|insane]

Runs the main path that ``chip_smoke.py`` drives
(``eval.nbp_planning.main_path_setup``: procgen ``simple`` seed 8, default
config, full-width NBP in f32 with seeded weights and the obstacle decoder
opened) through the host rollout (``NBPPlanningRollout``, ``shared_rng``),
the scan rollout (``ScanRollout``) or the evaluation CLI's configuration
(``cli``: the host rollout in its default legacy mode with the same
weights in bf16), warms up as the smoke does, then profiles
``--poses`` poses on the card: the scan twice, its pose replayed as CUDA
graphs and then the same steps run eagerly, whose stage ranges split the
graphs' device time by stage. Prints, a run:

* the wall time a pose under the profiler and, from a run of the same
  poses just before it, without; the device's busy time (the union of the
  device activities' intervals, the stage annotations left out) and its
  share of both walls;
* each stage's range (a span of ``utils/timing.py``: coverage, observe,
  projections, unet, move in the eager steps; pre, plan, post around each
  step, replayed or eager): its host time, and the device time of the
  activities that start inside the range's extent on the device (the
  profiler's user annotation), a pose;
* the host time blocked in syncs (stream, device and event synchronizes,
  and blocking copies), against the wall: the rest of the host's time is
  dispatch;
* the operations with the most device time, then those with the most
  host time. Needs a CUDA card.

``--difficulty`` (host, scan and cli) takes the procgen scene of that
level, seed 8, in place of the main path's ``simple`` one: the harder
levels' lattices are 26x26 (normal), 40x40 (hard) and 58x58 (insane).

``--rollout collect`` profiles the scan trainer's collection
(``train.scan_collection.ScanCollection``, what ``chip_smoke.py`` phase 9
times) on the same scene with the bf16 NBP, folded, as graphs and then
eagerly, after a warm-up of each; its stages add ``model_input`` and
``gt_layout``.

``--rollout train`` profiles the trainer's step instead (what
``chip_smoke.py`` phase 8 times): the main path's scene collected for 12
poses with the full-width f32 NBP, 56 of its experiences staged, one
accumulation cycle (7 micro steps of 8 and the AdamW step) as warm-up,
then ``--poses`` cycles profiled; the ranges are the step's (forward,
backward, accumulate, optimizer), with their host time only (autograd
launches the backward's kernels from its own thread, outside them); the
split of the device time is by operation.

``--rollout dp [--ranks N]`` profiles the data-parallel micro step
(``parallel/dp.py``, what ``chip_smoke.py`` phase 11 times) beside the
single-process one: N NCCL ranks, one a card (default 1), spawned
through ``parallel/launch.py``, the bf16 full-width NBP, 56 experiences
of the main path's scene (rank 0's, sent to every rank), one cycle (7
micro steps of 8 and the AdamW step) of each as warm-up, then ``--poses``
cycles of each, profiled on rank 0 and run alike on the others; the DP
step's ranges add ``grad_all_reduce``.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .assets import generate_scene, pack_generated_scene
from .eval.macarons_nbv import NBV_STAGES
from .eval.nbp_planning import (MAIN_PATH_DIFFICULTY, MAIN_PATH_SEED,
                                MAIN_PATH_WARMUP_POSES, NBPPlanningRollout,
                                main_path_setup, seeded_nbp)
from .eval.scan_rollout import ScanRollout

STAGES = tuple(dict.fromkeys((
    "coverage", "observe", "projections", "model_input", "gt_layout", "unet",
    "plan", "move", "pre", "post", "forward", "backward", "accumulate",
    "optimizer", "grad_all_reduce") + NBV_STAGES))
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpyAsync")


def _is_annotation(e) -> bool:
    return e.name in STAGES or bool(getattr(e, "is_user_annotation", False))


def _device_spans(prof):
    """(kernel spans, stage spans) on the device timeline, in us: the
    device's activities, and the device-side extent of each stage range
    (the profiler's user annotations). Read from the profiler's raw
    events: ``prof.events()`` builds a tree of every host operation first,
    which takes minutes on a long trace."""
    kernels, stages = [], collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        span = (e.start_ns() / 1e3, e.end_ns() / 1e3)
        if e.name() in STAGES or e.is_user_annotation():
            stages[e.name()].append(span)
        else:
            kernels.append(span)
    return sorted(kernels), stages


def _union_us(spans) -> float:
    """Length of the union of the intervals, in us."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _stage_device_us(kernels, spans) -> float:
    """Device time of the activities that start inside the stage's spans
    (nested stages count in each: ``plan`` holds ``projections`` and
    ``unet``)."""
    starts = [k[0] for k in kernels]
    return sum(_union_us(kernels[bisect.bisect_left(starts, s):
                                 bisect.bisect_left(starts, e)])
               for s, e in spans)


def _runs(kind: str, difficulty: str = MAIN_PATH_DIFFICULTY):
    """(label, run(n_poses)) pairs to profile, each warmed up, on the
    procgen scene of ``difficulty`` (seed MAIN_PATH_SEED)."""
    params, assets, model = main_path_setup()
    if difficulty != MAIN_PATH_DIFFICULTY:
        assets = pack_generated_scene(generate_scene(difficulty, seed=MAIN_PATH_SEED),
                                      params=params)
    dev = torch.device("cuda")
    if kind in ("host", "cli"):
        if kind == "cli":
            model = seeded_nbp(dtype=torch.bfloat16)

        def make():
            return NBPPlanningRollout(assets, model, params=params,
                                      seed=MAIN_PATH_SEED,
                                      shared_rng=kind == "host", device=dev)
        make().run(n_poses=MAIN_PATH_WARMUP_POSES)
        roll = make()
        return [(kind, lambda n: roll.run(n_poses=n))]
    scan = ScanRollout(assets, model, params=params, device=dev)
    # Each mode warms up on its own: the capture, and the eager steps'
    # allocations outside the graphs' memory pool.
    for graphs in (True, False):
        scan._use_graphs = graphs
        scan.run(n_poses=MAIN_PATH_WARMUP_POSES, seed=MAIN_PATH_SEED)

    def run(graphs):
        def go(n):
            scan._use_graphs = graphs
            return scan.run(n_poses=n, seed=MAIN_PATH_SEED)
        return go
    return [("scan graphs", run(True)), ("scan eager", run(False))]


class _Curve:
    """A collection rollout's result in the shape ``_profile`` prints."""

    def __init__(self, out, n):
        self.coverage_evolution = [float(c) for c in out.coverage[:n]]


def _collect_runs():
    """[("collect graphs", run), ("collect eager", run)], each warmed up."""
    from .train.scan_collection import ScanCollection

    params, assets, _ = main_path_setup()
    dev = torch.device("cuda")
    # On the card, as the trainer's model is: each run refolds it there.
    model = seeded_nbp(dtype=torch.bfloat16).to(dev)
    coll = ScanCollection([assets], model, params=params, device=dev)
    for graphs in (True, False):
        coll._use_graphs = graphs
        coll.run(0, model, seed=MAIN_PATH_SEED,
                 n_poses=MAIN_PATH_WARMUP_POSES)

    def run(graphs):
        def go(n):
            coll._use_graphs = graphs
            return _Curve(coll.run(0, model, seed=MAIN_PATH_SEED, n_poses=n),
                          n)
        return go
    return [("collect graphs", run(True)), ("collect eager", run(False))]


class _Cycles:
    """The result of ``n`` training cycles, in the shape ``_profile``
    prints: one 'pose' a cycle, its mean loss as the 'coverage'."""

    def __init__(self, losses):
        self.coverage_evolution = losses


def _train_runs():
    """[("train", run(n_cycles))], warmed up by one cycle."""
    import random

    from .train import train_nbp as TT
    from .train.collection import collect_trajectory
    from .train.replay import ReplayDB

    params, assets, model = main_path_setup()
    dev = torch.device("cuda")
    model = model.to(dev)
    db = ReplayDB()
    collect_trajectory(assets, model, db, params=params, seed=MAIN_PATH_SEED,
                       n_poses=12, device=dev)
    data = (db.entries * (56 // len(db.entries) + 1))[:56]
    state = TT.init_train_state(model)
    ds, _ = TT.build_device_dataset(data, dev)
    rng = random.Random(0)

    def run(n):
        return _Cycles([TT.train_epoch_ds(state, ds, list(range(56)), rng)[1]
                        for _ in range(n)])
    run(1)
    return [("train cycle", run)]


def _dp_rank(mesh, n: int) -> None:
    """A rank of ``--rollout dp``: the bf16 micro step in one process and
    over the ranks, each warmed up by one cycle, then profiled (rank 0,
    which prints) or run alike (the others)."""
    import copy
    import random

    import torch.distributed as dist

    from .parallel.dp import dp_step
    from .train import train_nbp as TT
    from .train.collection import collect_trajectory
    from .train.replay import ReplayDB

    params, assets, model = main_path_setup()
    dev = mesh.device
    box = [None]
    if mesh.rank == 0:
        db = ReplayDB()
        collect_trajectory(assets, model.to(dev), db, params=params,
                           seed=MAIN_PATH_SEED, n_poses=12, device=dev)
        box = [db.entries]
    dist.broadcast_object_list(box, src=0)
    data = (box[0] * (56 // len(box[0]) + 1))[:56]
    ds, _ = TT.build_device_dataset(data, dev)
    bf16 = seeded_nbp(dtype=torch.bfloat16).to(dev)
    single = TT.init_train_state(bf16)
    dp = TT.init_train_state(copy.deepcopy(bf16))
    rng = random.Random(0)

    def run_single(k):
        return _Cycles([TT.train_epoch_ds(single, ds, list(range(56)),
                                          rng)[1] for _ in range(k)])

    def run_dp(k):
        return _Cycles([TT.train_epoch_ds(dp, ds, list(range(56)), rng,
                                          loss_and_grads=dp_step(mesh))[1]
                        for _ in range(k)])
    run_single(1)
    run_dp(1)
    for label, run in (("train cycle", run_single),
                       (f"train cycle dp over {mesh.size} rank(s)", run_dp)):
        if mesh.rank == 0:
            _profile(label, run, n)
        else:
            run(n)
            run(n)


def _profile(label: str, run, n: int) -> None:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(n)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run(n)
        wall = time.perf_counter() - t0
    events = prof.events()
    kernels, stage_spans = _device_spans(prof)
    busy = _union_us(kernels) / 1e6
    u = "cycle" if label.startswith("train") else "pose"
    print(f"{label}{' rollout' if u == 'pose' else ''}, profiled {n} {u}s: {wall / n * 1e3:.2f} ms/{u} "
          f"(under the profiler), device busy {busy / n * 1e3:.3f} ms/{u}, "
          f"{busy / wall:.3f} of the wall; the same run without the profiler "
          f"{plain_wall / n * 1e3:.2f} ms/{u}, of which the device busy time is "
          f"{busy / plain_wall:.3f}; {'loss' if u == 'cycle' else 'coverage'} "
          f"{res.coverage_evolution}")
    host = collections.defaultdict(lambda: [0, 0.0])
    syncs = collections.defaultdict(lambda: [0, 0.0])
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            continue
        table = host if e.name in STAGES else syncs if e.name in SYNC_CALLS else None
        if table is not None:
            table[e.name][0] += 1
            table[e.name][1] += e.cpu_time_total
    for name in STAGES:
        if name in host:
            k, host_us = host[name]
            # Autograd launches the backward from its own thread, outside
            # the step's ranges: a training range's device time is not its.
            dev = "" if u == "cycle" else (
                f", device {_stage_device_us(kernels, stage_spans.get(name, [])) / n / 1e3:.3f}"
                f" ms/{u}")
            print(f"  stage {name}: {k / n:.2f} a {u}, host {host_us / n / 1e3:.3f} "
                  f"ms/{u}{dev}")
    blocked = sum(v[1] for v in syncs.values()) / 1e6
    print(f"  host blocked in syncs {blocked / n * 1e3:.3f} ms/{u} "
          f"({blocked / wall:.3f} of the wall; "
          + ", ".join(f"{k} {v[0] / n:.1f} a {u}" for k, v in syncs.items())
          + f"); device idle {1 - busy / wall:.3f} of the wall")
    print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                    row_limit=25))
    print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                    row_limit=15))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--poses", type=int, default=6)
    ap.add_argument("--rollout",
                    choices=("host", "scan", "cli", "train", "collect", "dp"),
                    default="host")
    ap.add_argument("--ranks", type=int, default=1,
                    help="--rollout dp: NCCL ranks, one a card")
    ap.add_argument("--difficulty", default=MAIN_PATH_DIFFICULTY,
                    choices=("simple", "normal", "hard", "insane"),
                    help="--rollout host|scan|cli: the procgen level's scene")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_rollout needs a CUDA card")
    if args.rollout == "dp":
        from .parallel.launch import spawn
        spawn(_dp_rank, args.ranks, device="cuda", backend="nccl",
              args=(args.poses,), timeout_s=900.0)
        return
    runs = {"train": _train_runs, "collect": _collect_runs}.get(
        args.rollout, lambda: _runs(args.rollout, args.difficulty))()
    for label, run in runs:
        _profile(label, run, args.poses)


if __name__ == "__main__":
    main()
