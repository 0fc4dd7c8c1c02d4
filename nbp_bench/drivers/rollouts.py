"""Closed-loop evaluation rollouts of the random walk
(``ScanRandomWalk``) over the mix's scenes, 101-pose rollouts back to
back for the window.

The window runs whole cycles of the mix's pool of rollouts through the
program's ``run``, as many as come nearest to ``seconds``: a rollout's
boundaries (its results read, the next one's reset and first capture)
are inside it, and every seed does the same work. The rollout is built
with the harness's draws provider (the port's ``TorchDraws`` at the
pool's seeds, passed as ``make_draws``); nothing else of the program is
changed. In a traced run the provider also keeps each pose's coverage
draws, the tensors the program made, among them the cloud count K3 is
given.

Once the window has closed, the same object runs the window's last
rollout again, untimed, with a provider that also logs each pose's
lattice index and cloud count as the pose starts. Its results are
compared with the window's last rollout's (printed), and the checks
(``nbp_bench/checks.py``) judge it against the plain references.
"""

from __future__ import annotations

import gc
import math
import sys
import time
from typing import Dict, List

import torch

from .. import arith, checks, common, traffic
from ..outcome import Outcome
from ..trace import Slice


def _provider_class():
    from nextbestpath_tpu_torch.draws import TorchDraws

    class Draws(TorchDraws):
        """The port's provider for batch position ``b``, keeping each
        pose's coverage draws [count bound, start, stride half]; with a
        ``log``, each pose's start goes to it too."""

        def __init__(self, s, device, b, log):
            super().__init__(s, device)
            self.b, self.log = b, log
            self.cov: List[List[torch.Tensor]] = []

        def begin_pose(self):
            if self.log is not None:
                self.log.begin_pose(self.b)
            super().begin_pose()

        def randint(self, role, low, high, step=None, shape=()):
            out = super().randint(role, low, high, step, shape)
            if role == "cov":
                if step is None:
                    self.cov.append([high, out])
                else:
                    self.cov[-1].append(out)
            return out

    return Draws


class Source:
    """``make_draws`` for the program: batch position b of a rollout of
    the pool gets the draws of the scene there (its index in the mix) in
    that rollout, wherever the seed put it."""

    def __init__(self, device, scene_ids: List[int], keep: bool):
        from nextbestpath_tpu_torch.draws import TorchDraws

        self.plain, self.cls = TorchDraws, _provider_class()
        self.device, self.scene_ids, self.keep = device, scene_ids, keep
        self.start(traffic.WARMUP)

    def start(self, pool_k: int, log=None) -> None:
        self.pool_k, self.log = pool_k, log
        self.draws: List = []

    def __call__(self, s: int):
        b = s - traffic.rollout_seed(self.pool_k)
        seed = traffic.draw_seed(self.pool_k, self.scene_ids[b])
        if not self.keep and self.log is None:
            return self.plain(seed, self.device)
        d = self.cls(seed, self.device, b, self.log)
        self.draws.append(d)
        return d


class CheckLog:
    """Each pose's lattice index and cloud count as the pose starts, and
    after the last pose, of the checked rollout."""

    def __init__(self, roll, n_poses: int):
        self.roll = roll
        B, dev = roll.n_scenes, roll.device
        self.cur_log = torch.zeros((n_poses + 1, B, 3), dtype=torch.int64,
                                   device=dev)
        self.cnt_log = torch.zeros((n_poses + 1, B), dtype=torch.int32,
                                   device=dev)
        self.pose = [0] * B

    def begin_pose(self, b: int) -> None:
        self.cur_log[self.pose[b], b].copy_(self.roll.cur[b])
        self.cnt_log[self.pose[b], b].copy_(self.roll.pcs[b].count)
        self.pose[b] += 1

    def end(self) -> None:
        for b in range(self.roll.n_scenes):
            self.begin_pose(b)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _same(a, b) -> bool:
    import numpy as np
    return all(x.coverage_evolution == y.coverage_evolution
               and x.n_points == y.n_points
               and np.array_equal(x.cam_positions, y.cam_positions)
               for x, y in zip(a, b))


def run(cell: common.Cell, seed: int, seconds: float, trace: bool,
        control: bool, device: str = "cuda") -> Outcome:
    from nextbestpath_tpu_torch.config import default_params
    from nextbestpath_tpu_torch.eval.random_walk import ScanRandomWalk

    cfg, mix = cell.config, cell.mix
    dev = torch.device(device)
    params = default_params(**cfg["params"])
    assets = traffic.scene_assets(mix, seed, params)
    n_poses = int(mix["poses"])
    source = Source(dev, traffic.scene_order(mix, seed), keep=trace)
    roll = ScanRandomWalk(assets, params=params, make_draws=source,
                          device=dev)
    B = roll.n_scenes

    # Set-up: the capture of the graph and a short rollout through it.
    roll.run(n_poses=int(mix["warmup_poses"]),
             seed=traffic.rollout_seed(traffic.WARMUP))
    _sync(dev)
    setup_s = common.seconds_since_start()

    prof = None
    rollouts = []
    order = traffic.pool_order(mix, seed)
    t0 = time.perf_counter()
    k = 0
    failed = 0
    results = None
    while True:
        profiled = trace and k == 1
        if profiled:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()
        pool_k = order[k % len(order)]
        source.start(pool_k)
        ta = time.perf_counter()
        results = roll.run(n_poses=n_poses,
                           seed=traffic.rollout_seed(pool_k))
        tb = time.perf_counter()
        if profiled:
            _sync(dev)
            tb = time.perf_counter()
            prof.stop()
        failed += sum(1 for r in results for c in r.coverage_evolution
                      if not math.isfinite(c))
        rollouts.append({"s": tb - ta, "poses": B * n_poses,
                         "profiled": profiled})
        if trace:
            # The kernels' work, read once the rollout has ended.
            rollouts[-1].update(_work(source, assets, params, n_poses))
        k += 1
        # Whole cycles of the pool, as many as come nearest to seconds.
        cycles = k / len(order)
        elapsed = tb - t0
        if cycles == int(cycles) and (k >= 2 or not trace) and \
                elapsed * (1.0 + 0.5 / cycles) >= seconds:
            break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_reserved(dev) if dev.type == "cuda" else 0

    scene_poses = sum(r["poses"] for r in rollouts)
    layer = {"window_s": window_s, "rollouts": rollouts,
             "scene_poses": scene_poses}
    out = Outcome(attempted=scene_poses, failed=failed,
                  e2e={"setup_s": setup_s,
                       "poses_per_s": scene_poses / window_s},
                  layer=layer, checks={}, memory_peak_bytes=int(peak))
    if prof is not None:
        sl = Slice(prof, ("pose",))
        layer["slice"] = sl
        out.busy_s = sl.busy_s()
        layer["slice_s"] = out.traced_s = rollouts[1]["s"]
        out.breakdown = {"device_ops": sl.top_ops(), "idle_gaps":
                         sl.idle_gaps()}
        del prof

    # The checked rollout: the window's last again, untimed, logged.
    log = CheckLog(roll, n_poses)
    source.start(pool_k, log)
    checked = roll.run(n_poses=n_poses, seed=traffic.rollout_seed(pool_k))
    log.end()
    print(f"# the checked rollout equals the window's last: "
          f"{_same(results, checked)}", file=sys.stderr)
    data = _collect(log, source, roll, assets, checked, params, n_poses)
    # The program is freed before the references run.
    del roll, log, source
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out.checks, out.control = checks.rollouts(data, cfg, mix, seed, dev,
                                              control)
    print(f"# {len(rollouts)} rollouts of {B} scenes x {n_poses} poses in "
          f"{window_s:.3f} s: " + ", ".join(f"{r['s']:.3f} s"
                                            for r in rollouts),
          file=sys.stderr)
    return out


def _work(source: Source, assets, params, n_poses: int) -> Dict:
    """A rollout's work for the kernels' rooflines: the bytes K1's frames
    need and K3's operations on the (GT point, sample) pairs of the
    counts its launches were given (each pose's cloud count, as the
    coverage draws' bound has it)."""
    from nbp_bench.reference.coverage import n_sample_for

    n_steps = int(params.n_interpolation_steps)
    frames = n_steps * (n_poses + 1)
    rays = int(params.image_height) * int(params.image_width)
    k1 = sum(arith.k1_bytes(frames, rays, a.n_tris) for a in assets)
    g_pad = max(len(a.gt_surface) for a in assets)
    n_sample = n_sample_for(g_pad, int(params.full_pc_capacity))
    counts = torch.stack([torch.stack([p[0].reshape(()) for p in d.cov])
                          for d in source.draws], 1).to("cpu")
    counts = counts.clamp(max=n_sample).double()
    g = torch.tensor([float(len(a.gt_surface)) for a in assets],
                     dtype=torch.float64)
    return {"k1_bytes": k1,
            "k3_ops": arith.k3_ops(float((counts * g[None]).sum()))}


def _collect(log: CheckLog, source: Source, roll, assets, results, params,
             n_poses: int) -> Dict:
    """What the comparison reads, on the host: the scenes' raw inputs, the
    checked rollout's cloud, logs, draws and coverage."""
    cov_draws = torch.stack([torch.stack([torch.stack([t.reshape(()).long()
                                                       for t in pose])
                                          for pose in d.cov])
                             for d in source.draws], 1)
    return {
        "scenes": [{"tris": a.tris[:a.n_tris], "gt": a.gt_surface,
                    "origin": a.pose_origin, "L": a.pose_l, "H": a.pose_h,
                    "A": a.n_azim, "elev": float(a.elevations_deg[2]),
                    "azims": a.azimuths_deg, "name": a.name}
                   for a in assets],
        "params": params,
        "n_poses": n_poses,
        "pc": torch.stack([p.points for p in roll.pcs]).to("cpu"),
        "cur_log": log.cur_log.to("cpu"), "cnt_log": log.cnt_log.to("cpu"),
        "cov_draws": cov_draws.to("cpu"),
        "coverage": torch.tensor([r.coverage_evolution for r in results],
                                 dtype=torch.float64),
    }
