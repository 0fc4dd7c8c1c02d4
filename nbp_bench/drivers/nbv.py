"""Closed-loop MACARONS greedy next-best-view rollouts
(``macarons_nbv_rollout``) at the configuration's token counts, one
client: rollouts of the mix's poses on its scenes in turn, over and over,
for the window.

The window runs whole cycles of the scenes, as many as come nearest to
``seconds``; a rollout's boundaries (its proxy field, buffers, first
capture and the final read-back) are inside it. Rollout k is drawn from
its own seed of the run's seed (the port's ``TorchDraws``), and the
models' weights are drawn on the device from the run's seed. Set-up
builds the scenes, draws the weights and runs a short rollout (every
shape of the pose).

``--trace 1`` profiles one more rollout after the window, of the mix's
``traced_poses`` poses, so that the timed rollouts' records (the
program's ``nbv`` run records) are read untraced.

Once the window has closed, the window's last rollout runs again,
untimed, up to the last pose the checks judge (its first poses are the
window's to the bit), with a provider of the same draws that keeps, at
poses drawn from the seed, SconeOcc's permutations, the proxy points it
queries and each candidate's Gumbel noise; forward hooks on the two
networks and wrappers of ``predict_coverage_gain`` and
``compute_view_harmonics`` keep the rest of what the reference is given
(``nbp_bench/checks_nbv.py``). Each candidate's valid flag comes from the
rollout's trajectory.
"""

from __future__ import annotations

import contextlib
import gc
import inspect
import math
import random
import sys
import time
from typing import Dict, List

import torch

from .. import arith, arith_scone, checks_nbv, common
from ..outcome import Outcome
from ..trace import Slice
from ..weights import draw_seed


def rollout_seed(seed: int, k: int) -> int:
    """The draws' seed of rollout k of a run (k = -1: the warm-up)."""
    return draw_seed(seed, 1000 + k)


def scone_models(cfg: Dict, seed: int, device):
    """SconeOcc and SconeVis at the configuration's widths, in eval mode
    on ``device``, every Dense drawn on the device from the seed, uniform
    in +-1/sqrt(fan_in), kernel and bias alike (PyTorch's default
    initialisation, the distribution of the port's ``seeded_scone``);
    LayerNorm as built (scale 1, bias 0)."""
    from nextbestpath_tpu_torch.models.scone import SconeOcc, SconeVis

    m = cfg["models"]
    models = (SconeOcc(**m["scone_occ"]), SconeVis(**m["scone_vis"]))
    gen = torch.Generator(device=device)
    gen.manual_seed(draw_seed(seed, 3))
    out = []
    for model in models:
        model = model.to(device).eval()
        with torch.no_grad():
            for lin in model.modules():
                if isinstance(lin, torch.nn.Linear):
                    scale = lin.weight.shape[1] ** -0.5
                    for p in (lin.weight, lin.bias):
                        u = torch.rand(p.shape, generator=gen, device=device)
                        p.copy_((u * 2.0 - 1.0) * scale)
        out.append(model)
    return tuple(out)


def _recorder_class():
    from nextbestpath_tpu_torch.draws import TorchDraws

    class Recorder(TorchDraws):
        """The port's provider (the same draws), keeping each pose's cloud
        count (the surface tokens' bound) and, at the checked poses,
        SconeOcc's permutations, the proxy points it queries and each
        candidate's Gumbel noise; a pose starts at its ``cov`` group."""

        def __init__(self, seed, device, poses):
            super().__init__(seed, device)
            self.poses = set(poses)
            self.pose = -1
            self.at: Dict[int, Dict] = {}
            self.counts: List[torch.Tensor] = []

        def here(self):
            if self.pose not in self.poses:
                return None
            return self.at.setdefault(self.pose, {"perms": []})

        def begin_group(self, role):
            if role == "cov":
                r = self.here()
                if r is not None:
                    # A pose whose gain went unrecorded keeps no noise.
                    r.pop("noise", None)
                self.pose += 1
            super().begin_group(role)

        def permutation(self, role, n, step=None):
            out = super().permutation(role, n, step)
            r = self.here()
            if r is not None and role == "occ":
                r["perms"].append(out.clone())
            return out

        def randint(self, role, low, high, step=None, shape=()):
            out = super().randint(role, low, high, step=step, shape=shape)
            if role == "tokens":
                self.counts.append(torch.as_tensor(high))
            r = self.here()
            if r is not None and role == "vs_idx":
                r["vs_idx"] = out.clone()
            return out

        def gumbels(self, role, shapes, step=None):
            out = super().gumbels(role, shapes, step)
            r = self.here()
            if r is not None and role == "gain":
                r["noise"] = out
            return out

    return Recorder


@contextlib.contextmanager
def recording(rec, occ_model, vis_model, geo: Dict, min_occ: float,
              control: bool):
    """What the checked poses' networks were given and gave, into
    ``rec.at[pose]``: forward hooks on SconeOcc (its tokens, queries and
    occupancies) and SconeVis (its tokens), and wrappers of
    ``predict_coverage_gain`` (the field as the gain read it, the
    candidates' poses, the gains) and ``compute_view_harmonics`` (the
    field's view states) as ``macarons_nbv`` calls them. Once a checked
    pose's gain has returned, its token draws are judged there
    (``checks_nbv.draw_reading``), while the noise is at hand."""
    from nextbestpath_tpu_torch.eval import macarons_nbv as nbv

    def on_occ(module, args, kwargs, out):
        r = rec.here()
        if r is not None:
            r.update(pc=args[0][0].clone(), x=args[1][0].clone(),
                     occ=out[0, :, 0].clone())

    def on_vis(module, args, kwargs, out):
        r = rec.here()
        if r is not None:
            r["tokens"] = args[0].clone()

    real = {"gain": nbv.predict_coverage_gain,
            "harmonics": nbv.compute_view_harmonics}
    sig = inspect.signature(real["gain"])

    def harmonics(view_state, *args, **kw):
        r = rec.here()
        if r is not None:
            vs = view_state.reshape(-1, view_state.shape[-1])
            if vs.shape[0] > r.get("view_states", vs[:0]).shape[0]:
                r["view_states"] = vs.clone()
        return real["harmonics"](view_state, *args, **kw)

    def gain(*args, **kw):
        g = real["gain"](*args, **kw)
        r = rec.here()
        if r is not None:
            a = sig.bind(*args, **kw).arguments
            r.update(proxy=a["proxy_points"].clone(),
                     proba=a["occ_probs"][:, 0].clone(),
                     pose5=a["candidate_pose5"].clone(),
                     box_min=a["box_min"].clone(),
                     box_max=a["box_max"].clone(), gains=g.clone())
            r.update(checks_nbv.draw_reading(
                r.pop("noise"), r.pop("tokens"), r["proxy"], r["proba"],
                r["pose5"], r["box_min"], r["box_max"], geo, min_occ,
                control))
        return g

    hooks = [occ_model.register_forward_hook(on_occ, with_kwargs=True),
             vis_model.register_forward_hook(on_vis, with_kwargs=True)]
    nbv.predict_coverage_gain = gain
    nbv.compute_view_harmonics = harmonics
    try:
        yield rec
    finally:
        for h in hooks:
            h.remove()
        nbv.predict_coverage_gain = real["gain"]
        nbv.compute_view_harmonics = real["harmonics"]


# What a checked pose has to have recorded.
RECORDED = ("perms", "vs_idx", "pc", "x", "occ", "view_states", "proxy",
            "proba", "pose5", "gains", "idx")


def _valid(pose5: torch.Tensor, cur) -> torch.Tensor:
    """The candidate slots that move: an invalid slot holds the current
    position ``cur``; where none moves, slot 0 (the rollout's turn in
    place)."""
    cur = torch.as_tensor(cur, dtype=torch.float64)
    away = (pose5[:, :3].double().cpu() - cur).norm(dim=1)
    valid = away > 1e-3 * (1.0 + float(cur.abs().max()))
    if not bool(valid.any()):
        valid[0] = True
    return valid


def _work(rec, assets, params, n_poses: int) -> Dict[str, float]:
    """A rollout's work for the sensor's and the coverage's rooflines:
    the bytes K1's frames need (the first capture's and each move's) and
    K3's operations on the (GT point, sample) pairs of each pose's
    coverage (its cloud count, capped at the sample's size)."""
    from nbp_bench.reference.coverage import n_sample_for

    frames = int(params.n_interpolation_steps) * (n_poses + 1)
    rays = int(params.image_height) * int(params.image_width)
    n_gt = len(assets.gt_surface)
    n_sample = n_sample_for(n_gt, int(params.full_pc_capacity))
    counts = torch.stack([c.reshape(()) for c in rec.counts]).cpu()
    pairs = float(counts.clamp(max=n_sample).double().sum()) * n_gt
    return {"k1_bytes": arith.k1_bytes(frames, rays, assets.n_tris),
            "k3_ops": arith.k3_ops(pairs)}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _last_record():
    """The program's latest run record if it is an ``nbv`` one."""
    from nextbestpath_tpu_torch.utils import timing

    recs = timing.records()
    return recs[-1] if recs and recs[-1].kind == "nbv" else None


def _same_prefix(a, b) -> bool:
    """Whether rollout b is the first poses of rollout a."""
    import numpy as np
    n = len(b.coverage_evolution)
    return (a.coverage_evolution[:n] == b.coverage_evolution
            and np.array_equal(a.cam_positions[:len(b.cam_positions)],
                               b.cam_positions))


def run(cell: common.Cell, seed: int, seconds: float, trace: bool,
        control: bool, device: str = "cuda") -> Outcome:
    from nextbestpath_tpu_torch.assets import (generate_scene,
                                               pack_generated_scene)
    from nextbestpath_tpu_torch.config import default_params
    from nextbestpath_tpu_torch.draws import TorchDraws
    from nextbestpath_tpu_torch.eval import macarons_nbv as nbv

    cfg, mix = cell.config, cell.mix
    dev = torch.device(device)
    # The configuration's f32: no TF32 in the program's products.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = default_params(**cfg["params"])
    assets = [pack_generated_scene(generate_scene(mix["level"], seed=s),
                                   params=params)
              for s in mix["scene_seeds"]]
    occ, vis = scone_models(cfg, seed, dev)
    tok = cfg["tokens"]
    n_poses, S = int(mix["poses"]), len(assets)

    def rollout(k: int, n: int, draws):
        return nbv.macarons_nbv_rollout(
            assets[k % S], occ, vis, params=params, n_poses=n,
            n_tokens=int(tok["surface"]),
            n_proxy_tokens=int(tok["proxy_queries"]),
            vis_tokens=int(tok["vis"]), draws=draws, device=dev)

    # Set-up: every shape of a pose, once.
    rollout(0, int(mix["warmup_poses"]), TorchDraws(rollout_seed(seed, -1),
                                                    dev))
    _sync(dev)
    setup_s = common.seconds_since_start()

    rollouts: List[Dict] = []
    failed = 0
    t0 = time.perf_counter()
    k = 0
    while True:
        ta = time.perf_counter()
        res = rollout(k, n_poses, TorchDraws(rollout_seed(seed, k), dev))
        tb = time.perf_counter()
        failed += sum(1 for c in res.coverage_evolution
                      if not math.isfinite(c))
        rollouts.append({"s": tb - ta, "poses": n_poses, "scene": k % S,
                         "record": _last_record()})
        k += 1
        # Whole cycles of the scenes, as many as come nearest to seconds.
        cycles = k / S
        if cycles == int(cycles) and \
                (tb - t0) * (1.0 + 0.5 / cycles) >= seconds:
            break
    window_s = time.perf_counter() - t0
    last = res
    poses = sum(r["poses"] for r in rollouts)
    work = arith_scone.pose_work(cfg, nbv.C_MAX)
    layer = {"window_s": window_s, "poses": poses, "rollouts": rollouts,
             **work}
    out = Outcome(attempted=poses, failed=failed,
                  e2e={"setup_s": setup_s, "poses_per_s": poses / window_s},
                  layer=layer, checks={}, memory_peak_bytes=0)

    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        n_traced = int(mix["traced_poses"])
        counting = _recorder_class()(rollout_seed(seed, k), dev, ())
        prof.start()
        ta = time.perf_counter()
        rollout(k, n_traced, counting)
        _sync(dev)
        tb = time.perf_counter()
        prof.stop()
        sl = Slice(prof, nbv.NBV_STAGES)
        layer.update(slice=sl, slice_s=tb - ta, traced_poses=n_traced,
                     events=prof.profiler.kineto_results.events(), prof=prof,
                     **_work(counting, assets[k % S], params, n_traced))
        out.busy_s = sl.busy_s()
        out.traced_s = tb - ta
        out.breakdown = {"device_ops": sl.top_ops(),
                         "idle_gaps": sl.idle_gaps()}
        print(f"# traced rollout of {n_traced} poses {tb - ta:.3f} s, its "
              f"trace read in {time.perf_counter() - tb:.3f} s",
              file=sys.stderr)
    if dev.type == "cuda":
        out.memory_peak_bytes = int(torch.cuda.max_memory_reserved(dev))

    # The checked rollout: the window's last again, untimed, recorded, up
    # to its last checked pose.
    k_last = k - 1
    check_at = random.Random(int(seed) * 31 + 7).sample(
        range(n_poses), int(mix["check_poses"]))
    rec = _recorder_class()(rollout_seed(seed, k_last), dev, check_at)
    geo = dict(H=int(params.image_height), W=int(params.image_width),
               fov_deg=float(params.fov_degrees),
               max_range=float(params.sensor_range))
    min_occ = float(params.get("min_occ_for_proxy_points", 0.1))
    tc = time.perf_counter()
    with recording(rec, occ, vis, geo, min_occ, control):
        checked = rollout(k_last, max(check_at) + 1, rec)
    print(f"# the checked rollout (poses {sorted(check_at)}) equals the "
          f"window's last: {_same_prefix(last, checked)}", file=sys.stderr)
    n_steps = int(params.n_interpolation_steps)
    for p in check_at:
        d = rec.at.get(p, {})
        missing = [key for key in RECORDED if key not in d]
        if missing:
            raise RuntimeError(
                f"the checked rollout recorded no {missing} at pose {p}: "
                "the check reads SconeOcc's and SconeVis's forward hooks, "
                "the provider's draws, and macarons_nbv's calls of "
                "predict_coverage_gain and compute_view_harmonics")
        d["valid"] = _valid(d["pose5"],
                            checked.cam_positions[n_steps * (p + 1) - 1])
    occ_sd = {n: t.detach() for n, t in occ.state_dict().items()}
    vis_sd = {n: t.detach() for n, t in vis.state_dict().items()}
    data = [rec.at[p] for p in sorted(check_at)]
    # The program's buffers are freed before the references run.
    del rec, checked, last, res
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    td = time.perf_counter()
    out.checks, out.control = checks_nbv.nbv(data, occ_sd, vis_sd, cfg,
                                             params, geo, control)
    print(f"# set-up {setup_s:.3f} s; the checked rollout and its draws "
          f"{td - tc:.3f} s, the references {time.perf_counter() - td:.3f} "
          f"s", file=sys.stderr)
    print(f"# {len(rollouts)} rollouts of {n_poses} poses in "
          f"{window_s:.3f} s: " + ", ".join(f"{r['s']:.3f} s"
                                            for r in rollouts),
          file=sys.stderr)
    return out
