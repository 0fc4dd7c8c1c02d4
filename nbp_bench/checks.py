"""The comparisons that decide ``correct``, each number with its limit
from the configuration's ``limits``.

Rollouts (the checked rollout, all its scenes):

* ``sensor_err_p99``: the sensor's frames (K1). For the initial capture
  and poses drawn from the seed, the reference renders every frame of the
  pose in f64 (the move's substeps) and counts the points each frame
  keeps (5% of its pixels with a hit nearer than the sensor range, at
  most ``points_per_frame``). Slots of the pose's points are drawn from
  the seed: a slot the program filled reads the point's distance from
  the plane of the triangle that the reference's ray through the point's
  pixel hits first, over the hit's depth, in the frame of the pose where
  that is least (along a grazing ray, a depth moves far for a small
  change of direction, the point barely leaves its surface); a slot that
  one side has and the other has not reads 1; a hit on the near plane to
  rounding may be read on either side of it. The number is the 99th
  percentile.
* ``coverage_gap``: coverage (K3). At poses drawn from the seed, the
  largest |program - reference| of the pose's coverage, the reference
  taken from the same cloud prefix and draws.

Training: see ``train``.
"""

from __future__ import annotations

import math
import random
import sys
from typing import Dict, Optional, Tuple

import torch

from .reference import coverage as rcov
from .reference import geometry as rgeo
from .reference import unet as runet

Checks = Dict[str, Tuple[float, float]]

# A hit this close to the near plane (relative to it) lies on the plane to
# rounding: f32 and f64 put it on different sides (a wall exactly
# ``camera_znear`` from a lattice pose), and either reading is sound.
NEAR_BAND = 1e-4


def _scene(s: Dict, dev) -> Dict:
    tris = torch.as_tensor(s["tris"], dtype=torch.float32, device=dev)
    return {"tris": tris,
            "gt": torch.as_tensor(s["gt"], dtype=torch.float32, device=dev),
            "positions": rgeo.lattice_positions(s["origin"], s["L"], s["H"],
                                                dev),
            "azims": torch.as_tensor(s["azims"], dtype=torch.float32,
                                     device=dev),
            "elev": s["elev"], "A": s["A"]}


def _frames(sc: Dict, cur_k, cur_next, n_steps: int):
    """The poses (n_steps, 5) of the frames a move renders."""
    p0, p1 = (rgeo.poses5(sc["positions"], sc["elev"], sc["azims"],
                          c.reshape(1, 3).to(sc["positions"].device))[0]
              for c in (cur_k, cur_next))
    return rgeo.interpolate_move(p0, p1, n_steps, sc["A"])


def _n_keep(n_valid: int, share: float, n_slots: int) -> int:
    prod = torch.tensor(float(n_valid), dtype=torch.float32) * torch.tensor(
        share, dtype=torch.float32)
    return min(int(prod), n_slots)


def _sensor(sc, frames, pts, lo: int, params, rng, n_slots: int,
            capacity: int, dtype):
    """Errors of the sampled slots of one pose's points: a point's
    distance from the plane of the triangle that the reference's ray
    through its pixel hits first, at that hit, over the hit's depth (the
    least over the frames of the pose); 1 for a slot that one side has
    and the other has not. Where a frame's nearest hit lies within
    ``NEAR_BAND`` of the near plane, the pixel has two sound readings
    (that hit, or the next beyond the plane): a point reads the lesser
    error, and the points a frame keeps may be counted either way.
    ``dtype`` bf16: the control, whose own points at the program's pixels
    are judged instead."""
    H, W = int(params.image_height), int(params.image_width)
    fov = float(params.fov_degrees)
    zn, zf = float(params.camera_znear), float(params.zfar)
    rng_s = float(params.sensor_range)
    share = float(params.gathering_factor)
    eye, axes = rgeo.camera_axes(frames)
    dirs = rgeo.pixel_dirs(axes, H, W, fov)
    normals = rgeo.unit_normals(sc["tris"])
    n_f = frames.shape[0]
    # Two readings: the near plane just beyond the band and just inside.
    readings = [[rgeo.render(sc["tris"], eye[f], dirs[f], z0, zf)
                 for f in range(n_f)]
                for z0 in (zn * (1.0 + NEAR_BAND), zn * (1.0 - NEAR_BAND))]

    def kept(depths):
        return sum(_n_keep(int(((d > 0) & (d < rng_s)).sum()), share,
                           n_slots) for d in depths)

    n_prog = pts.shape[0]
    if dtype == torch.float64:
        judged = None
        n_exp = min(max(n_prog, kept([r[0] for r in readings[0]])),
                    kept([r[0] for r in readings[1]]))
    else:
        judged = [rgeo.render(sc["tris"], eye[f].to(dtype),
                              dirs[f].to(dtype), zn, zf,
                              dtype=dtype)[0].to(torch.float64)
                  for f in range(n_f)]
        n_exp = kept(judged)
    n_exp = min(n_exp, capacity - lo)
    n_both = min(n_exp, n_prog)
    slots = torch.tensor(rng.sample(range(max(n_exp, n_prog)),
                                    min(2048, max(n_exp, n_prog))),
                         dtype=torch.int64)
    errs = torch.ones(slots.shape[0], dtype=torch.float64)
    inner = slots < n_both
    if bool(inner.any()):
        p = pts[slots[inner].to(pts.device)].to(torch.float64)
        best = torch.full((p.shape[0],), 1.0, dtype=torch.float64,
                          device=p.device)
        for f in range(n_f):
            ij, inside = rgeo.project(p, eye[f], axes[f], H, W, fov)
            pix = ij[:, 0] * W + ij[:, 1]
            ray = dirs[f][pix]
            for ref in readings:
                d_ref, tri = ref[f][0][pix], ref[f][1][pix]
                d_jdg = d_ref if judged is None else judged[f][pix]
                q_ref = eye[f] + d_ref[:, None] * ray
                q = p if judged is None else eye[f] + d_jdg[:, None] * ray
                err = ((q - q_ref) * normals[tri]).sum(1).abs() / \
                    d_ref.clamp(min=1e-9)
                err = torch.where(inside & (d_ref > 0) & (d_jdg > 0), err,
                                  torch.ones_like(err))
                best = torch.minimum(best, err)
        errs[inner] = best.cpu()
    return errs, n_exp, n_prog


def rollouts(data: Dict, cfg: Dict, mix: Dict, seed: int, dev,
             control: bool) -> Tuple[Checks, Optional[Dict[str, float]]]:
    lim = cfg["limits"]
    params = data["params"]
    rng = random.Random(int(seed) * 31 + 7)
    n_poses = data["n_poses"]
    scenes = [_scene(s, dev) for s in data["scenes"]]
    B = len(scenes)
    n_steps = int(params.n_interpolation_steps)
    n_slots = int(params.points_per_frame)
    cap = int(params.full_pc_capacity)
    cur, cnt = data["cur_log"], data["cnt_log"]
    vals: Dict[str, float] = {}
    ctrl: Dict[str, float] = {}

    # The sensor: the initial capture and poses drawn from the seed.
    poses = [-1] + rng.sample(range(n_poses), int(mix["check_sensor_poses"]))
    errs, errs_c, seen = [], [], []
    for k in poses:
        for b, sc in enumerate(scenes):
            if k < 0:
                frames = _frames(sc, cur[0, b], cur[0, b], n_steps)
                lo, hi = 0, int(cnt[0, b])
            else:
                frames = _frames(sc, cur[k, b], cur[k + 1, b], n_steps)
                lo, hi = int(cnt[k, b]), int(cnt[k + 1, b])
            pts = data["pc"][b, lo:hi].to(dev)
            state = rng.getstate()
            e, n_exp, n_prog = _sensor(sc, frames, pts, lo, params, rng,
                                       n_slots, cap, torch.float64)
            errs.append(e)
            seen.append((k, b, n_exp, n_prog,
                         cur[max(k, 0), b].tolist(), cur[k + 1, b].tolist()))
            if control:
                rng.setstate(state)
                errs_c.append(_sensor(sc, frames, pts, lo, params, rng,
                                      n_slots, cap, torch.bfloat16)[0])
    vals["sensor_err_p99"] = float(torch.quantile(torch.cat(errs), 0.99))
    lim_s = float(lim["sensor_err_p99"])
    if vals["sensor_err_p99"] > lim_s:
        # Where the sensor's reading fails: each pose and scene judged.
        for e, (k, b, n_exp, n_prog, a, z) in zip(errs, seen):
            at_1 = float((e >= 1).double().mean())
            over = float((e > lim_s).double().mean())
            print(f"# sensor pose {k} scene {b} ({a} to {z}): points "
                  f"{n_prog} (reference {n_exp}), slots at 1 {at_1!r}, "
                  f"over the limit {over!r}", file=sys.stderr)
    if control:
        ctrl["sensor_err_p99"] = float(torch.quantile(torch.cat(errs_c),
                                                      0.99))

    # Coverage at poses drawn from the seed, every scene.
    g_pad = max(s["gt"].shape[0] for s in scenes)
    n_sample = rcov.n_sample_for(g_pad, cap)
    gaps, gaps_c = [], []
    clouds = [data["pc"][b].to(dev) for b in range(B)]
    for k in rng.sample(range(n_poses), int(mix["check_coverage_poses"])):
        for b, sc in enumerate(scenes):
            c, start, half = (int(v) for v in data["cov_draws"][k, b])
            cloud = clouds[b]
            valid = torch.ones(sc["gt"].shape[0], dtype=torch.bool,
                               device=dev)
            prog = float(data["coverage"][b, k])
            gaps.append(abs(prog - rcov.coverage(sc["gt"], valid, cloud, c,
                                                 start, half, n_sample)))
            if control:
                gaps_c.append(abs(rcov.coverage(
                    sc["gt"], valid, cloud, c, start, half, n_sample,
                    dtype=torch.float64) - rcov.coverage(
                    sc["gt"], valid, cloud, c, start, half, n_sample,
                    dtype=torch.bfloat16)))
    vals["coverage_gap"] = max(gaps)
    if control:
        ctrl["coverage_gap"] = max(gaps_c)

    checks = {k: (v, float(lim[k])) for k, v in vals.items()}
    return checks, (ctrl if control else None)


def _rel(a: torch.Tensor, r: torch.Tensor) -> float:
    """Relative RMS error of a against r."""
    return float(torch.linalg.norm((a - r).double())
                 / torch.linalg.norm(r.double()))


def _logit_rel(a: torch.Tensor, r: torch.Tensor) -> float:
    """Relative RMS error of the logits of probabilities a against r's,
    over the entries that neither side rounds to 0 or past 0.99 (a bf16
    sigmoid reads 1 from a logit of about 5.5 on)."""
    a, r = a.double(), r.double()
    ok = (a > 0) & (r > 0) & (a < 0.99) & (r < 0.99)
    la = torch.log(a[ok] / (1 - a[ok]))
    lr = torch.log(r[ok] / (1 - r[ok]))
    return float(torch.linalg.norm(la - lr) / torch.linalg.norm(lr))


def correct(checks: Checks) -> bool:
    return all(math.isfinite(v) and v <= lim for v, lim in checks.values())


def stand_in_verdicts(checks: Checks, control: Dict[str, float]
                      ) -> Dict[str, bool]:
    """``correct`` as it reads with each stand-in in the program's place:
    the control (its readings under the numbers' own names) and each
    planted fault (under ``<fault>.<number>``), against the same limits.
    A number a stand-in gives no reading of is left out for it."""
    names = {"control": ""}
    names.update({k.split(".", 1)[0]: k.split(".", 1)[0] + "."
                  for k in control if "." in k})
    return {who: correct({k: (control[pre + k], lim)
                          for k, (_, lim) in checks.items()
                          if pre + k in control})
            for who, pre in names.items()}


def train(seen, prog_losses, first_maps, first_grad, change, init_sd,
          names, ds, cfg: Dict, mix: Dict, dev, control: bool
          ) -> Tuple[Checks, Optional[Dict[str, float]]]:
    """The first three optimizer steps against the f32 reference trainer
    on the same rows from the same weights:

    * ``train_value_map_err``: the first micro step's value map (train
      mode) against the reference's, relative RMS;
    * ``grad_gap``: the gradient the first AdamW step got (from its first
      moment), by leaf: |program's norm - reference's| over the larger of
      the leaf's and the median leaf's reference norm, the median over
      the leaves;
    * ``update_gap``: the parameters' change after the three steps, by
      leaf likewise, the median over the leaves.

    Leaves whose reference gradient is under a thousandth of the median
    leaf's are left out of both (a convolution's bias before a train-mode
    BatchNorm: the loss does not depend on it, and AdamW moves it by
    round-off alone). The worst leaf's readings go to stderr, with the
    first micro step's obstacle map (its logits' relative RMS error) and
    the relative gap of the first optimizer step's loss (the mean of its
    micro steps') and of the worst micro step's of the three, which are
    not compared: their readings (sound runs, the control and the faults)
    overlap.

    With ``control``, the same numbers of the fp8 reference (the control)
    and of the reference with half of each micro batch left out (its loss
    the mean over the rest: a fault)."""
    from .reference.train import Trainer, leaf_gaps, leaf_norms

    lim = cfg["limits"]
    opt = cfg["optimizer"]
    every_k = int(mix["accumulate"])
    out_dtype = getattr(torch, cfg["model"]["dtype"])
    idx0, sw0, _ = seen[0]
    x0 = ds["x"][idx0].to(torch.float32)

    def follow(quant=None, half=False):
        init = {k: v.to(dev) for k, v in init_sd.items()}
        tr = Trainer(init, names, every_k=every_k, lr=float(opt["lr"]),
                     wd=float(opt["weight_decay"]), quant=quant,
                     out_dtype=out_dtype)
        with torch.no_grad(), runet.full_f32():
            maps = runet.Net(init, train=True, quant=quant,
                             out_dtype=out_dtype)(x0)
        losses, g1 = [], None
        for i, (idx, sw, _) in enumerate(seen):
            if half:
                sw = sw.clone()
                sw[sw.shape[0] // 2:] = 0.0
            losses.append(tr.micro(ds, idx, sw))
            if i == every_k - 1:
                g1 = leaf_norms(tr.first_grads()).cpu()
        moved = leaf_norms([tr.sd[n] - init[n] for n in names]).cpu()
        return maps, losses, g1, moved

    ref_m, ref_l, ref_g, ref_c = follow()
    keep = ref_g >= 1e-3 * ref_g.median()

    def gaps(maps, losses, g1, moved, who):
        parts = (_rel(maps[0], ref_m[0]), _logit_rel(maps[1], ref_m[1]))
        out = {"train_value_map_err": parts[0]}
        first = sum(losses[:every_k]) / every_k
        ref = sum(ref_l[:every_k]) / every_k
        worst = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_l))
        print(f"# {who} train_value_map_err {parts[0]!r}; not compared: "
              f"the obstacle map's logits {parts[1]!r}, the loss's first step "
              f"{abs(first - ref) / abs(ref)!r}, worst micro step {worst!r}",
              file=sys.stderr)
        for name, prog, ref in (("grad_gap", g1, ref_g),
                                ("update_gap", moved, ref_c)):
            g = leaf_gaps(prog, ref)[keep]
            out[name] = float(g.median())
            i = int(torch.nonzero(keep)[int(g.argmax())])
            print(f"# {who} {name}: median leaf {out[name]!r}; worst leaf "
                  f"{names[i]} {float(g.max())!r} (program {float(prog[i])!r}"
                  f", reference {float(ref[i])!r})", file=sys.stderr)
        return out

    vals = gaps(first_maps, prog_losses, first_grad, change, "program")
    checks = {k: (v, float(lim[k])) for k, v in vals.items()}
    if not control:
        return checks, None
    ctrl = gaps(*follow(quant="fp8"), "control")
    ctrl.update({f"half_batch.{k}": v for k, v in
                 gaps(*follow(half=True), "half_batch").items()})
    ctrl["left_out_leaves"] = float((~keep).sum())
    return checks, ctrl
