#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nextbestpath_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. the device, and the card's name and power limit from nvidia-smi;
2. the build: one nvcc call compiles csrc/*.cu into one library;
3. each kernel (K1 pinhole ray cast, K2 general ray cast, K3 running-min
   distance) against its plain PyTorch version on the card, bit for bit,
   at the shapes the planning rollout gives it (K1 at one frame and at a
   move's four frames in one launch; K3 at full, partial and zero counts),
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
   then the move's four frames in one launch), K3 once a pose, and coverage
   must rise;
5. a reference check: a small rollout on the card against the same rollout
   on the CPU (plain versions), with the same draws and weights.

The line before the last lists the kernels as JSON; the last line is the
device JSON. Imports nothing of JAX and reads nothing that git ignores.
"""

from __future__ import annotations

import json
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
# needs: K1 three 3-term dots, the three sign and range compares of det, u
# and v, the add u + v and its compare; K2 two cross products, four dots, the
# origin difference and the compares; K3 three differences, three squares,
# two adds and a min. The divisions of the few pairs that pass are left out.
OPS_K1, OPS_K2, OPS_K3 = 20, 50, 9

TOL_COVERAGE = 1e-3    # small rollout: card vs CPU coverage curve


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / PEAK_F32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ceiling_ms(n_ops: float) -> float:
    return n_ops / NO_FMA_OPS * 1e3


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


def main() -> int:
    # The smoke runs on one card: expose only the first visible one.
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
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
    from nextbestpath_tpu_torch.geometry.cameras import (CameraIntrinsics,
                                                         get_camera_RT)
    from nextbestpath_tpu_torch.models.unet import configure_f32
    from nextbestpath_tpu_torch.ops.coverage import min_sq_dists_plain
    from nextbestpath_tpu_torch.ops.raytrace import (frame_rays, pinhole_tri_soa,
                                                     ray_hits_pinhole_plain,
                                                     ray_hits_plain, tris_to_soa)
    from nextbestpath_tpu_torch.planning.grid_paths import DIRS, lattice_positions

    # 1. Device.
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"device: {kind} (count {torch.cuda.device_count()}), torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)
    configure_f32()

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

    L, H = assets.pose_l, assets.pose_h
    positions = lattice_positions(torch.from_numpy(assets.pose_origin).to(dev), L, H)
    flat = positions.reshape(-1, 3)
    axes = torch.tensor([[3e-4, 1.0, 7e-4], [1.0, 3e-4, 7e-4], [7e-4, 3e-4, 1.0]],
                        device=dev)
    o_in = flat.repeat(3, 1).contiguous()
    d_in = axes.repeat_interleave(flat.shape[0], dim=0).contiguous()
    got = kernels.ray_hits(o_in, d_in, soa, n_tris, 1e-6, 3.4e38)
    want = ray_hits_plain(o_in, d_in, soa, n_tris, 1e-6, 3.4e38)
    err = compare_hits("K2 ray_hits (inside test)", got, want, o_in.shape[0])
    for dl, dh in DIRS:
        step = torch.tensor([3.0 * dl, 0.0, 3.0 * dh], device=dev)
        d_e = ((positions + step).reshape(-1, 3) - flat).contiguous()
        e = compare_hits(f"K2 ray_hits (edges {dl},{dh})",
                         kernels.ray_hits(flat.contiguous(), d_e, soa, n_tris, 1e-6, 1.0),
                         ray_hits_plain(flat, d_e, soa, n_tris, 1e-6, 1.0),
                         flat.shape[0])
        err = max(err, e)
    n = o_in.shape[0]
    b, by = bound_ms(n * 24 + soa.numel() * 4 + n * 12, n * nt * OPS_K2)
    rows.append(dict(
        name="ray_hits", route="cuda",
        source="nextbestpath_tpu_torch/csrc/raytrace.cu",
        replaces="nextbestpath_tpu/ops/raytrace.py:127",
        max_abs_err=err,
        ms=kernels.device_ms(lambda: kernels.ray_hits(o_in, d_in, soa, n_tris, 1e-6, 3.4e38), 50),
        plain_ms=kernels.device_ms(lambda: ray_hits_plain(o_in, d_in, soa, n_tris, 1e-6, 3.4e38), 5),
        bound_ms=b, bound_by=by, ceiling_ms=ceiling_ms(n * nt * OPS_K2),
        library_ms=None, shape=f"{n} rays x {nt} tris"))

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
    k1_row, k3_row = rows[0], rows[2]
    log(f"  ray_hits_pinhole: {k1_row['ms_per_frame']:.4f} ms a frame in the "
        f"{n_steps}-frame launch; one frame alone {k1_row['b1_ms']:.4f} ms (plain "
        f"{k1_row['b1_plain_ms']:.3f} ms, bound {k1_row['b1_bound_ms']:.4f} ms, "
        f"ceiling {k1_row['b1_ceiling_ms']:.4f} ms)")
    log(f"  min_sq_dists: {k3_row['partial_ms']:.4f} ms at {n_part} valid samples "
        f"(ceiling {k3_row['partial_ceiling_ms']:.4f} ms)")

    # 4. The main path: the planning rollout at full width.
    warm = NBPPlanningRollout(assets, model, params=params, seed=MAIN_PATH_SEED,
                              device=dev)
    warm.run(n_poses=MAIN_PATH_WARMUP_POSES)
    del warm
    n_poses = 6
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    roll = NBPPlanningRollout(assets, model, params=params, seed=MAIN_PATH_SEED,
                              device=dev)
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
    if not all(c == c and 0.0 <= c <= 1.0 for c in cov) or not max(cov[1:]) > cov[0]:
        raise AssertionError(f"coverage does not rise: {cov}")
    for name, k in launches.items():
        if k <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    want_launches = {"ray_hits_pinhole": 1 + 2 * n_poses, "min_sq_dists": n_poses}
    for name, k in want_launches.items():
        if launches[name] != k:
            raise AssertionError(f"kernel {name} launched {launches[name]} times on "
                                 f"the main path, expected {k}")
    for r, key in zip(rows, ("ray_hits_pinhole", "ray_hits", "min_sq_dists")):
        r["launches"] = launches[key]

    # 5. Reference check: a small rollout on the card and on the CPU.
    small = default_params(image_height=32, image_width=56, points_per_frame=256,
                           full_pc_capacity=65536, n_gt_surface_points=2048,
                           max_path_len=32, pc2img_size=[64, 64],
                           value_map_size=[16, 16])
    s_assets = pack_generated_scene(generate_scene("simple", seed=4), params=small)
    results = {}
    for d in ("cuda", "cpu"):
        m = seeded_nbp()
        r = NBPPlanningRollout(s_assets, m, params=small, device=d,
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

    log(smi)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "ceiling_ms", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
