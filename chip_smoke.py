#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nextbestpath_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. the device, and the card's name and power limit from nvidia-smi;
2. the build: one nvcc call compiles csrc/*.cu into one library;
3. each kernel (K1 pinhole ray cast, K2 general ray cast, K3 running-min
   distance) against its plain PyTorch version on the card, at the shapes
   the planning rollout gives it, with its time, its plain version's time,
   a library call's time where one computes the same function, and the
   least time the card could take for the same work;
4. the main path (``eval.nbp_planning.main_path_setup``): the NBP planning
   rollout on the ``simple`` scene (seed 8) with the default config (256x456
   frames, 6144 points a frame, 2M point capacity, 20000 GT points) and a
   full-width NBP U-Net in f32 with random weights from a seed. Launch counts
   are set to 0 just before it and read just after; every kernel must have
   run, and coverage must rise;
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

# Peak rates of one H100 SXM at its full 700 W (NVIDIA data sheet).
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# Operations per (ray, triangle) or (GT, sample) pair, as the kernels count
# them: K1 three 3-term dots, negations, |det| and four compares; K2 two
# cross products, four dots, the origin difference and the compares; K3
# three differences, three squares, two adds and a min.
OPS_K1, OPS_K2, OPS_K3 = 25, 50, 9

TOL_T_REL = 1e-6       # hit distances: kernel vs plain, relative
TOL_GRAZING = 1e-4     # share of rays whose integers may differ (grazing)
TOL_COVERAGE = 1e-3    # small rollout: card vs CPU coverage curve


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / PEAK_F32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def compare_hits(name, got, want, n_rays):
    """Integers equal apart from a grazing allowance; t within TOL_T_REL."""
    import torch
    t_k, c_k, i_k = got
    t_p, c_p, i_p = want
    hit_k, hit_p = t_k < 3.4e38, t_p < 3.4e38
    both = hit_k & hit_p
    err = float((t_k[both] - t_p[both]).abs().max()) if bool(both.any()) else 0.0
    rel = float(((t_k[both] - t_p[both]).abs()
                 / t_p[both].abs().clamp(min=1e-30)).max()) if bool(both.any()) else 0.0
    mism = {"hit": int((hit_k != hit_p).sum()), "count": int((c_k != c_p).sum()),
            "index": int((i_k != i_p).sum())}
    log(f"{name}: rays {n_rays} hits {int(hit_p.sum())} max_abs_err(t) {err:.3e} "
        f"max_rel_err(t) {rel:.3e} mismatches {mism}")
    allowed = TOL_GRAZING * n_rays
    if max(mism.values()) > allowed or rel > TOL_T_REL:
        raise AssertionError(f"{name} disagrees with its plain version: {mism}, "
                             f"rel err {rel} (allowed {allowed:.1f} rays, "
                             f"rel {TOL_T_REL})")
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
        main_path_setup, seeded_nbp)
    from nextbestpath_tpu_torch.geometry.cameras import (CameraIntrinsics, _mat3,
                                                         camera_center,
                                                         get_camera_RT)
    from nextbestpath_tpu_torch.models.unet import configure_f32
    from nextbestpath_tpu_torch.ops.coverage import min_sq_dists_plain
    from nextbestpath_tpu_torch.ops.raytrace import (pinhole_tri_soa,
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
    s = assets.start_cam_idx
    pos = assets.pose_from_idx(s)
    R, T = get_camera_RT(torch.tensor(pos[None, :3], device=dev),
                         torch.tensor(pos[None, 3:], device=dev))
    eye = camera_center(R[0], T[0])
    dirs = _mat3(intr.pixel_ray_dirs_view(dev).reshape(-1, 3), R[0].T).contiguous()
    ph = pinhole_tri_soa(soa, eye)
    zn, zf = float(intr.znear), float(intr.zfar)
    got = kernels.ray_hits_pinhole(dirs, ph, n_tris, zn, zf)
    want = ray_hits_pinhole_plain(dirs, ph, n_tris, zn, zf)
    err = compare_hits("K1 ray_hits_pinhole", got, want, dirs.shape[0])
    n = dirs.shape[0]
    b, by = bound_ms(n * 12 + ph.numel() * 4 + n * 12, n * nt * OPS_K1)
    rows.append(dict(
        name="ray_hits_pinhole", route="cuda",
        source="nextbestpath_tpu_torch/csrc/raytrace.cu",
        replaces="nextbestpath_tpu/ops/raytrace.py:234",
        max_abs_err=err,
        ms=time_ms(lambda: kernels.ray_hits_pinhole(dirs, ph, n_tris, zn, zf), 50),
        plain_ms=time_ms(lambda: ray_hits_pinhole_plain(dirs, ph, n_tris, zn, zf), 5),
        bound_ms=b, bound_by=by, library_ms=None, shape=f"{n} rays x {nt} tris"))

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
        ms=time_ms(lambda: kernels.ray_hits(o_in, d_in, soa, n_tris, 1e-6, 3.4e38), 50),
        plain_ms=time_ms(lambda: ray_hits_plain(o_in, d_in, soa, n_tris, 1e-6, 3.4e38), 5),
        bound_ms=b, bound_by=by, library_ms=None, shape=f"{n} rays x {nt} tris"))

    gen = torch.Generator(device="cpu").manual_seed(0)
    g = torch.from_numpy(assets.gt_surface).to(dev).contiguous()
    n_s = 40960
    samp = g[torch.randint(0, g.shape[0], (n_s,), generator=gen).to(dev)]
    samp = (samp + 0.5 * torch.randn(n_s, 3, generator=gen).to(dev)).contiguous()
    count = torch.tensor([n_s], dtype=torch.int32, device=dev)
    d2_k = kernels.min_sq_dists(g, samp, count)
    d2_p = min_sq_dists_plain(g, samp, count)
    err = float((d2_k - d2_p).abs().max())
    log(f"K3 min_sq_dists: {g.shape[0]} GT x {n_s} samples, max_abs_err(d^2) "
        f"{err:.3e}, covered(<1) {float((d2_k < 1).float().mean()):.4f}")
    if not torch.allclose(d2_k, d2_p, rtol=1e-6, atol=0.0):
        raise AssertionError("K3 disagrees with its plain version")
    # The early poses' layout: a buffer count below the sample size, the
    # rows past it at the sentinel and the loop cut at the count, which is
    # not a multiple of the kernel's tile.
    n_part = 12345
    part = torch.where((torch.arange(n_s, device=dev) < n_part)[:, None], samp,
                       torch.full_like(samp, 1e9)).contiguous()
    count_part = torch.tensor([n_part], dtype=torch.int32, device=dev)
    d2_k = kernels.min_sq_dists(g, part, count_part)
    d2_p = min_sq_dists_plain(g, part, count_part)
    e = float((d2_k - d2_p).abs().max())
    log(f"K3 min_sq_dists: {g.shape[0]} GT x {n_s} samples, {n_part} valid, "
        f"max_abs_err(d^2) {e:.3e}")
    if not torch.equal(d2_k, d2_p):
        raise AssertionError("K3 disagrees with its plain version on a "
                             "partial count")
    err = max(err, e)
    b, by = bound_ms(g.numel() * 4 + samp.numel() * 4 + g.shape[0] * 4,
                     g.shape[0] * n_s * OPS_K3)
    rows.append(dict(
        name="min_sq_dists", route="cuda",
        source="nextbestpath_tpu_torch/csrc/coverage.cu",
        replaces="nextbestpath_tpu/ops/coverage.py:109",
        max_abs_err=err,
        ms=time_ms(lambda: kernels.min_sq_dists(g, samp, count), 20),
        plain_ms=time_ms(lambda: min_sq_dists_plain(g, samp, count), 3),
        bound_ms=b, bound_by=by,
        library_ms=time_ms(lambda: torch.cdist(g, samp).min(dim=1), 5),
        shape=f"{g.shape[0]} GT x {n_s} samples"))
    for r in rows:
        log(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms, "
            f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}, library "
            f"{r['library_ms']}) at {r['shape']}")

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
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
