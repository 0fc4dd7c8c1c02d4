"""The port's multi-scene modes against the JAX package, on the CPU:
the scene-axis wrappers of K1, K3 and the planner kernels, the true-batch
``BatchedScanRollout``, ``run_interleaved``, ``ScanRandomWalk`` and
``bench_torch.py --batch / --secondary``.

At the JAX tests' ``TINY`` config (32x56 frames, 64x64 model input) with a
width-8 NBP (flax init, ``final2`` bias -4), the JAX key schedules injected
(``JaxDraws``; ``JaxWalkDraws``, the walk step's 5-way split):

* the scene-axis plain versions equal each scene's own plain call, bit for
  bit (they are the functions the card's kernels are held to);
* the batched rollout over three padded scenes, with mixed regeneration
  flags on some pose (asserted): the same trajectories as the JAX batched
  rollout, coverage within 1e-3; against single-scene port runs on the same
  padded arrays, coverage and cam positions bit for bit. The U-Net at batch
  3 may differ from batch 1 in the last bit, so its maps are not compared:
  the decisions are, and everything that follows from them;
* ``run_interleaved``: bit for bit against single port runs, within 1e-3 of
  the JAX ``run_interleaved``;
* ``ScanRandomWalk``: coverage within 1e-3, the same trajectories and point
  counts as the JAX walk.
"""

import dataclasses
import io
import json
import os
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextbestpath_tpu import assets as JA
from nextbestpath_tpu import config as JC
from nextbestpath_tpu.eval.random_walk import ScanRandomWalk as JWalk
from nextbestpath_tpu.eval.scan_rollout import \
    BatchedScanRollout as JBatched
from nextbestpath_tpu.eval.scan_rollout import ScanRollout as JScan
from nextbestpath_tpu.eval.scan_rollout import \
    run_interleaved as j_run_interleaved
from nextbestpath_tpu.models import NBP as FlaxNBP
from nextbestpath_tpu_torch import assets as TA
from nextbestpath_tpu_torch import config as TC
from nextbestpath_tpu_torch.eval.random_walk import ScanRandomWalk
from nextbestpath_tpu_torch.eval.scan_rollout import (BatchedScanRollout,
                                                      ScanRollout,
                                                      run_interleaved)
from nextbestpath_tpu_torch.geometry.cameras import (CameraIntrinsics,
                                                     get_camera_RT)
from nextbestpath_tpu_torch.models.convert import flax_to_state_dict
from nextbestpath_tpu_torch.models.unet import NBP as TorchNBP
from nextbestpath_tpu_torch.ops import coverage as TCov
from nextbestpath_tpu_torch.ops import raytrace as TR
from nextbestpath_tpu_torch.planning import grid_paths as TG

from test_torch_planning import _random_blocked, _serpentine
from test_torch_rollout import JaxDraws
from test_torch_scan_collection import TINY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COV_ATOL = 1e-3
N_POSES = 6
SEEDS = (5, 6, 7)  # simple scenes: pose 0 regenerates everywhere, later
                   # poses regenerate in some scenes only


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the tier-1 run puts several test processes on
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


class JaxWalkDraws(JaxDraws):
    """The JAX walk's key schedule: one split for the initial capture, then
    a 5-way split a pose (``state.key`` and one key a role)."""

    ROLES = ("cov", "dir", "rot", "move")

    def begin_pose(self):
        keys = jax.random.split(self.key, 5)
        self.key = keys[0]
        self.roles = dict(zip(self.ROLES, keys[1:]))

    def gumbel(self, role, shape, step=None):
        return torch.from_numpy(np.array(
            jax.random.gumbel(self._key(role, step), tuple(shape))))


@pytest.fixture(scope="module")
def nbp8():
    """(flax module, variables, port model) of a width-8 NBP with its
    obstacle decoder opened (final2 bias -4)."""
    model = FlaxNBP(width=8)
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 5)),
                   train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    params = dict(v["params"])
    params["final2"] = {"Conv_0": dict(params["final2"]["Conv_0"])}
    params["final2"]["Conv_0"]["bias"] = (
        params["final2"]["Conv_0"]["bias"] - 4.0)
    variables = {"params": params, "batch_stats": v["batch_stats"]}
    return model, variables


def _port(variables):
    m = TorchNBP(width=8)
    m.load_state_dict(flax_to_state_dict(variables["params"],
                                         variables["batch_stats"]))
    return m


def _scenes(pkg, cfg, seeds=SEEDS, difficulties=("simple",) * 3):
    p = cfg.default_params(**TINY)
    return pkg.scene_assets.pad_assets_to_common([pkg.pack_generated_scene(
        pkg.generate_scene(d, seed=s), params=p)
        for d, s in zip(difficulties, seeds)])


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.coverage_evolution,
                                   w.coverage_evolution, atol=COV_ATOL)
        assert g.n_points == w.n_points
        assert g.cam_positions.shape == w.cam_positions.shape
        np.testing.assert_allclose(g.cam_positions, w.cam_positions,
                                   atol=1e-4)


def _bitwise(got, want):
    assert got.coverage_evolution == want.coverage_evolution
    np.testing.assert_array_equal(got.cam_positions, want.cam_positions)
    assert got.n_points == want.n_points


# -- the scene-axis plain versions ------------------------------------------

def test_scene_axis_plain_versions_equal_per_scene_calls():
    """render_depth_scenes, coverage_percentage_scenes and the two planner
    wrappers over three scenes of unequal triangle, sample and GT counts
    equal each scene's own call, bit for bit."""
    p = TC.default_params(**TINY)
    scenes = _scenes(TA, TC, (5, 3, 6), ("simple", "normal", "simple"))
    intr = CameraIntrinsics(int(p.image_height), int(p.image_width),
                            float(p.fov_degrees), float(p.camera_znear),
                            float(p.zfar))
    soas = torch.stack([TR.tris_to_soa(torch.from_numpy(a.tris))
                        for a in scenes])
    counts = torch.tensor([a.n_tris for a in scenes], dtype=torch.int32)
    assert len(set(counts.tolist())) > 1
    rng = np.random.default_rng(0)
    poses = torch.from_numpy(np.stack([
        np.stack([a.pose_from_idx(a.start_cam_idx)] * 2) for a in scenes])
        .astype(np.float32))
    poses[:, 1, 4] += 45.0
    flat = poses.reshape(-1, 5)
    R, T = get_camera_RT(flat[:, :3], flat[:, 3:])
    zb = TR.render_depth_scenes(soas, counts, R.reshape(3, 2, 3, 3),
                                T.reshape(3, 2, 3), intr)
    for b in range(3):
        want = TR.render_depth_batch(soas[b], int(counts[b]),
                                     R.reshape(3, 2, 3, 3)[b],
                                     T.reshape(3, 2, 3)[b], intr)
        assert torch.equal(zb[b], want)
        assert (want > 0).any()

    g = torch.from_numpy(rng.uniform(-20, 20, (3, 900, 3)).astype(np.float32))
    gt_valid = torch.ones((3, 900), dtype=torch.bool)
    gt_valid[1, 700:] = False
    pts = torch.from_numpy(rng.uniform(-20, 20, (3, 4096, 3))
                           .astype(np.float32))
    n = torch.tensor([4000, 0, 1234], dtype=torch.int32)
    starts, halves = torch.tensor([7, 0, 99]), torch.tensor([1000, 1, 300])
    cov = TCov.coverage_percentage_scenes(g, pts, n, starts, halves,
                                          gt_valid)
    for b in range(3):
        want = TCov.coverage_percentage(g[b], pts[b], n[b], starts[b],
                                        halves[b], gt_valid=gt_valid[b])
        assert torch.equal(cov[b], want)
    assert cov[0] > 0 and cov[1] == 0

    L = H = 17
    blocked = torch.from_numpy(np.stack(
        [_random_blocked(L, H, 0.3, s) for s in (1, 2)]
        + [_serpentine(L, H)]))
    start = torch.tensor([[0, 0], [8, 8], [0, 0]])
    dist = TG.bfs_distance_field_scenes(blocked, start, L, H)
    goal = torch.tensor([[16, 16], [3, 12], [16, 16]])
    path, plen, reach = TG.extract_path_scenes(dist, blocked, goal, L, H, 32)
    for b in range(3):
        d1 = TG.bfs_distance_field(blocked[b], start[b], L, H)
        assert torch.equal(dist[b], d1)
        p1, l1, r1 = TG.extract_path(d1, blocked[b], goal[b], L, H, 32)
        assert torch.equal(path[b], p1) and plen[b] == l1 and reach[b] == r1


# -- BatchedScanRollout with a true batch ------------------------------------

def test_true_batch_matches_jax_batch_and_single_scenes(nbp8):
    model, variables = nbp8
    want = JBatched(_scenes(JA, JC), model, variables,
                    params=JC.default_params(**TINY)).run(n_poses=N_POSES,
                                                          seed=8)
    scenes = _scenes(TA, TC)
    params = TC.default_params(**TINY)
    batched = BatchedScanRollout(scenes, _port(variables), params=params,
                                 make_draws=JaxDraws, device="cpu")
    got = batched.run(n_poses=N_POSES, seed=8)
    _same(got, want)
    flags = batched.regen_poses
    assert len(flags) == N_POSES and all(flags[0])
    assert any(any(f) and not all(f) for f in flags), flags  # mixed pose
    assert batched.scene.tri_soa.shape[0] == len(scenes)
    for i, (a, scene) in enumerate(zip(scenes, batched.scenes)):
        solo = ScanRollout(a, _port(variables), params=params, scene=scene,
                           draws=JaxDraws(8 + i), device="cpu")
        _bitwise(got[i], solo.run(n_poses=N_POSES))
        assert solo.regen_poses == [f[i] for f in flags]
    assert got[0].steps_per_sec == pytest.approx(
        len(scenes) * N_POSES / got[0].wall_time_s)


# -- run_interleaved ---------------------------------------------------------

def test_run_interleaved_matches_single_runs_and_jax(nbp8):
    model, variables = nbp8
    seeds = [4, 2, 9]
    want = j_run_interleaved(
        [JScan(a, model, variables, params=JC.default_params(**TINY))
         for a in _scenes(JA, JC)], n_poses=N_POSES, seeds=seeds)
    params = TC.default_params(**TINY)
    scenes = _scenes(TA, TC)
    rolls = [ScanRollout(a, _port(variables), params=params,
                         draws=JaxDraws(s), device="cpu")
             for a, s in zip(scenes, seeds)]
    got = run_interleaved(rolls, n_poses=N_POSES, seeds=seeds)
    _same(got, want)
    assert len({g.wall_time_s for g in got}) == 1
    assert got[0].steps_per_sec == pytest.approx(
        3 * N_POSES / got[0].wall_time_s)
    for a, s, g in zip(scenes, seeds, got):
        solo = ScanRollout(a, _port(variables), params=params,
                           draws=JaxDraws(s), device="cpu")
        _bitwise(g, solo.run(n_poses=N_POSES))


# -- ScanRandomWalk -----------------------------------------------------------

def test_scan_random_walk_matches_jax():
    want = JWalk(_scenes(JA, JC), params=JC.default_params(**TINY)).run(
        n_poses=N_POSES, seed=3)
    walk = ScanRandomWalk(_scenes(TA, TC), params=TC.default_params(**TINY),
                          make_draws=JaxWalkDraws, device="cpu")
    got = walk.run(n_poses=N_POSES, seed=3)
    _same(got, want)
    for g in got:
        assert max(g.coverage_evolution[1:]) > g.coverage_evolution[0]
    assert walk.replays == {"pose": 0} and walk.host_reads == 0


def test_scan_random_walk_refuses_mixed_elevations():
    a, b = _scenes(TA, TC, (5, 6))
    b = dataclasses.replace(b, n_elev=b.n_elev + 2)
    assert b.elevations_deg[2] != a.elevations_deg[2]
    with pytest.raises(ValueError, match="elevation"):
        ScanRandomWalk([a, b], params=TC.default_params(**TINY),
                       device="cpu")


# -- bench_torch.py --batch / --secondary ---------------------------------------

# The keys of bench_torch.py's line without the new flags.
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "min", "max", "runs",
              "device", "coverage_final", "auc", "dtype", "stratified",
              "batched_capture"}


@pytest.mark.parametrize("flags,extra", [
    (["--batch", "2"], {"batch"}),
    (["--secondary"], {"stratified_value", "stratified_vs_baseline"}),
    (["--secondary", "--stratified"],
     {"faithful_value", "faithful_vs_baseline"})])
def test_bench_torch_batch_and_secondary(flags, extra):
    """--batch N and --secondary add only their keys to today's line
    (test_torch_scan_rollout.py holds today's line itself)."""
    sys.path.insert(0, REPO)
    import bench_torch

    out = io.StringIO()
    with redirect_stdout(out):
        assert bench_torch.main(["--device", "cpu", "--quick", "--poses", "2",
                                 "--warmup-poses", "1"] + flags) == 0
    printed = out.getvalue().strip().splitlines()
    assert len(printed) == 1
    line = json.loads(printed[0])
    assert set(line) == BENCH_KEYS | extra
    assert line["min"] <= line["value"] <= line["max"]
    assert line["stratified"] == ("--stratified" in flags)
    if "batch" in extra:
        assert line["batch"] == 2
    for k in extra - {"batch"}:
        assert line[k] > 0
