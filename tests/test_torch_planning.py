"""Planner, per-scene tables and 2D projections of the PyTorch port against
the JAX package. Every output here is integer- or decision-valued (or a
count image), so every comparison is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextbestpath_tpu.assets import generate_scene, pack_generated_scene
from nextbestpath_tpu.eval import nbp_planning as JE
from nextbestpath_tpu.ops import scatter2d as JS
from nextbestpath_tpu.ops.raytrace import tris_to_soa as j_soa
from nextbestpath_tpu.planning import bresenham as JB
from nextbestpath_tpu.planning import candidates as JC
from nextbestpath_tpu.planning import grid_paths as JG
from nextbestpath_tpu.sim import sensor as JSen
from nextbestpath_tpu.sim import rollout as JR
from nextbestpath_tpu.sim.tables import build_scene_tables as j_tables
from nextbestpath_tpu_torch.eval import nbp_planning as TE
from nextbestpath_tpu_torch.ops import scatter2d as TS
from nextbestpath_tpu_torch.ops.raytrace import tris_to_soa
from nextbestpath_tpu_torch.planning import bresenham as TB
from nextbestpath_tpu_torch.planning import candidates as TC
from nextbestpath_tpu_torch.planning import grid_paths as TG
from nextbestpath_tpu_torch.sim import sensor as TSen
from nextbestpath_tpu_torch.sim import rollout as TR
from nextbestpath_tpu_torch.sim.tables import build_scene_tables


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _serpentine(L=10, H=10):
    blocked = np.zeros((4, L, H), bool)
    for j in range(H - 1):
        open_row = (L - 1) if j % 2 == 0 else 0
        for i in range(L):
            if i != open_row:
                blocked[2, i, j] = True
                blocked[3, i, j + 1] = True
    return blocked


def _random_blocked(L, H, p, seed):
    return np.random.default_rng(seed).random((4, L, H)) < p


@pytest.fixture(scope="module")
def scene():
    return pack_generated_scene(generate_scene("simple", seed=8))


def test_lattice_positions_match(scene):
    want = JG.lattice_positions(jnp.asarray(scene.pose_origin), 17, 17)
    _eq(TG.lattice_positions(_t(scene.pose_origin), 17, 17), want)


# ("normal", 8): 584 triangles, more than the JAX kernel's 512-triangle chunk;
# the port casts the inside test and the edges in one launch.
@pytest.mark.parametrize("difficulty,seed", [("simple", 8), ("simple", 2),
                                             ("normal", 8)],
                         ids=["8", "2", "normal-8"])
def test_scene_tables_match(difficulty, seed):
    assets = pack_generated_scene(generate_scene(difficulty, seed=seed))
    L, H = assets.pose_l, assets.pose_h
    want = j_tables(j_soa(jnp.asarray(assets.tris)), assets.n_tris,
                    jnp.asarray(assets.pose_origin), L, H)
    got = build_scene_tables(tris_to_soa(_t(assets.tris)),
                             torch.tensor([assets.n_tris]),
                             _t(assets.pose_origin), L, H)
    _eq(got.positions, want.positions)
    _eq(got.inside, want.inside)
    _eq(got.gt_edge_blocked, want.gt_edge_blocked)
    assert got.inside.any() and got.gt_edge_blocked.any()


def test_bresenham_counts_match():
    rng = np.random.default_rng(0)
    img = (rng.random((64, 64)) < 0.3).astype(np.float32)
    n = 300
    x0, y0 = rng.integers(0, 64, n), rng.integers(0, 64, n)
    x1 = np.clip(x0 + rng.integers(-15, 16, n), 0, 63)
    y1 = np.clip(y0 + rng.integers(-15, 16, n), 0, 63)
    want = JB.bresenham_obstacle_count_v(jnp.asarray(x0), jnp.asarray(y0),
                                         jnp.asarray(x1), jnp.asarray(y1),
                                         jnp.asarray(img))
    got = TB.bresenham_obstacle_count(_t(x0), _t(y0), _t(x1), _t(y1), _t(img))
    _eq(got, want)


def test_layout_edge_blocked_matches(scene):
    rng = np.random.default_rng(1)
    layout = (rng.random((64, 64)) < 0.15).astype(np.float32)
    pos = JG.lattice_positions(jnp.asarray(scene.pose_origin), 17, 17)
    cam = np.asarray(pos[5, 6])
    want = JG.layout_edge_blocked(pos, jnp.asarray(cam), jnp.asarray(layout),
                                  17, 17, layout_size=64)
    got = TG.layout_edge_blocked(_t(pos), _t(cam), _t(layout), 17, 17,
                                 layout_size=64)
    _eq(got, want)


def test_apply_edge_memo_matches():
    rng = np.random.default_rng(2)
    lb = rng.random((4, 6, 7)) < 0.5
    memo = rng.integers(0, 3, (4, 6, 7)).astype(np.int8)
    _eq(TG.apply_edge_memo(_t(lb), _t(memo)),
        JG.apply_edge_memo(jnp.asarray(lb), jnp.asarray(memo)))


@pytest.mark.parametrize("case", ["open", "serpentine", "random", "walled"])
def test_bfs_distance_field_matches(case):
    L, H = 10, 10
    blocked = {"open": np.zeros((4, L, H), bool), "serpentine": _serpentine(),
               "random": _random_blocked(L, H, 0.35, 3),
               "walled": np.ones((4, L, H), bool)}[case]
    for start in ((0, 0), (4, 7)):
        want = JG.bfs_distance_field(jnp.asarray(blocked), jnp.asarray(start),
                                     L, H)
        _eq(TG.bfs_distance_field(_t(blocked), start, L, H), want)


@pytest.mark.parametrize("case,goal,max_len", [
    ("open", (4, 3), 16), ("open", (9, 9), 5), ("serpentine", (9, 9), 20),
    ("random", (7, 2), 32), ("walled", (5, 5), 16)])
def test_extract_path_matches(case, goal, max_len):
    L, H = 10, 10
    blocked = {"open": np.zeros((4, L, H), bool), "serpentine": _serpentine(),
               "random": _random_blocked(L, H, 0.3, 4),
               "walled": np.ones((4, L, H), bool)}[case]
    dist = JG.bfs_distance_field(jnp.asarray(blocked), jnp.asarray([0, 0]), L, H)
    pj, lj, rj = JG.extract_path(dist, jnp.asarray(blocked), jnp.asarray(goal),
                                 L, H, max_len=max_len)
    pt, lt, rt = TG.extract_path(_t(dist), _t(blocked), goal, L, H,
                                 max_len=max_len)
    _eq(pt, pj)
    assert lt == int(lj) and rt == bool(rj)


def test_pick_orientations_match(scene):
    rng = np.random.default_rng(5)
    L, H, max_len = 17, 17, 12
    pos = JG.lattice_positions(jnp.asarray(scene.pose_origin), L, H)
    path = np.stack([rng.integers(0, L, max_len), rng.integers(0, H, max_len)],
                    -1).astype(np.int32)
    path[-3:] = -1
    valid = np.arange(max_len) < max_len - 3
    value_map = rng.normal(size=(16, 16, 8)).astype(np.float32)
    visited = rng.random((L, H, 8)) < 0.4
    visited[path[0, 0], path[0, 1]] = True  # every orientation visited
    cam = np.asarray(pos[3, 3])
    key = jax.random.PRNGKey(6)
    want = JG.pick_orientations(jnp.asarray(path), jnp.asarray(valid),
                                jnp.asarray(value_map), pos, jnp.asarray(cam),
                                jnp.asarray(visited), key, n_azim=8,
                                value_map_size=16)
    u = _t(jax.random.uniform(key, (max_len, 8)))
    got = TG.pick_orientations(_t(path), _t(valid), _t(value_map), _t(pos),
                               _t(cam), _t(visited), u, n_azim=8,
                               value_map_size=16)
    _eq(got, want)


def test_score_candidates_and_select_goal_match(scene):
    rng = np.random.default_rng(7)
    L, H = 17, 17
    pos = JG.lattice_positions(jnp.asarray(scene.pose_origin), L, H)
    cam = np.asarray(pos[4, 4])
    value_map = rng.normal(size=(16, 16, 8)).astype(np.float32)
    proj = (rng.random((64, 64)) < 0.02).astype(np.float32)
    banned = rng.random((L, H)) < 0.1
    want = JC.score_candidates_test(pos, jnp.asarray(cam), jnp.asarray(value_map),
                                    jnp.asarray(proj), jnp.asarray(banned),
                                    value_map_size=16, layout_size=64)
    got = TC.score_candidates_test(_t(pos), _t(cam), _t(value_map), _t(proj),
                                   _t(banned), value_map_size=16, layout_size=64)
    _eq(got, want)
    assert (got.numpy() > -1e29).any()
    dist = JG.bfs_distance_field(jnp.asarray(_random_blocked(L, H, 0.3, 8)),
                                 jnp.asarray([4, 4]), L, H)
    gj, fj = JE.select_goal(want, dist, L, H)
    gt_, ft = TE.select_goal(got, _t(dist), L, H)
    _eq(gt_, gj)
    assert gt_.dtype == torch.int64 and ft.dtype == torch.bool
    assert bool(fj) == bool(ft)


def _buffers(seed=9, n=3000, cap=4096):
    rng = np.random.default_rng(seed)
    pts = np.zeros((cap, 3), np.float32)
    pts[:n] = rng.uniform([-30, -1, -30], [30, 10, 30], (n, 3))
    traj = np.zeros((20, 3), np.float32)
    traj[:7] = rng.uniform(-10, 10, (7, 3))
    pj = JSen.PointBuffer(jnp.asarray(pts), jnp.int32(n))
    tj = JR.TrajectoryBuffer(jnp.asarray(traj), jnp.int32(7))
    pt = TSen.PointBuffer.create(cap, "cpu")
    pt.points.copy_(_t(pts))
    pt.count = torch.tensor(n, dtype=torch.int32)
    tt = TR.TrajectoryBuffer.create(20, "cpu")
    tt.xyz.copy_(_t(traj))
    tt.count = torch.tensor(7, dtype=torch.int32)
    return pj, tj, pt, tt


def test_scatter_helpers_match():
    rng = np.random.default_rng(10)
    pts = rng.uniform(-45, 45, (500, 3)).astype(np.float32)
    cam = np.array([1.0, 2.0, -3.0], np.float32)
    _eq(TS.ego2d(_t(pts), _t(cam)), JS.ego2d(jnp.asarray(pts), jnp.asarray(cam)))
    p2 = JS.ego2d(jnp.asarray(pts), jnp.asarray(cam))
    _eq(TS.img_coords(_t(p2), 64, (-40.0, 40.0)),
        JS.img_coords(p2, 64, (-40.0, 40.0)))
    bins_j = JS.height_bins(jnp.float32(-0.3), jnp.float32(9.1), 4)
    bins_t = TS.height_bins(-0.3, 9.1, 4)
    _eq(bins_t, bins_j)
    _eq(TS.bucketize_bins(_t(pts[:, 1]), bins_t),
        JS.bucketize_bins(jnp.asarray(pts[:, 1]), bins_j))


def test_model_input_and_fuse_layout_match():
    pj, tj, pt, tt = _buffers()
    cam5 = np.array([0.5, 3.3, -0.5, 0.0, 45.0], np.float32)
    bins = JS.height_bins(jnp.float32(0.0), jnp.float32(9.0), 4)
    xj, trj = JE.build_model_input(pj, tj, jnp.asarray(cam5[:3]), bins,
                                   n_pieces=4, img_size=64)
    xt, trt = TE.build_model_input(pt, tt, _t(cam5[:3]), TS.height_bins(0.0, 9.0, 4),
                                   n_pieces=4, img_size=64)
    _eq(xt, xj)
    _eq(trt, trj)
    assert xt.shape == (1, 64, 64, 5) and float(xt.sum()) > 0
    pred = np.random.default_rng(11).random((64, 64)).astype(np.float32) * 0.3
    lj, prj = JE.fuse_layout(jnp.asarray(pred), pj, trj, jnp.asarray(cam5),
                             img_size=64)
    lt, prt = TE.fuse_layout(_t(pred), pt, trt, _t(cam5), img_size=64)
    _eq(lt, lj)
    _eq(prt, prj)
    mi, tr2, proj, filt = TE.build_plan_projections(
        pt, tt, _t(cam5), TS.height_bins(0.0, 9.0, 4), n_pieces=4, img_size=64)
    _eq(mi, xj)
    _eq(TE.fuse_layout_from_projections(_t(pred), proj, filt, tr2)[0], lj)
