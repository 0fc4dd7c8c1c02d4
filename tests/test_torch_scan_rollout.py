"""The port's device-resident scan rollout (eval/scan_rollout.py) and the
modules it brought: BN folding, the one-pass plan projections, the
tensor-in planner (``bench_torch.py``'s tests are in
``test_torch_bench_cli.py``).

On the small config of tests/test_scan_vs_host.py (32x56 frames, 64^2
maps, the full-width NBP with random weights and the obstacle decoder
opened), with the JAX key schedule injected (test_torch_rollout.JaxDraws,
whose roles are the scan's 7-way split): the port's ScanRollout against the
JAX ScanRollout over 8 poses, with BN folding on and off, must give the
same trajectory (cam positions within 1e-4), the same point count and the
coverage curve within 1e-3; and against the port's host rollout with the
same draws. Integer and count outputs are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextbestpath_tpu.assets import generate_scene, pack_generated_scene
from nextbestpath_tpu.config import default_params
from nextbestpath_tpu.eval import nbp_planning as JE
from nextbestpath_tpu.eval.scan_rollout import ScanRollout as JaxScan
from nextbestpath_tpu.models import NBP as FlaxNBP
from nextbestpath_tpu.models.fold import fold_bn_variables
from nextbestpath_tpu.ops.scatter2d import height_bins as j_height_bins
from nextbestpath_tpu.planning import grid_paths as JG
from nextbestpath_tpu.sim.rollout import TrajectoryBuffer as JTraj
from nextbestpath_tpu.sim.sensor import PointBuffer as JPoints
from nextbestpath_tpu_torch import assets as TA
from nextbestpath_tpu_torch import config as TC
from nextbestpath_tpu_torch.eval import nbp_planning as TE
from nextbestpath_tpu_torch.eval.nbp_planning import \
    NBPPlanningRollout as TorchHost
from nextbestpath_tpu_torch.eval.scan_rollout import (ScanRollout,
                                                      _edge_dir_index,
                                                      _memo_edge)
from nextbestpath_tpu_torch.models.convert import flax_to_state_dict
from nextbestpath_tpu_torch.models.fold import fold_bn
from nextbestpath_tpu_torch.models.unet import NBP as TorchNBP
from nextbestpath_tpu_torch.ops.scatter2d import height_bins
from nextbestpath_tpu_torch.planning import grid_paths as TG
from nextbestpath_tpu_torch.sim.rollout import TrajectoryBuffer
from nextbestpath_tpu_torch.sim.sensor import PointBuffer

from test_torch_planning import _random_blocked, _serpentine
from test_torch_rollout import SMALL, JaxDraws, _flax_model
from test_torch_unet import _perturb_stats, _to_numpy

COV_ATOL = 1e-3


def _torch_model(variables):
    m = TorchNBP()
    m.load_state_dict(flax_to_state_dict(variables["params"],
                                         variables["batch_stats"]))
    return m


def _torch_assets(difficulty, seed, params=None):
    return TA.pack_generated_scene(
        TA.generate_scene(difficulty, seed=seed),
        params=params or TC.default_params(**SMALL))


def _same_rollout(got, want, cam_atol=1e-4):
    assert len(got.coverage_evolution) == len(want.coverage_evolution)
    np.testing.assert_allclose(got.coverage_evolution,
                               want.coverage_evolution, atol=COV_ATOL)
    assert got.n_points == want.n_points
    assert got.cam_positions.shape == want.cam_positions.shape
    np.testing.assert_allclose(got.cam_positions, want.cam_positions,
                               atol=cam_atol)


@pytest.fixture(scope="module")
def flax_model():
    return _flax_model()


# ("normal", 8) over 8 poses regenerates on 6 poses, memoises first-segment
# collisions and bans goals, so the retry predication is held too.
@pytest.mark.parametrize("fold", [False, True], ids=["unfolded", "folded"])
@pytest.mark.parametrize("difficulty,scene_seed", [("simple", 4),
                                                   ("normal", 8)])
def test_scan_matches_jax_scan_rollout(flax_model, difficulty, scene_seed,
                                       fold):
    model, variables = flax_model
    params = default_params(**SMALL)
    assets = pack_generated_scene(generate_scene(difficulty, seed=scene_seed),
                                  params=params)
    want = JaxScan(assets, model, variables, params=params,
                   fold_bn=fold).run(n_poses=8, seed=8)
    roll = ScanRollout(_torch_assets(difficulty, scene_seed),
                       _torch_model(variables),
                       params=TC.default_params(**SMALL), fold_bn=fold,
                       draws=JaxDraws(8), device="cpu")
    got = roll.run(n_poses=8)
    _same_rollout(got, want)
    assert got.auc == pytest.approx(want.auc, abs=COV_ATOL)
    assert roll.regen_poses[0] and not all(roll.regen_poses)
    assert max(got.coverage_evolution[1:]) > got.coverage_evolution[0]


def test_scan_capture_options_match_jax(flax_model):
    """The stratified draw and the batched capture together: the port's
    scan against the JAX scan with ``stratified_sampling`` and
    ``batched_capture`` on (at 32x56 and 256 points a frame a stratum is
    7 pixels, so the stratified draw applies), 8 poses of simple/4."""
    model, variables = flax_model
    opts = dict(SMALL, stratified_sampling=True, batched_capture=True)
    params = default_params(**opts)
    assets = pack_generated_scene(generate_scene("simple", seed=4),
                                  params=params)
    want = JaxScan(assets, model, variables, params=params).run(n_poses=8,
                                                                seed=8)
    roll = ScanRollout(_torch_assets("simple", 4), _torch_model(variables),
                       params=TC.default_params(**opts), draws=JaxDraws(8),
                       device="cpu")
    assert roll.stratified and roll.batched_capture
    _same_rollout(roll.run(n_poses=8), want)


def test_scan_matches_port_host_rollout(flax_model):
    """The scan and the port's host rollout (max_plan_retries=4, the scan's)
    with the same JAX draws take the same decisions on simple/4."""
    _, variables = flax_model
    params = TC.default_params(**SMALL)
    assets = _torch_assets("simple", 4)
    host = TorchHost(assets, _torch_model(variables), params=params,
                     draws=JaxDraws(8), shared_rng=True, max_plan_retries=4,
                     device="cpu")
    scan = ScanRollout(assets, _torch_model(variables), params=params,
                       fold_bn=False, draws=JaxDraws(8), device="cpu")
    _same_rollout(scan.run(n_poses=8), host.run(n_poses=8))


def test_scan_default_draws_repeat_and_refuse_options():
    params = TC.default_params(**SMALL)
    assets = _torch_assets("simple", 4)
    torch.manual_seed(0)
    roll = ScanRollout(assets, TorchNBP(width=8), params=params,
                       device="cpu")
    a, b = roll.run(n_poses=3, seed=5), roll.run(n_poses=3, seed=5)
    assert a.coverage_evolution == b.coverage_evolution
    np.testing.assert_array_equal(a.cam_positions, b.cam_positions)
    assert roll.state.pc.count.device.type == "cpu"
    # The capture options no longer refuse: each runs and repeats.
    for opt in ("stratified_sampling", "batched_capture"):
        p = TC.default_params(**SMALL, **{opt: True})
        r = ScanRollout(assets, TorchNBP(width=4), params=p, device="cpu")
        assert r.stratified == (opt == "stratified_sampling")
        assert r.batched_capture == (opt == "batched_capture")
        c, d = r.run(n_poses=2, seed=5), r.run(n_poses=2, seed=5)
        assert c.coverage_evolution == d.coverage_evolution
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            ScanRollout(assets, TorchNBP(width=4), params=params)


@pytest.mark.parametrize("which", ["scan", "walk"])
def test_run_results_outlive_the_next_run(which):
    """A run's trajectory is the host's own copy on the CPU too: the next
    run, on another trajectory (the scan with other weights, the walk from
    another seed), leaves it as it was."""
    from nextbestpath_tpu_torch.eval.random_walk import ScanRandomWalk

    params = TC.default_params(**SMALL)
    assets = _torch_assets("simple", 4)
    if which == "scan":
        roll = ScanRollout(assets, TE.seeded_nbp(width=8), params=params,
                           device="cpu")
        first = roll.run(n_poses=4, seed=5)
        kept = first.cam_positions.copy()
        second = roll.run(n_poses=4, seed=5,
                          variables=TE.seeded_nbp(width=8, seed=4))
    else:
        roll = ScanRandomWalk([assets], params=params, device="cpu")
        first = roll.run(n_poses=4, seed=5)[0]
        kept = first.cam_positions.copy()
        second = roll.run(n_poses=4, seed=6)[0]
    assert not np.array_equal(second.cam_positions[:len(kept)], kept)
    np.testing.assert_array_equal(first.cam_positions, kept)


def test_edge_memo_helpers():
    memo = torch.zeros((4, 5, 6), dtype=torch.int8)
    a, b = torch.tensor([2, 3]), torch.tensor([3, 3])
    assert int(_edge_dir_index(a, b)) == 0
    assert int(_edge_dir_index(b, a)) == 1
    assert int(_edge_dir_index(a, torch.tensor([2, 4]))) == 2
    assert int(_edge_dir_index(a, torch.tensor([4, 3]))) == -1
    m = _memo_edge(memo, a, b, 2, torch.tensor(True))
    want = np.zeros((4, 5, 6), np.int8)
    want[0, 2, 3] = want[1, 3, 3] = 2
    np.testing.assert_array_equal(m.numpy(), want)
    assert not _memo_edge(memo, a, b, 2, torch.tensor(False)).any()
    assert not _memo_edge(memo, a, torch.tensor([4, 4]), 1,
                          torch.tensor(True)).any()


def test_fold_bn_matches_jax_fold():
    """fold_bn at width 8 against the JAX fold_bn_variables: every folded
    convolution's weight and bias, and the folded forward, in f32."""
    fm = FlaxNBP(width=8)
    variables = fm.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 5)))
    params = _to_numpy(variables["params"])
    stats = _perturb_stats(_to_numpy(variables["batch_stats"]), 3)
    folded = fold_bn_variables({"params": params, "batch_stats": stats})
    model = TorchNBP(width=8)
    model.load_state_dict(flax_to_state_dict(params, stats))
    got = fold_bn(model)
    assert isinstance(model.conv_blocks[0].bn0, torch.nn.BatchNorm2d)
    assert isinstance(got.conv_blocks[0].bn0, torch.nn.Identity)
    fp = folded["params"]

    def conv(tree, j):
        c = tree[f"TorchConv_{j}"]["Conv_0"]
        return (np.asarray(c["kernel"]).transpose(3, 2, 0, 1),
                np.asarray(c["bias"]))

    pairs = []
    for i in range(11):
        blk = got.conv_blocks[i]
        pairs += [(blk.conv0, conv(fp[f"ConvBlock_{i}"], 0)),
                  (blk.conv1, conv(fp[f"ConvBlock_{i}"], 1))]
    for i in range(6):
        pairs.append((got.up_convs[i].conv, conv(fp[f"UpConv_{i}"], 0)))
        g = got.att_gates[i]
        for j, c in enumerate((g.w_g, g.w_x, g.psi)):
            pairs.append((c, conv(fp[f"AttentionGate_{i}"], j)))
    for c, (w, b) in pairs:
        np.testing.assert_allclose(c.weight.detach().numpy(), w, rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(c.bias.detach().numpy(), b, rtol=1e-6,
                                   atol=1e-7)
    x = np.random.default_rng(4).random((1, 32, 32, 5)).astype(np.float32)
    v_j, o_j = FlaxNBP(width=8, fold_bn=True).apply(folded, jnp.asarray(x),
                                                    train=False)
    with torch.no_grad():
        v_t, o_t = got(torch.from_numpy(x))
        v_u, o_u = model.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-4)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-4)
    np.testing.assert_allclose(v_t.numpy(), v_u.numpy(), atol=1e-4)
    np.testing.assert_allclose(o_t.numpy(), o_u.numpy(), atol=1e-4)


@pytest.mark.parametrize("n_pts", [0, 1, 3000, 8192],
                         ids=["empty", "one", "partial", "full"])
def test_plan_projections_match_jax(n_pts):
    """build_plan_projections (one interleaved scatter, plan_count_imgs)
    against the JAX package's, and against the port's three-scatter path,
    at empty, partial and full counts, with heights below, inside and above
    the bins (the overflow channel)."""
    rng = np.random.default_rng(n_pts)
    cap = 8192
    pts = rng.uniform(-30.0, 30.0, (cap, 3)).astype(np.float32)
    pts[:, 1] = rng.uniform(-2.0, 12.0, cap)
    traj = rng.uniform(-30.0, 30.0, (64, 3)).astype(np.float32)
    cam5 = np.array([3.0, 3.3, -4.0, 0.0, 90.0], np.float32)
    pj = JPoints(jnp.asarray(pts), jnp.int32(n_pts))
    tj = JTraj(jnp.asarray(traj), jnp.int32(40))
    bins_j = j_height_bins(jnp.float32(0.0), jnp.float32(9.0), 4)
    want = JE.build_plan_projections(pj, tj, jnp.asarray(cam5), bins_j)

    pt = PointBuffer.create(cap, "cpu")
    pt.points.copy_(torch.from_numpy(pts))
    pt.count.fill_(n_pts)
    tt = TrajectoryBuffer.create(64, "cpu")
    tt.xyz.copy_(torch.from_numpy(traj))
    tt.count.fill_(40)
    bins_t = height_bins(0.0, 9.0, 4)
    got = TE.build_plan_projections(pt, tt, torch.from_numpy(cam5), bins_t)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    mi, ti = TE.build_model_input(pt, tt, torch.from_numpy(cam5[:3]), bins_t)
    proj, filt = TE._layout_projections(pt, torch.from_numpy(cam5), 256,
                                        (-40.0, 40.0))
    for g, w in zip(got, (mi, ti, proj, filt)):
        assert torch.equal(g, w)
    assert (float(got[2].sum()) > 0) == (n_pts > 0)


@pytest.mark.parametrize("case", ["open", "serpentine", "random", "walled"])
def test_tensor_bfs_and_path_match_jax(case):
    """The tensor-in planner (start and goal as int64 tensors, outputs as
    tensors) against the JAX planner on the maze cases of
    test_torch_planning.py, the goal past max_len included."""
    L, H = 10, 10
    blocked = {"open": np.zeros((4, L, H), bool), "serpentine": _serpentine(),
               "random": _random_blocked(L, H, 0.35, 3),
               "walled": np.ones((4, L, H), bool)}[case]
    bt = torch.from_numpy(blocked)
    for start in ((0, 0), (4, 7)):
        want = JG.bfs_distance_field(jnp.asarray(blocked), jnp.asarray(start),
                                     L, H)
        dist = TG.bfs_distance_field(bt, torch.tensor(start), L, H)
        assert isinstance(dist, torch.Tensor) and dist.dtype == torch.int32
        np.testing.assert_array_equal(dist.numpy(), np.asarray(want))
        for goal, max_len in (((9, 9), 5), ((9, 9), 32), ((3, 4), 16)):
            pj, lj, rj = JG.extract_path(want, jnp.asarray(blocked),
                                         jnp.asarray(goal), L, H,
                                         max_len=max_len)
            pt, lt, rt = TG.extract_path(dist, bt, torch.tensor(goal), L, H,
                                         max_len=max_len)
            np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
            assert isinstance(lt, torch.Tensor) and int(lt) == int(lj)
            assert isinstance(rt, torch.Tensor) and bool(rt) == bool(rj)


@pytest.mark.slow
def test_scan_matches_jax_scan_rollout_full_width(flax_model):
    """The main path's configuration (eval.nbp_planning.main_path_setup:
    simple/8 at default_params()) for 2 poses against the JAX ScanRollout,
    with the same tolerances as the small config."""
    from nextbestpath_tpu_torch.eval.nbp_planning import (MAIN_PATH_SEED,
                                                          main_path_setup)

    model, variables = flax_model
    t_params, t_assets, _ = main_path_setup()
    params = default_params()
    assets = pack_generated_scene(generate_scene("simple",
                                                 seed=MAIN_PATH_SEED),
                                  params=params)
    assert assets.tris.tobytes() == t_assets.tris.tobytes()
    want = JaxScan(assets, model, variables, params=params).run(
        n_poses=2, seed=MAIN_PATH_SEED)
    got = ScanRollout(t_assets, _torch_model(variables), params=t_params,
                      draws=JaxDraws(MAIN_PATH_SEED), device="cpu").run(
                          n_poses=2)
    _same_rollout(got, want)
