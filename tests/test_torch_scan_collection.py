"""The port's device-resident training collection
(``train/scan_collection.py``) and the padded coverage metric against the
JAX package, with the JAX key schedule injected (``JaxCollectDraws``: the
collection step's 8-way key split, by role).

At the JAX test's ``TINY`` config (32x56 frames, 64x64 model input) with
the full-width f32 NBP of ``test_torch_rollout._flax_model``, 6 poses of
``simple``/2 alone and of the padded pair ``simple``/2 + ``normal``/3
(scene 1): ``pose5``, ``rot``, ``valid``, ``planned``, ``gt_obs`` and the
DB's label pixels and pose indices equal; coverage and gains within 1e-3;
the model inputs equal up to ``MAX_MOVED_POINTS`` cloud points a record
that f32 rounding puts one pixel over (as in ``test_torch_collection.py``;
measured here: one point on 3 of the 6 records of simple/2, none on the
pair). Procgen scenes carry their own cell capacity, so
``grid_capacity_cap`` never cuts their GT clouds and every scene has
``n_gt_surface_points`` of them: the pair's ``normal`` scene is packed
with ``PAIR_NORMAL_GT`` points, so that its cloud is padded and
``gt_valid`` masks rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextbestpath_tpu.assets import generate_scene, pack_generated_scene
from nextbestpath_tpu.assets.scene_assets import \
    pad_assets_to_common as j_pad_common
from nextbestpath_tpu.config import default_params
from nextbestpath_tpu.models import NBP as FlaxNBP
from nextbestpath_tpu.models.fold import fold_bn_variables
from nextbestpath_tpu.ops import coverage as JCov
from nextbestpath_tpu.ops.raytrace import tris_to_soa as j_tris_to_soa
from nextbestpath_tpu.train import scan_collection as JSC
from nextbestpath_tpu.train.replay import ReplayDB as JReplayDB
from nextbestpath_tpu_torch import assets as TA
from nextbestpath_tpu_torch import config as TC
from nextbestpath_tpu_torch.models.convert import flax_to_state_dict
from nextbestpath_tpu_torch.models.unet import NBP as TorchNBP
from nextbestpath_tpu_torch.ops import coverage as TCov
from nextbestpath_tpu_torch.ops.raytrace import tris_to_soa
from nextbestpath_tpu_torch.train import scan_collection as TSC
from nextbestpath_tpu_torch.train.replay import ReplayDB

from test_torch_rollout import JaxDraws, _flax_model

TINY = dict(image_height=32, image_width=56, points_per_frame=256,
            full_pc_capacity=32768, n_gt_surface_points=1024,
            max_path_len=32, pc2img_size=[64, 64], value_map_size=[16, 16])
PAIR_NORMAL_GT = 768
COV_ATOL = 1e-3
GAIN_ATOL = 1e-3
MAX_MOVED_POINTS = 4
BF16_ATOL = 1e-2  # the bf16 U-Net's tolerance (test_torch_unet_bf16.py)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the tier-1 run puts several test processes on
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


class JaxCollectDraws(JaxDraws):
    """The JAX collection's key schedule: one split for the initial
    capture, then an 8-way split a pose, one key a role."""

    ROLES = ("cov", "obs", "bolt", "pick", "u", "rot", "move")

    def begin_pose(self):
        keys = jax.random.split(self.key, 8)
        self.key = keys[0]
        self.roles = dict(zip(self.ROLES, keys[1:]))

    def gumbel(self, role, shape, step=None):
        return torch.from_numpy(np.array(
            jax.random.gumbel(self._key(role, step), tuple(shape))))


def _scene_pair(pkg, cfg):
    """(simple/2 alone, the padded pair simple/2 + normal/3) packed by the
    package ``pkg`` (JAX or the port) with its config module ``cfg``."""
    base = cfg.default_params(**TINY)
    simple = pkg.pack_generated_scene(pkg.generate_scene("simple", seed=2),
                                      params=base)
    normal = pkg.pack_generated_scene(
        pkg.generate_scene("normal", seed=3),
        params=cfg.default_params(**dict(TINY,
                                         n_gt_surface_points=PAIR_NORMAL_GT)))
    return [simple], [simple, normal]


@pytest.fixture(scope="module")
def flax_model():
    return _flax_model()


def _torch_model(variables, dtype=torch.float32):
    m = TorchNBP(dtype=dtype)
    m.load_state_dict(flax_to_state_dict(variables["params"],
                                         variables["batch_stats"]))
    return m.train()


# -- host helpers ------------------------------------------------------------

def test_soa_to_tris_matches():
    tris = np.random.default_rng(0).normal(size=(7, 3, 3)).astype(np.float32)
    want = np.asarray(JSC.soa_to_tris(j_tris_to_soa(jnp.asarray(tris))))
    got = TSC.soa_to_tris(tris_to_soa(torch.from_numpy(tris))).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, tris, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_suffix_labels_from_out_match(seed):
    """Seeded records with three planned segments and an invalid tail."""
    rng = np.random.default_rng(seed)
    P, S = 14, 8
    pose5 = np.zeros((P, 5), np.float32)
    pose5[:, 0] = np.cumsum(rng.integers(-1, 2, P)) * 3.0
    pose5[:, 2] = np.cumsum(rng.integers(-1, 2, P)) * 3.0
    planned = np.zeros(P, bool)
    planned[[0, 4, 9]] = True
    valid = np.arange(P) < 12
    kw = dict(model_input=np.zeros((P, S, S, 5), np.float16),
              gt_obs=np.zeros((P, S, S), bool), pose5=pose5,
              rot=rng.integers(0, 8, P).astype(np.int32),
              coverage=np.sort(rng.uniform(0, 1, P)).astype(np.float32),
              valid=valid, planned=planned)
    got = TSC.suffix_labels_from_out(TSC.CollectOut(**kw), 16, (-24.0, 24.0))
    want = JSC.suffix_labels_from_out(JSC.CollectOut(**kw), 16,
                                      (-24.0, 24.0))
    assert len(got) == len(want) > 0
    for (gi, gp, gg), (wi, wp, wg) in zip(got, want):
        assert gi == wi
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gg, wg)


# -- the padded coverage metric ----------------------------------------------

@pytest.mark.parametrize("count", [0, 700, 5000])
def test_padded_coverage_matches_jax(count):
    """A 900-point GT cloud padded to 1000 (rows at 1e7, gt_valid False)
    against a 6000-slot buffer: the port's metric equals the JAX one on the
    same stride draws, and equals the unpadded cloud's at the same sample
    size (both round up to 2048)."""
    rng = np.random.default_rng(count)
    gt = rng.uniform(-5, 5, (900, 3)).astype(np.float32)
    pad = np.concatenate([gt, np.full((100, 3), 1e7, np.float32)])
    valid = np.arange(1000) < 900
    pts = np.zeros((6000, 3), np.float32)
    pts[:count] = gt[rng.integers(0, 900, count)] + rng.normal(
        0, 0.8, (count, 3)).astype(np.float32)
    key = jax.random.PRNGKey(count + 1)
    want = float(JCov.coverage_percentage(
        jnp.asarray(pad), jnp.asarray(pts), jnp.int32(count), key,
        fast_sampling=True, gt_valid=jnp.asarray(valid)))
    c = max(count, 1)
    start = torch.tensor(int(jax.random.randint(key, (), 0, c)))
    half = torch.tensor(int(jax.random.randint(jax.random.fold_in(key, 1),
                                               (), 1, max(c // 2, 2))))
    t_pts, t_count = torch.from_numpy(pts), torch.tensor(count)
    got = float(TCov.coverage_percentage(
        torch.from_numpy(pad), t_pts, t_count, start, half,
        gt_valid=torch.from_numpy(valid)))
    assert TCov.n_sample_for(1000, 6000) == TCov.n_sample_for(900, 6000)
    unpadded = float(TCov.coverage_percentage(torch.from_numpy(gt), t_pts,
                                              t_count, start, half))
    assert got == want
    assert got == unpadded
    if count:
        assert 0.0 < got < 1.0
    else:
        assert got == want == 0.0


# -- the collection against the JAX one ----------------------------------------

def _run_both(flax_model, which, n_poses=6, seed=5):
    model, variables = flax_model
    j_one, j_pair = _scene_pair(
        __import__("nextbestpath_tpu.assets", fromlist=["x"]),
        __import__("nextbestpath_tpu.config", fromlist=["x"]))
    t_one, t_pair = _scene_pair(TA, TC)
    if which == "pair":
        j_list, t_list, idx = j_pad_common(j_pair), TA.pad_assets_to_common(
            t_pair), 1
        assert len(t_list[0].gt_surface) != len(t_list[1].gt_surface)
    else:
        j_list, t_list, idx = j_one, t_one, 0
    jc = JSC.ScanCollection(j_list, model, params=default_params(**TINY))
    want = jc.run(idx, variables, seed=seed, n_poses=n_poses)
    jdb = JReplayDB()
    want_cov = JSC.collect_trajectory_scan(jc, idx, variables, jdb,
                                           seed=seed, n_poses=n_poses)
    tm = _torch_model(variables)
    stats0 = {k: b.clone() for k, b in tm.named_buffers()}
    tc = TSC.ScanCollection(t_list, tm, params=TC.default_params(**TINY),
                            make_draws=JaxCollectDraws, device="cpu")
    got = tc.run(idx, tm, seed=seed, n_poses=n_poses)
    if which == "pair":
        sc = tc.scene
        assert int(sc.gt_valid.sum()) == PAIR_NORMAL_GT < sc.gt.shape[0]
    tdb = ReplayDB()
    got_cov = TSC.collect_trajectory_scan(tc, idx, tm, tdb, seed=seed,
                                          n_poses=n_poses)
    assert tm.training
    assert all(torch.equal(b, stats0[k]) for k, b in tm.named_buffers())
    return (got, want), (got_cov, want_cov), (tdb, jdb), tc


def _same_records(got, want, n):
    for k in ("pose5", "rot", "valid", "planned", "gt_obs"):
        np.testing.assert_array_equal(getattr(got, k)[:n],
                                      np.asarray(getattr(want, k))[:n],
                                      err_msg=k)
    np.testing.assert_allclose(got.coverage[:n], np.asarray(want.coverage)[:n],
                               atol=COV_ATOL)
    moved = []
    for a, b in zip(got.model_input[:n], np.asarray(want.model_input)[:n]):
        diff = a.astype(np.float32) - b.astype(np.float32)
        moved.append(int(np.abs(diff).sum()))
        assert float(b.astype(np.float32).sum()) > 50
    assert max(moved) <= MAX_MOVED_POINTS * 2, moved
    return moved


@pytest.mark.parametrize("which", ["simple", "pair"])
def test_scan_collection_matches_jax(flax_model, which):
    (got, want), (got_cov, want_cov), (tdb, jdb), tc = _run_both(flax_model,
                                                                 which)
    valid = np.asarray(want.valid)
    n = min(int(valid.sum()) + 1, len(valid))
    _same_records(got, want, n)
    assert got.model_input.dtype == np.float16 and got.gt_obs.dtype == bool
    assert got.planned[0] and got.gt_obs[0].sum() > 10
    assert max(got.coverage[1:n]) > got.coverage[0]
    assert tc.plan_poses == [bool(x) for x in np.asarray(want.planned)[:n]]
    np.testing.assert_allclose(got_cov, want_cov, atol=COV_ATOL)
    assert len(tdb) == len(jdb) >= 2
    for e_t, e_j in zip(tdb.entries, jdb.entries):
        assert e_t.pose_i == e_j.pose_i
        np.testing.assert_array_equal(e_t.gt_layout, e_j.gt_layout)
        np.testing.assert_array_equal(e_t.pixels, e_j.pixels)
        np.testing.assert_allclose(e_t.gains, e_j.gains, atol=GAIN_ATOL)


def test_bf16_plan_value_map_matches_jax(flax_model):
    """The bf16 collection's folded U-Net on its first plan's model input
    against the JAX bf16 folded forward on the same input."""
    _, variables = flax_model
    t_one, _ = _scene_pair(TA, TC)
    tm = _torch_model(variables, torch.bfloat16)
    tc = TSC.ScanCollection(t_one, tm, params=TC.default_params(**TINY),
                            make_draws=JaxCollectDraws, device="cpu")
    tc.run(0, tm, seed=5, n_poses=1)
    assert tc.plan_poses == [True]
    x = tc.model_input
    with torch.no_grad():
        v_t, _ = tc.model(x)
    fm = FlaxNBP(dtype=jnp.bfloat16).clone(fold_bn=True)
    v_j, _ = fm.apply(fold_bn_variables(variables), jnp.asarray(x.numpy()),
                      train=False)
    assert float(x.sum()) > 50
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=BF16_ATOL)


def test_rollout_stops_after_done(monkeypatch):
    """With the coverage stop below any coverage, the first pose ends the
    rollout: it is recorded invalid with its coverage, no later pose runs
    (the JAX scan's frozen poses), and the returned curve is that pose's."""
    monkeypatch.setattr(TSC, "COVERAGE_STOP", -1.0)
    t_one, _ = _scene_pair(TA, TC)
    torch.manual_seed(0)
    tm = TorchNBP(width=8)
    tc = TSC.ScanCollection(t_one, tm, params=TC.default_params(**TINY),
                            device="cpu")
    db = ReplayDB()
    cov = TSC.collect_trajectory_scan(tc, 0, tm, db, seed=1, n_poses=5)
    assert tc.plan_poses == [False] and len(db) == 0
    out = tc.run(0, tm, seed=1, n_poses=5)
    assert not out.valid.any() and not out.planned.any()
    assert cov == [float(out.coverage[0])] and cov[0] > 0.0
    assert not out.pose5[1:].any()


@pytest.mark.slow
def test_scan_collection_matches_jax_full_width(flax_model):
    """simple/8 at ``default_params()`` (256x456 frames, 2M capacity, 256x256
    model input) with the full-width NBP, 3 poses."""
    model, variables = flax_model
    j_assets = pack_generated_scene(generate_scene("simple", seed=8),
                                    params=default_params())
    t_assets = TA.pack_generated_scene(TA.generate_scene("simple", seed=8),
                                       params=TC.default_params())
    jc = JSC.ScanCollection([j_assets], model)
    want = jc.run(0, variables, seed=8, n_poses=3)
    tm = _torch_model(variables)
    tc = TSC.ScanCollection([t_assets], tm, make_draws=JaxCollectDraws,
                            device="cpu")
    got = tc.run(0, tm, seed=8, n_poses=3)
    _same_records(got, want, 3)


def test_run_records_outlive_the_next_run():
    """A run's records are the host's own copy on the CPU too: the next run
    of the collection (another scene) leaves them as they were."""
    _, pair = _scene_pair(TA, TC)
    scenes = TA.pad_assets_to_common(pair)
    tm = TorchNBP(width=8).train()
    tc = TSC.ScanCollection(scenes, tm, params=TC.default_params(**TINY),
                            device="cpu")
    first = tc.run(0, tm, seed=5, n_poses=3)
    kept = [np.array(a, copy=True) for a in first]
    tc.run(1, tm, seed=6, n_poses=3)
    for name, a, b in zip(first._fields, first, kept):
        np.testing.assert_array_equal(a, b, err_msg=name)
