"""The port's training collection (``train/collection.py``) and its
planning pieces against the JAX package, with the JAX key stream injected
(``JaxCollectionDraws``: the legacy rollout's sequential stream plus the
Boltzmann pick's Gumbel noise).

``collect_trajectory`` runs simple/4 for 6 poses at the small config of
``tests/test_training_smoke.py`` with ``NBP(width=8)`` at the 256x256
model input: the coverage curve within 1e-3, the same experiences (GT
layouts, label pixels, pose indices, and model inputs up to
``MAX_MOVED_POINTS`` cloud points that f32 rounding puts one pixel over)
and gains within 0.2 (a gain is 100 x a difference of two coverages).
Scores and the label mining are exact; the Boltzmann pick takes the same
index.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextbestpath_tpu.assets import generate_scene, pack_generated_scene
from nextbestpath_tpu.config import default_params
from nextbestpath_tpu.models import NBP as FlaxNBP
from nextbestpath_tpu.planning import candidates as JC
from nextbestpath_tpu.train import collection as JCol
from nextbestpath_tpu.train.replay import ReplayDB as JReplayDB
from nextbestpath_tpu_torch import assets as TA
from nextbestpath_tpu_torch import config as TC
from nextbestpath_tpu_torch.models.convert import flax_to_state_dict
from nextbestpath_tpu_torch.models.unet import NBP
from nextbestpath_tpu_torch.planning import candidates as TCand
from nextbestpath_tpu_torch.train import collection as TCol
from nextbestpath_tpu_torch.train.replay import ReplayDB

from test_torch_legacy_rollout import JaxSequentialDraws

SMOKE = dict(image_height=32, image_width=56, points_per_frame=256,
             full_pc_capacity=32768, n_gt_surface_points=1024,
             max_path_len=32)
COV_ATOL = 1e-3
GAIN_ATOL = 0.2
MAX_MOVED_POINTS = 4  # model-input points a pixel over, per experience


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the tier-1 run puts several test processes on
    the machine's cores, where PyTorch's default (one thread a core) makes
    each small operation wait on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


class JaxCollectionDraws(JaxSequentialDraws):
    """The JAX collection's key stream: the legacy rollout's, with the
    Boltzmann pick's noise as ``jax.random.categorical`` draws it."""

    def gumbel(self, role, shape, step=None):
        return torch.from_numpy(np.array(
            jax.random.gumbel(self._key(step), tuple(shape))))


def test_collect_trajectory_matches_jax():
    j_assets = pack_generated_scene(generate_scene("simple", seed=4),
                                    params=default_params(**SMOKE))
    t_assets = TA.pack_generated_scene(TA.generate_scene("simple", seed=4),
                                       params=TC.default_params(**SMOKE))
    fm = FlaxNBP(width=8)
    v = jax.jit(lambda k, x: fm.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 5)))
    v = jax.tree_util.tree_map(np.asarray, v)
    jdb = JReplayDB()
    want = JCol.collect_trajectory(j_assets, fm, v, jdb,
                                   params=default_params(**SMOKE), seed=3,
                                   n_poses=6)
    model = NBP(width=8)
    model.load_state_dict(flax_to_state_dict(v["params"], v["batch_stats"]))
    model.train()
    stats0 = {k: b.clone() for k, b in model.named_buffers()}
    draws = JaxCollectionDraws(3)
    tdb = ReplayDB()
    got = TCol.collect_trajectory(t_assets, model, tdb,
                                  params=TC.default_params(**SMOKE),
                                  draws=draws, n_poses=6, device="cpu")
    assert len(got) == len(want) == 6
    np.testing.assert_allclose(got, want, atol=COV_ATOL)
    assert max(got[1:]) > got[0]
    # The model comes back in train mode with its running stats untouched.
    assert model.training
    assert all(torch.equal(b, stats0[k]) for k, b in model.named_buffers())
    # Groups: init, then cov and obs a pose, goal and plan on a plan, rot
    # (and rot again when the override is taken), move.
    g = draws.groups
    assert g[:5] == ["init", "cov", "obs", "goal", "plan"]
    assert g.count("cov") == g.count("move") == 6
    assert len(tdb) == len(jdb) >= 3
    for e_t, e_j in zip(tdb.entries, jdb.entries):
        assert e_t.model_input.dtype == np.float16
        # The model input counts cloud points a pixel; a point within
        # f32 rounding of a pixel's edge may land one pixel over.
        diff = e_t.model_input.astype(np.float32) - e_j.model_input
        assert np.count_nonzero(diff) <= MAX_MOVED_POINTS * 2
        assert np.abs(diff).sum() <= MAX_MOVED_POINTS * 2
        assert float(e_j.model_input.astype(np.float32).sum()) > 100
        np.testing.assert_array_equal(e_t.gt_layout, e_j.gt_layout)
        np.testing.assert_array_equal(e_t.pixels, e_j.pixels)
        np.testing.assert_allclose(e_t.gains, e_j.gains, atol=GAIN_ATOL)
        assert e_t.pose_i == e_j.pose_i
    assert any(e.gt_layout.sum() > 0 for e in tdb.entries)


def test_suffix_labels_match():
    """Label mining on host values, with positions that land exactly on a
    half pixel (Python's round, half to even, decides them)."""
    rng = np.random.default_rng(2)
    exps = []
    for i in range(9):
        pose = np.array([20.0 + 1.25 * rng.integers(-4, 5) + 0.625 * (i % 2),
                         1.5, 20.0 + 1.25 * rng.integers(-4, 5), 0.0, 45.0],
                        np.float32)
        if i == 4:
            pose[0] += 50.0  # outside every other pose's value map
        exps.append(dict(coverage=0.1 * i - 0.05 * (i == 3), model_input=None,
                         gt_obs=None, cam_pose5=pose, rot=i % 8, pose_i=i))
    for vms, grid in ((64, (-40.0, 40.0)), (16, (-40.0, 40.0)),
                      (16, (-10.0, 10.0))):
        got = TCol._suffix_labels(exps, vms, grid)
        want = JCol._suffix_labels(exps, vms, grid)
        assert [g[0]["pose_i"] for g in got] == [w[0]["pose_i"] for w in want]
        for (_, px_t, gn_t), (_, px_j, gn_j) in zip(got, want):
            np.testing.assert_array_equal(px_t, px_j)
            np.testing.assert_array_equal(gn_t, gn_j)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_training_scores_and_boltzmann_pick_match(seed):
    rng = np.random.default_rng(seed)
    L, H = 9, 11
    positions = np.zeros((L, H, 3), np.float32)
    positions[..., 0] = (np.arange(L)[:, None] * 6.0 - 20.0)
    positions[..., 2] = (np.arange(H)[None, :] * 6.0 - 30.0)
    positions[..., 1] = 1.5
    cam = np.array([3.0, 1.5, -4.0], np.float32)
    vm = rng.standard_normal((64, 64, 8)).astype(np.float32)
    cur = (int(rng.integers(L)), int(rng.integers(H)))
    want = np.asarray(JC.score_candidates_train(
        jnp.asarray(positions), jnp.asarray(cam), jnp.asarray(vm),
        jnp.asarray(cur)))
    got = TCand.score_candidates_train(
        torch.from_numpy(positions), torch.from_numpy(cam),
        torch.from_numpy(vm), cur).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got <= -1e29).sum() >= 1 and (got > -1e29).sum() > 10
    for k in range(5):
        key = jax.random.PRNGKey(100 * seed + k)
        j_first = int(JC.boltzmann_first(jnp.asarray(want), key, beta=0.5))
        noise = torch.from_numpy(np.array(jax.random.gumbel(key, (L * H,))))
        t_first = int(TCand.boltzmann_first(torch.from_numpy(got), noise,
                                            beta=0.5))
        assert t_first == j_first
        assert got.reshape(-1)[t_first] > -1e29


def test_torch_draws_gumbel_is_standard_gumbel():
    from nextbestpath_tpu_torch.draws import TorchDraws

    g = TorchDraws(0, torch.device("cpu")).gumbel("goal", (200000,))
    assert torch.isfinite(g).all()
    # Standard Gumbel: mean = Euler's gamma, variance = pi^2 / 6.
    assert abs(float(g.mean()) - 0.5772) < 0.01
    assert abs(float(g.var()) - np.pi ** 2 / 6) < 0.03


@pytest.mark.slow
def test_collect_trajectory_matches_jax_full_width():
    """The main path's scene at ``default_params()`` (256x456 frames, 2M
    capacity, 20,000 GT points) with the full-width NBP, 3 poses: the same
    coverage, labels and layouts as the JAX collection."""
    j_assets = pack_generated_scene(generate_scene("simple", seed=8),
                                    params=default_params())
    t_assets = TA.pack_generated_scene(TA.generate_scene("simple", seed=8),
                                       params=TC.default_params())
    fm = FlaxNBP()
    v = jax.jit(lambda k, x: fm.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 5)))
    v = jax.tree_util.tree_map(np.asarray, v)
    jdb, tdb = JReplayDB(), ReplayDB()
    want = JCol.collect_trajectory(j_assets, fm, v, jdb, seed=8, n_poses=3)
    model = NBP()
    model.load_state_dict(flax_to_state_dict(v["params"], v["batch_stats"]))
    got = TCol.collect_trajectory(t_assets, model, tdb,
                                  draws=JaxCollectionDraws(8), n_poses=3,
                                  device="cpu")
    np.testing.assert_allclose(got, want, atol=COV_ATOL)
    assert len(tdb) == len(jdb) >= 1
    for e_t, e_j in zip(tdb.entries, jdb.entries):
        np.testing.assert_array_equal(e_t.gt_layout, e_j.gt_layout)
        np.testing.assert_array_equal(e_t.pixels, e_j.pixels)
        np.testing.assert_allclose(e_t.gains, e_j.gains, atol=GAIN_ATOL)
        diff = e_t.model_input.astype(np.float32) - e_j.model_input
        assert np.abs(diff).sum() <= MAX_MOVED_POINTS * 2
