"""The MACARONS next-best-view path of the port against the JAX package:
the proxy field's carving, the predicted coverage gain with JAX's Gumbel
noise injected, the greedy NBV rollout in its learned and oracle modes with
JAX's sequential key stream injected (``JaxNBVDraws``), and the
object-level NBV, which draws only from numpy's generator.

The rollouts run on the small config of the JAX package's own NBV tests
(32x56 frames, 1,024 proxy points) with small seeded SCONE models: the
same candidate picks and trajectory, coverage within 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextbestpath_tpu.assets import generate_scene, pack_generated_scene
from nextbestpath_tpu.assets.objects import generate_object
from nextbestpath_tpu.config import default_params
from nextbestpath_tpu.eval import macarons_nbv as JN
from nextbestpath_tpu.eval import object_nbv as JO
from nextbestpath_tpu.geometry.cameras import CameraIntrinsics as JIntr
from nextbestpath_tpu.geometry.cameras import get_camera_RT as j_RT
from nextbestpath_tpu.models import SconeOcc as JSconeOcc
from nextbestpath_tpu.models import SconeVis as JSconeVis
from nextbestpath_tpu.models.harmonics import base_view_harmonics as j_base_h
from nextbestpath_tpu.ops.raytrace import render_depth, tris_to_soa
from nextbestpath_tpu.ops.view_state import compute_view_harmonics as j_vh
from nextbestpath_tpu.sim import coverage_gain as JCG
from nextbestpath_tpu.sim.proxy import ProxyField as JProxy
from nextbestpath_tpu.sim.proxy import camera_collides as j_collides
from nextbestpath_tpu.sim.proxy import carve_with_frame as j_carve
from nextbestpath_tpu_torch import assets as TA
from nextbestpath_tpu_torch import config as TC
from nextbestpath_tpu_torch.assets.objects import \
    generate_object as t_generate_object
from nextbestpath_tpu_torch.eval import macarons_nbv as TN
from nextbestpath_tpu_torch.eval.object_nbv import object_nbv_rollout
from nextbestpath_tpu_torch.geometry.cameras import CameraIntrinsics
from nextbestpath_tpu_torch.models.convert import (scone_occ_from_flax,
                                                   scone_vis_from_flax)
from nextbestpath_tpu_torch.models.scone import SconeOcc, SconeVis
from nextbestpath_tpu_torch.sim.coverage_gain import (predict_coverage_gain,
                                                      sample_proxy_points)
from nextbestpath_tpu_torch.sim.proxy import (ProxyField, camera_collides,
                                              carve_with_frame)

COV_ATOL = 1e-3
SMALL = TN.NBV_SMALL
OCC_SMALL = TN.SCONE_OCC_SMALL
VIS_SMALL = TN.SCONE_VIS_SMALL


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the tier-1 run puts several test processes on
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


class JaxNBVDraws:
    """The JAX NBV rollout's key stream: ``begin_group`` takes the next
    key as its ``next_key()`` does; a substep folds its index in;
    ``uniforms`` and ``gumbels`` split the key once a shape (the oracle's
    and the gain's C-way splits); ``permutation`` serves SconeOcc's split
    of its key (the global permutation from the first half, scale s's
    from ``fold_in`` of the second)."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)
        self.cur = None
        self.groups = []

    def begin_group(self, role):
        self.key, self.cur = jax.random.split(self.key)
        self.groups.append(role)

    def _key(self, step):
        return self.cur if step is None else jax.random.fold_in(self.cur, step)

    def uniform(self, role, shape, step=None):
        return _t(jax.random.uniform(self._key(step), tuple(shape)))

    def uniforms(self, role, shapes, step=None):
        keys = jax.random.split(self._key(step), len(shapes))
        return [_t(jax.random.uniform(k, tuple(s)))
                for k, s in zip(keys, shapes)]

    def gumbels(self, role, shapes, step=None):
        keys = jax.random.split(self._key(step), len(shapes))
        return [_t(jax.random.gumbel(k, tuple(s)))
                for k, s in zip(keys, shapes)]

    def randint(self, role, low, high, step=None, shape=()):
        return _t(jax.random.randint(self._key(step), tuple(shape), int(low),
                                     int(high))).long()

    def permutation(self, role, n, step=None):
        k_global, k_ds = jax.random.split(self.cur)
        k = k_global if step is None else jax.random.fold_in(k_ds, step)
        return _t(jax.random.permutation(k, n)).long()


@pytest.fixture(scope="module")
def models():
    """Small seeded flax SCONE models (the JAX package's NBV tests') and
    the port's, loaded through the converters."""
    occ = JSconeOcc(**OCC_SMALL)
    occ_vars = occ.init(jax.random.PRNGKey(0), jnp.zeros((1, 128, 3)),
                        jnp.zeros((1, 64, 3)), jnp.zeros((1, 64, 64)),
                        key=jax.random.PRNGKey(1))
    vis = JSconeVis(**VIS_SMALL)
    vis_vars = vis.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 4)),
                        view_harmonics=jnp.zeros((1, 64, 64)))
    t_occ = SconeOcc(**OCC_SMALL)
    t_occ.load_state_dict(scone_occ_from_flax(
        jax.tree_util.tree_map(np.asarray, occ_vars["params"])))
    t_vis = SconeVis(**VIS_SMALL)
    t_vis.load_state_dict(scone_vis_from_flax(
        jax.tree_util.tree_map(np.asarray, vis_vars["params"])))
    return occ, occ_vars, vis, vis_vars, t_occ.eval(), t_vis.eval()


@pytest.fixture(scope="module")
def scenes():
    j = pack_generated_scene(generate_scene("simple", seed=6),
                             params=default_params(**SMALL))
    t = TA.pack_generated_scene(TA.generate_scene("simple", seed=6),
                                params=TC.default_params(**SMALL))
    return j, t


def _intr():
    kw = dict(image_height=32, image_width=56)
    return JIntr(**kw), CameraIntrinsics(**kw)


def _frames(j_assets):
    """Two depth frames of the scene (the JAX renderer) with their poses."""
    j_intr, _ = _intr()
    soa = tris_to_soa(jnp.asarray(j_assets.tris))
    pos = np.asarray(j_assets.settings.camera.x_min
                     + j_assets.settings.camera.x_max) / 2.0
    out = []
    for azim in (30.0, 120.0):
        pose = jnp.asarray([pos[0], pos[1], pos[2], 0.0, azim], jnp.float32)
        R, T = j_RT(pose[None, :3], pose[None, 3:])
        zbuf = render_depth(soa, j_assets.n_tris, R[0], T[0], j_intr)
        out.append((np.array(zbuf), np.array(R[0]), np.array(T[0]),
                    np.array(pose)))
    return out


def _proxies(j_assets, n=1024):
    u = np.random.default_rng(3).random((n, 3), dtype=np.float32)
    lo = np.asarray(j_assets.settings.scene.x_min - 0.2, np.float32)
    hi = np.asarray(j_assets.settings.scene.x_max + 0.2, np.float32)
    return u, lo, hi


def _j_proxy(u, lo, hi):
    # JProxy.create draws its own points; the fields take the injected
    # ones (the same formula).
    j = JProxy.create(jax.random.PRNGKey(0), lo, hi, u.shape[0])
    pts = jnp.asarray(lo) + (jnp.asarray(hi) - jnp.asarray(lo)) * jnp.asarray(u)
    return j._replace(points=pts)


def test_proxy_create_matches_jax(scenes):
    j_assets, _ = scenes
    u, lo, hi = _proxies(j_assets)
    key = jax.random.PRNGKey(5)
    j = JProxy.create(key, lo, hi, u.shape[0])
    t = ProxyField.create(_t(jax.random.uniform(key, (u.shape[0], 3))),
                          _t(lo), _t(hi))
    np.testing.assert_array_equal(t.points.numpy(), np.array(j.points))
    np.testing.assert_allclose(float(t.distance_between_points),
                               float(j.distance_between_points), rtol=1e-6)
    for name in ("proba", "supervision_occ", "view_states", "n_inside_fov",
                 "n_behind_depth", "out_of_field"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.array(getattr(j, name)))


def test_carve_with_frame_matches_jax(scenes):
    """Two frames carved in turn: the counts and flags equal, the view
    states equal bin for bin; then the collision test on the result."""
    j_assets, _ = scenes
    j_intr, t_intr = _intr()
    u, lo, hi = _proxies(j_assets)
    j = _j_proxy(u, lo, hi)
    t = ProxyField.create(_t(u), _t(lo), _t(hi))
    for zbuf, R, T, pose in _frames(j_assets):
        j = j_carve(j, jnp.asarray(zbuf), jnp.asarray(R), jnp.asarray(T),
                    jnp.asarray(pose[:3]), j_intr)
        t = carve_with_frame(t, _t(zbuf), _t(R), _t(T), _t(pose[:3]), t_intr)
    for name in ("supervision_occ", "n_inside_fov", "n_behind_depth",
                 "out_of_field", "view_states"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.array(getattr(j, name)), err_msg=name)
    assert 0 < float(t.n_inside_fov.sum()) < t.points.shape[0] * 2
    assert float(t.view_states.sum()) > 0
    pos = _frames(j_assets)[0][3][:3]
    for dx in (0.0, 2.0, 8.0):
        x_to = pos + np.asarray([dx, 0.0, 0.0], np.float32)
        for oof in (False, True):
            want = bool(j_collides(j, jnp.asarray(pos), jnp.asarray(x_to),
                                   jnp.asarray(lo), jnp.asarray(hi),
                                   oof_collides=oof))
            got = bool(camera_collides(t, _t(pos), _t(x_to), _t(lo), _t(hi),
                                       oof_collides=oof))
            assert got == want


def test_predict_coverage_gain_matches_jax(scenes, models):
    """20 candidates batched through one SconeVis call against the JAX
    vmap, with its C-way key split's Gumbel noise injected; the token
    sample alone equals JAX's categorical draw."""
    _, _, vis, vis_vars, _, t_vis = models
    j_assets, t_assets = scenes
    j_intr, t_intr = _intr()
    u, lo, hi = _proxies(j_assets)
    j = _j_proxy(u, lo, hi)
    t = ProxyField.create(_t(u), _t(lo), _t(hi))
    for zbuf, R, T, pose in _frames(j_assets):
        j = j_carve(j, jnp.asarray(zbuf), jnp.asarray(R), jnp.asarray(T),
                    jnp.asarray(pose[:3]), j_intr)
        t = carve_with_frame(t, _t(zbuf), _t(R), _t(T), _t(pose[:3]), t_intr)
    proba = np.random.default_rng(1).random((u.shape[0], 1), dtype=np.float32)
    j = j._replace(proba=jnp.asarray(proba))
    base_h, h_polar = j_base_h(7, 14, 8)
    vh = np.array(j_vh(j.view_states[None], base_h, h_polar)[0])
    pos = _frames(j_assets)[0][3][:3]
    cand = np.stack([np.concatenate([pos + np.asarray([dx, 0.0, dz]),
                                     [0.0, az]])
                     for dx, dz in ((0, 0), (3, 0), (0, 3), (500, 0))
                     for az in (0.0, 45.0, 90.0, 180.0, 270.0)]
                    ).astype(np.float32)
    key = jax.random.PRNGKey(11)
    seq_len = 64
    want = np.array(JCG.predict_coverage_gain(
        key, vis, vis_vars, j.points, j.proba, jnp.asarray(vh),
        jnp.asarray(cand), j_intr, jnp.asarray(lo), jnp.asarray(hi),
        seq_len=seq_len))
    keys = jax.random.split(key, cand.shape[0])
    P = u.shape[0]
    noise = [_t(jax.random.gumbel(k, (seq_len, P))) for k in keys]
    got = predict_coverage_gain(noise, t_vis, t.points, _t(proba), _t(vh),
                                _t(cand), t_intr, _t(lo), _t(hi)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)
    # The candidates out of range see no proxy point.
    assert (want > 0).sum() >= 10 and (want[15:] == -1.0).all()
    # One candidate's token sample is JAX's categorical draw.
    mask = np.zeros(P, bool)
    mask[::3] = True
    j_idx = np.array(JCG.sample_proxy_points(
        keys[2], j.points, jnp.asarray(proba), jnp.asarray(mask), seq_len))
    t_idx = sample_proxy_points(noise[2], _t(proba), _t(mask)).numpy()
    np.testing.assert_array_equal(t_idx, j_idx)


def test_proba_write_takes_the_last_duplicate():
    proba = torch.zeros(6, 1)
    idx = torch.tensor([1, 4, 1, 2, 4, 4])
    vals = torch.arange(6, dtype=torch.float32)[:, None]
    TN._write_last(proba, idx, vals)
    assert proba[:, 0].tolist() == [0.0, 2.0, 3.0, 0.0, 5.0, 0.0]


def _same(got, want):
    assert len(got.coverage_evolution) == len(want.coverage_evolution)
    np.testing.assert_allclose(got.coverage_evolution,
                               want.coverage_evolution, atol=COV_ATOL)
    assert got.n_points == want.n_points
    assert got.cam_positions.shape == want.cam_positions.shape
    np.testing.assert_allclose(got.cam_positions, want.cam_positions,
                               atol=1e-5)


def test_macarons_nbv_rollout_matches_jax(scenes, models):
    """The learned greedy NBV, 3 poses: the same picks, trajectory and
    point count, coverage within 1e-3; the groups in the JAX order."""
    occ, occ_vars, vis, vis_vars, t_occ, t_vis = models
    j_assets, t_assets = scenes
    kw = dict(n_poses=3, seed=1, **TN.NBV_SMALL_TOKENS)
    want = JN.macarons_nbv_rollout(j_assets, occ, occ_vars, vis, vis_vars,
                                   params=default_params(**SMALL), **kw)
    draws = JaxNBVDraws(1)
    got = TN.macarons_nbv_rollout(t_assets, t_occ, t_vis,
                                  params=TC.default_params(**SMALL),
                                  draws=draws, device="cpu", **kw)
    _same(got, want)
    pose = ["cov", "tokens", "vs_idx", "occ", "gain", "move"]
    assert draws.groups == ["proxy", "init"] + pose * 3
    assert got.coverage_evolution[-1] > got.coverage_evolution[0] > 0.0


def test_macarons_nbv_oracle_matches_jax(scenes):
    """The oracle mode, 3 poses: the GT gains pick the same candidates."""
    j_assets, t_assets = scenes
    kw = dict(n_poses=3, seed=1, oracle=True)
    want = JN.macarons_nbv_rollout(j_assets, None, None, None, None,
                                   params=default_params(**SMALL), **kw)
    draws = JaxNBVDraws(1)
    got = TN.macarons_nbv_rollout(t_assets, None, None,
                                  params=TC.default_params(**SMALL),
                                  draws=draws, device="cpu", **kw)
    _same(got, want)
    assert draws.groups == ["proxy", "init"] + ["cov", "oracle", "move"] * 3
    assert got.coverage_evolution[-1] >= got.coverage_evolution[0] > 0.0


def test_macarons_nbv_default_draws_repeat(scenes, models):
    """The default provider: one seed gives one rollout."""
    *_, t_occ, t_vis = models
    _, t_assets = scenes
    runs = [TN.macarons_nbv_rollout(
        t_assets, t_occ, t_vis, params=TC.default_params(**SMALL), n_poses=2,
        seed=3, n_tokens=64, n_proxy_tokens=32, device="cpu")
        for _ in range(2)]
    assert runs[0].coverage_evolution == runs[1].coverage_evolution
    np.testing.assert_array_equal(runs[0].cam_positions,
                                  runs[1].cam_positions)


def test_object_nbv_matches_jax(models, monkeypatch):
    """The object NBV: the same curve and the same chosen views (JAX's
    read from the cameras its visible_mask is called with)."""
    _, _, vis, vis_vars, _, t_vis = models
    j_obj = generate_object(seed=6, n_gt_surface_points=512)
    t_obj = t_generate_object(seed=6, n_gt_surface_points=512)
    np.testing.assert_array_equal(t_obj.gt_surface, j_obj.gt_surface)
    seen = []
    real = JO.visible_mask

    def spy(surface, cam, tri_soa, n_tris):
        seen.append(np.asarray(cam))
        return real(surface, cam, tri_soa, n_tris)

    monkeypatch.setattr(JO, "visible_mask", spy)
    kw = dict(n_views=4, n_candidates=8, n_tokens=64, seed=0)
    want = JO.object_nbv_rollout(j_obj, vis, vis_vars, **kw)
    got, chosen = object_nbv_rollout(t_obj, t_vis, device="cpu",
                                     return_views=True, **kw)
    np.testing.assert_allclose(got, want, atol=1e-7)
    rng = np.random.default_rng(0)
    rng.permutation(len(t_obj.gt_surface))
    lo, hi = t_obj.x_min, t_obj.x_max
    from nextbestpath_tpu_torch.assets.objects import cameras_on_sphere
    cands = cameras_on_sphere(8, 0.7 * float(np.linalg.norm(hi - lo)),
                              (lo + hi) / 2.0, rng)
    np.testing.assert_array_equal(np.stack(seen), cands[chosen])
    assert len(set(chosen)) == 4 and got[-1] >= got[0] > 0.1
    # More views than candidates: the curve saturates.
    sat = object_nbv_rollout(t_obj, t_vis, n_views=6, n_candidates=4,
                             n_tokens=64, seed=0, device="cpu")
    assert len(sat) == 6 and sat[-1] == sat[-2]
