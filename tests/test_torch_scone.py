"""The SCONE modules of the port against the JAX package on the same
seeded inputs: spherical coordinates and harmonics, view states (bin for
bin) and view harmonics, kNN indices (ties to the lower index), the depth
sampling, the attention blocks, SconeOcc and SconeVis at small widths
with seeded flax weights and at full width on the trained
``weights/scone_pre`` checkpoints (read only, by the port's reader and
by the JAX package's), and the visibility and coverage gains.
"""

import os

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextbestpath_tpu.geometry import spherical as JS
from nextbestpath_tpu.geometry.cameras import CameraIntrinsics as JIntr
from nextbestpath_tpu.geometry.cameras import get_camera_RT as j_RT
from nextbestpath_tpu.ops import depth_sample as JD
from nextbestpath_tpu.ops import knn as JK
from nextbestpath_tpu.ops import view_state as JV
from nextbestpath_tpu.utils.checkpoint import load_checkpoint as j_load
from nextbestpath_tpu_torch.geometry import spherical as TS
from nextbestpath_tpu_torch.geometry.cameras import CameraIntrinsics
from nextbestpath_tpu_torch.geometry.cameras import get_camera_RT
from nextbestpath_tpu_torch.models import attention as TAt
from nextbestpath_tpu_torch.models import harmonics as TH
from nextbestpath_tpu_torch.models import scone as TSc
from nextbestpath_tpu_torch.models.convert import (scone_occ_from_flax,
                                                   scone_occ_to_flax,
                                                   scone_vis_from_flax,
                                                   scone_vis_to_flax)
from nextbestpath_tpu_torch.ops import depth_sample as TD
from nextbestpath_tpu_torch.ops import knn as TK
from nextbestpath_tpu_torch.ops import view_state as TV
from nextbestpath_tpu_torch.utils.checkpoint import load_checkpoint

# The JAX package's models/__init__ exports functions under its module
# names (``attention``), so the modules are imported by path.
JA = importlib.import_module("nextbestpath_tpu.models.attention")
JH = importlib.import_module("nextbestpath_tpu.models.harmonics")
JSc = importlib.import_module("nextbestpath_tpu.models.scone")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "weights", "scone_pre", "scone_{}.ckpt")
ATOL = 1e-5
MODEL_ATOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.array(x)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the tier-1 run puts several test processes on
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _dirs(n, seed=0):
    """Random directions with the awkward cases: x < 0, the poles, and
    points on the axes."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3)).astype(np.float32) * 5.0
    x[:6] = [[0, 1, 0], [0, -1, 0], [-1, 0, 0], [0, 0, -1], [1e-7, 3, 0],
             [-2, 0, 1e-6]]
    return x


def test_spherical_coords_match():
    """r to 1e-5, and the angles to 1e-5 where arcsin and arccos are well
    conditioned (|argument| < 0.999). Near +-1 a one-ulp difference of
    the two libraries' asin and cos moves arccos by up to 3e-4 (the
    reference's formula, in either package)."""
    x = _dirs(2000)
    got = TS.get_spherical_coords(_t(x))
    want = [np.array(w) for w in JS.get_spherical_coords(jnp.asarray(x))]
    _close(got[0], want[0])
    r, elev = want[0], want[1]
    sin_e = x[:, 1] / np.maximum(r, 1e-12)
    cos_a = x[:, 2] / np.maximum(r * np.cos(elev), 1e-12)
    ok_e = np.abs(sin_e) < 0.999
    ok_a = ok_e & (np.abs(cos_a) < 0.999)
    assert ok_a.sum() > 1900
    _close(_np(got[1])[ok_e], want[1][ok_e])
    _close(_np(got[2])[ok_a], want[2][ok_a])
    # Where they are not, the angles stay within what one ulp of the
    # argument gives (sqrt(2 * 2^-23) = 4.9e-4), the azimuth's sign equal.
    np.testing.assert_allclose(_np(got[1]), want[1], atol=5e-4, rtol=0)
    np.testing.assert_allclose(_np(got[2]), want[2], atol=5e-4, rtol=0)
    r = np.abs(x[:, 0]) + 1.0
    for deg in (False, True):
        _close(TS.get_cartesian_coords(_t(r), _t(x[:, 1]), _t(x[:, 2]), deg),
               JS.get_cartesian_coords(r, x[:, 1], x[:, 2], deg))
    _close(TS.sample_cameras_on_sphere(16, 2.5),
           JS.sample_cameras_on_sphere(16, 2.5))


def test_harmonics_match():
    """Polar angles with sin(theta) >= 0.05, and the poles and the
    equator exactly: nearer the poles the reference's sqrt(1 - cos^2)
    turns a one-ulp difference of the libraries' cos into up to 4e-5."""
    rng = np.random.default_rng(1)
    theta = rng.uniform(0.05, np.pi - 0.05, (3, 400)).astype(np.float32)
    phi = rng.uniform(-np.pi, np.pi, (3, 400)).astype(np.float32)
    theta[0, :3] = [0.0, np.pi, np.pi / 2]
    for l in (0, 1, 4, 7):
        _close(TH.spherical_harmonics(l, _t(theta), _t(phi)),
               JH.spherical_harmonics(l, theta, phi))
    got = TH.harmonics_up_to_rank(8, _t(theta), _t(phi))
    assert got.shape == (3, 400, 64)
    _close(got, JH.harmonics_up_to_rank(8, theta, phi))
    for got, want in zip(TH.base_view_harmonics(7, 14, 8),
                         JH.base_view_harmonics(7, 14, 8)):
        _close(got, want)


def test_view_states_match():
    """The bins bin for bin, both clamps; the view harmonics within 1e-5;
    the view-space permutation index for index."""
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(2, 600, 4)).astype(np.float32) * 4.0
    cams = rng.normal(size=(5, 3)).astype(np.float32) * 6.0
    cams[0] = pts[0, 0, :3] + [0.0, 9.0, 0.01]  # straight up: the wrap
    rays = _dirs(3000, seed=3)
    for sym in (False, True):
        np.testing.assert_array_equal(
            _np(TV._direction_indices(_t(rays), 7, 14, sym)),
            _np(JV._direction_indices(jnp.asarray(rays), 7, 14, sym)))
    want = np.array(JV.compute_view_state(jnp.asarray(pts),
                                          jnp.asarray(cams)))
    got = TV.compute_view_state(_t(pts), _t(cams))
    np.testing.assert_array_equal(_np(got), want)
    assert 0 < want.sum() < want.size
    base_h, polar = JH.base_view_harmonics()
    t_base, t_polar = TH.base_view_harmonics()
    _close(TV.compute_view_harmonics(got, t_base, t_polar),
           JV.compute_view_harmonics(jnp.asarray(want), base_h, polar))
    poses = rng.uniform(-40, 40, (4, 5)).astype(np.float32)
    for pose in poses:
        R, T = j_RT(jnp.asarray(pose[None, :3]), jnp.asarray(pose[None, 3:]))
        tR, tT = get_camera_RT(_t(pose[None, :3]), _t(pose[None, 3:]))
        np.testing.assert_array_equal(
            _np(TV.view_space_permutation(tR[0], tT[0])),
            np.array(JV.view_space_permutation(R[0], T[0])))
    center, diag = np.float32([1.0, -2.0, 0.5]), np.float32(7.0)
    _close(TV.normalize_points_in_prediction_box(_t(pts[..., :3]),
                                                 _t(center), _t(diag)),
           JV.normalize_points_in_prediction_box(pts[..., :3], center, diag))


def test_knn_indices_match():
    """Exact indices, with repeated points (exact ties) taken lower index
    first, as lax.top_k does."""
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(2, 300, 3)).astype(np.float32)
    pts[:, 100:150] = pts[:, 50:100]          # exact duplicates
    pts[:, 200:210] = pts[:, 7:8]
    q = np.concatenate([pts[:, :40], rng.normal(size=(2, 40, 3))
                        .astype(np.float32)], axis=1)
    for k in (1, 4, 16):
        want = np.array(JK.knn_indices(jnp.asarray(q), jnp.asarray(pts), k))
        got = _np(TK.knn_indices(_t(q), _t(pts), k))
        np.testing.assert_array_equal(got, want)
    nb, idx = TK.knn_points(_t(q), _t(pts), 16)
    j_nb, j_idx = JK.knn_points(jnp.asarray(q), jnp.asarray(pts), 16)
    np.testing.assert_array_equal(_np(idx), np.array(j_idx))
    np.testing.assert_array_equal(_np(nb), np.array(j_nb))


def test_depth_sampling_matches():
    """A smooth depth map and an empty one (every point against 1.1
    zfar), within 1e-4 and 1e-6 of the value (distances reach 850, where
    an f32 ulp is 6e-5). At a depth edge the bilinear weights would turn a
    one-ulp difference of the projection into the edge's height times
    it."""
    rng = np.random.default_rng(5)
    img = rng.uniform(1, 30, (24, 40)).astype(np.float32)
    g = rng.uniform(-1.3, 1.3, (2, 500)).astype(np.float32)
    _close(TD.grid_sample_bilinear(_t(img)[..., None], _t(g[0]),
                                   _t(g[1]))[..., 0],
           JD.grid_sample_bilinear(jnp.asarray(img), g[0], g[1]))
    kw = dict(image_height=24, image_width=40)
    ii, jj = np.meshgrid(np.arange(24), np.arange(40), indexing="ij")
    smooth = (10.0 + 0.3 * ii + 0.2 * jj).astype(np.float32)
    empty = np.full((24, 40), -1.0, np.float32)
    pose = np.float32([[1.0, 2.0, -3.0, 10.0, 40.0]])
    R, T = j_RT(jnp.asarray(pose[:, :3]), jnp.asarray(pose[:, 3:]))
    pts = rng.normal(size=(800, 3)).astype(np.float32) * 15.0
    for zbuf in (smooth, empty):
        want = JD.signed_distance_to_depth(jnp.asarray(pts),
                                           jnp.asarray(zbuf), R[0], T[0],
                                           JIntr(**kw))
        got = TD.signed_distance_to_depth(_t(pts), _t(zbuf), _t(R[0]),
                                          _t(T[0]), CameraIntrinsics(**kw))
        np.testing.assert_allclose(_np(got), np.array(want), atol=1e-4,
                                   rtol=1e-6)


def _port(module, variables):
    """The port's module with a flax tree's weights (by flax's names)."""
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    module.load_state_dict(scone_vis_from_flax(params), strict=True)
    return module.eval()


@pytest.mark.parametrize("n_heads,use_ff,masked", [(1, True, False),
                                                   (4, True, True),
                                                   (2, False, False)])
def test_encoder_matches(n_heads, use_ff, masked):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 20, 32)).astype(np.float32)
    mask = (rng.random((3, 1, 20, 20)) < 0.7).astype(np.float32) \
        if masked else None
    j = JA.Encoder(32, 16, n_heads=n_heads, use_ff=use_ff)
    v = j.init(jax.random.PRNGKey(0), x, mask=mask)
    want = j.apply(v, x, mask=mask)
    t = _port(TAt.Encoder(32, 16, n_heads=n_heads, use_ff=use_ff), v)
    with torch.no_grad():
        got = t(_t(x), mask=None if mask is None else _t(mask))
    _close(got, want, MODEL_ATOL)


@pytest.mark.parametrize("kw", [dict(), dict(global_feature=True),
                                dict(additional_feature_dim=5),
                                dict(concatenate_input=False, gelu=False),
                                dict(k_for_knn=4, global_feature=True)])
def test_embedding_matches(kw):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 30, 4)).astype(np.float32)
    extra = rng.normal(size=(2, 30, 5)).astype(np.float32)
    add = extra if kw.get("additional_feature_dim") else None
    j = JA.Embedding(4, 40, **kw)
    v = j.init(jax.random.PRNGKey(1), x, additional_feature=add)
    want = j.apply(v, x, additional_feature=add)
    t = _port(TAt.Embedding(4, 40, **kw), v)
    with torch.no_grad():
        got = t(_t(x), None if add is None else _t(add))
    assert got.shape == want.shape
    _close(got, want, MODEL_ATOL)


class _JaxPerms:
    """SconeOcc's permutations from one JAX key, as its forward splits it."""

    def __init__(self, key):
        self.k_global, self.k_ds = jax.random.split(key)

    def permutation(self, role, n, step=None):
        k = (self.k_global if step is None
             else jax.random.fold_in(self.k_ds, step))
        return _t(jax.random.permutation(k, n)).long()


OCC_SMALL = dict(seq_len=96, n_scale=3, k_for_knn=4, pts_embedding_dim=32,
                 global_feature_dim=64, local_feature_dim=32,
                 x_embedding_dim=64)


def _occ_inputs(n_pc, n_x, seed):
    rng = np.random.default_rng(seed)
    pc = rng.normal(size=(2, n_pc, 3)).astype(np.float32) * 0.3
    pc[:, n_pc // 2:n_pc // 2 + 8] = pc[:, :8]  # duplicated tokens
    x = rng.normal(size=(2, n_x, 3)).astype(np.float32) * 0.3
    vh = rng.normal(size=(2, n_x, 64)).astype(np.float32) * 0.1
    return pc, x, vh


def test_scone_occ_small_matches():
    """Two clouds, a downsample below N and three scales, JAX's key's
    permutations injected."""
    pc, x, vh = _occ_inputs(128, 40, 8)
    j = JSc.SconeOcc(**OCC_SMALL)
    key = jax.random.PRNGKey(3)
    v = j.init(jax.random.PRNGKey(0), pc, x, vh, key=key)
    want = j.apply(v, pc, x, vh, key=key)
    t = TSc.SconeOcc(**OCC_SMALL)
    t.load_state_dict(scone_occ_from_flax(
        jax.tree_util.tree_map(np.asarray, v["params"])))
    assert t.ds_factor(128) == 2
    with torch.no_grad():
        got = t.eval()(_t(pc), _t(x), _t(vh), draws=_JaxPerms(key))
    assert got.shape == (2, 40, 1)
    _close(got, want, MODEL_ATOL)


def test_scone_vis_small_matches():
    rng = np.random.default_rng(9)
    pts = rng.normal(size=(3, 50, 4)).astype(np.float32)
    vh = rng.normal(size=(3, 50, 64)).astype(np.float32) * 0.1
    for kw in (dict(pts_embedding_dim=64),
               dict(pts_embedding_dim=128, n_code=1, view_state_mode="start",
                    use_global_feature=False)):
        j = JSc.SconeVis(**kw)
        v = j.init(jax.random.PRNGKey(2), pts, view_harmonics=vh)
        want = j.apply(v, pts, view_harmonics=vh)
        t = _port(TSc.SconeVis(**kw), v)
        with torch.no_grad():
            got = t(_t(pts), view_harmonics=_t(vh))
        _close(got, want, MODEL_ATOL)


@pytest.fixture(scope="module")
def trained():
    """The trained checkpoints, read by both packages' readers."""
    out = {}
    pc, x, vh = _occ_inputs(256, 48, 10)
    occ_tmpl = JSc.SconeOcc().init(jax.random.PRNGKey(0), pc[:1], x[:1],
                                   vh[:1], key=jax.random.PRNGKey(0))
    vis_tmpl = JSc.SconeVis().init(jax.random.PRNGKey(0),
                                   jnp.zeros((1, 8, 4)),
                                   view_harmonics=jnp.zeros((1, 8, 64)))
    for name, tmpl in (("occ", occ_tmpl), ("vis", vis_tmpl)):
        path = CKPT.format(name)
        out[name] = (j_load(path, tmpl)[0], load_checkpoint(path)[0])
    return out


def test_trained_scone_occ_matches(trained):
    """The published widths on the trained weights: 2,257,769 parameters,
    256 point-cloud tokens and 48 queries."""
    j_vars, t_vars = trained["occ"]
    pc, x, vh = _occ_inputs(256, 48, 10)
    key = jax.random.PRNGKey(4)
    want = JSc.SconeOcc().apply(j_vars, pc, x, vh, key=key)
    t = TSc.SconeOcc()
    t.load_state_dict(scone_occ_from_flax(t_vars), strict=True)
    assert sum(p.numel() for p in t.parameters()) == 2257769
    with torch.no_grad():
        got = t.eval()(_t(pc), _t(x), _t(vh), draws=_JaxPerms(key))
    _close(got, want, MODEL_ATOL)


def test_trained_scone_vis_matches(trained):
    j_vars, t_vars = trained["vis"]
    rng = np.random.default_rng(11)
    pts = rng.normal(size=(2, 96, 4)).astype(np.float32) * 0.3
    vh = rng.normal(size=(2, 96, 64)).astype(np.float32) * 0.1
    want = JSc.SconeVis().apply(j_vars, pts, view_harmonics=vh)
    t = TSc.SconeVis()
    t.load_state_dict(scone_vis_from_flax(t_vars), strict=True)
    assert sum(p.numel() for p in t.parameters()) == 1392888
    with torch.no_grad():
        got = t.eval()(_t(pts), view_harmonics=_t(vh))
    _close(got, want, MODEL_ATOL)
    cams = rng.normal(size=(2, 5, 3)).astype(np.float32)
    _close(TSc.coverage_gain(_t(pts[..., :3]), got, _t(cams)),
           JSc.coverage_gain(pts[..., :3], want, cams), MODEL_ATOL)


@pytest.mark.parametrize("name", ["occ", "vis"])
def test_converters_round_trip(trained, name):
    """flax tree -> state_dict -> flax tree gives the tree back."""
    _, t_vars = trained[name]
    fwd, back = ((scone_occ_from_flax, scone_occ_to_flax) if name == "occ"
                 else (scone_vis_from_flax, scone_vis_to_flax))
    tree = back(fwd(t_vars))
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(t_vars["params"])
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_visibility_and_coverage_gains_match():
    rng = np.random.default_rng(12)
    pts = rng.normal(size=(2, 70, 3)).astype(np.float32)
    harm = rng.normal(size=(2, 70, 64)).astype(np.float32) * 0.3
    cams = rng.normal(size=(2, 6, 3)).astype(np.float32) * 3.0
    fov = rng.random((2, 6, 70)) < 0.6
    # The rays' azimuths carry the arccos conditioning of
    # test_spherical_coords_match into the harmonics: the models' 1e-4.
    for sig in (True, False):
        _close(TSc.visibility_gains(_t(pts), _t(harm), _t(cams),
                                    use_sigmoid=sig),
               JSc.visibility_gains(pts, harm, cams, use_sigmoid=sig),
               MODEL_ATOL)
    _close(TSc.coverage_gain(_t(pts), _t(harm), _t(cams),
                             fov_mask=_t(fov)),
           JSc.coverage_gain(pts, harm, cams, fov_mask=jnp.asarray(fov)),
           MODEL_ATOL)
