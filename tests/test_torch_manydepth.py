"""The depth side of the MACARONS trainer in the port against the JAX
package, on the same inputs (numpy seeds) and the same weights: the
RGB-D shader on K1's triangle index, the ResNet blocks (flax's SAME
padding at even and odd sides, the unpadded stride-2 shortcut), the
expansion layer (flax's stride-1 ``ConvTranspose`` and the half-pixel
nearest resize), ManyDepth with its 96-plane cost volume (seeded, and on
the trained ``weights/depth_pre`` checkpoint) and its ``learn_pose``
branch, the depth losses and augmentations with the JAX draws, the
converter both ways, the bundle, and the online depth step's gradient
and Adam update in f64.

Tolerances, and why: the shader's depth and triangle index equal, its
colour within 1e-6; the modules and the network in f32 within 1e-5 of
the output's scale (sums in another order; the trained checkpoint's
network within 2e-5); SSIM within 1e-5 of its scale (its E[x^2] - mu^2
cancels, and the two libraries' f32 convolutions sum in other orders);
the other losses within 1e-6 relative (the photometric one 1e-5); the
depth step in f64 within rtol 1e-4 of each tensor's largest magnitude
(the flax modules' fixed f32, BatchNorm and the SSIM window, read as f64
through a patch of their module's ``jnp`` scoped to the test).
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nextbestpath_tpu.assets import generate_scene, pack_generated_scene
from nextbestpath_tpu.config import default_params
from nextbestpath_tpu.geometry.cameras import CameraIntrinsics as JIntr
from nextbestpath_tpu.geometry.cameras import get_camera_RT as j_RT
from nextbestpath_tpu.models import manydepth as JMD
from nextbestpath_tpu.models import resnet as JR
from nextbestpath_tpu.models.macarons import Macarons as JMacarons
from nextbestpath_tpu.models.scone import SconeVis as JSconeVis
from nextbestpath_tpu.ops import raytrace as JRT
from nextbestpath_tpu.sim.sensor import capture_rgbd as j_capture_rgbd
from nextbestpath_tpu.train import depth_losses as JDL
from nextbestpath_tpu.train.train_macarons import \
    make_depth_steps as j_make_depth_steps
from nextbestpath_tpu_torch import assets as TA
from nextbestpath_tpu_torch import config as TC
from nextbestpath_tpu_torch.geometry.cameras import CameraIntrinsics
from nextbestpath_tpu_torch.models import manydepth as TMD
from nextbestpath_tpu_torch.models import resnet as TR
from nextbestpath_tpu_torch.models.convert import (manydepth_from_flax,
                                                   manydepth_to_flax,
                                                   scone_vis_from_flax)
from nextbestpath_tpu_torch.models.macarons import Adam, Macarons
from nextbestpath_tpu_torch.ops import raytrace as TRT
from nextbestpath_tpu_torch.sim.sensor import capture_rgbd
from nextbestpath_tpu_torch.train import depth_losses as TDL
from nextbestpath_tpu_torch.train.train_macarons import (AUG_SHAPES, TINY,
                                                         make_depth_steps)
from nextbestpath_tpu_torch.utils.checkpoint import load_checkpoint

H, W = 32, 56
CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "weights", "depth_pre", "depth_pre_best.ckpt")


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=1e-5):
    """Within rtol of the reference's largest magnitude."""
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _cams(n=3, seed=0):
    """n nearby cameras in the scene (R (n, 3, 3), T (n, 3)) as numpy."""
    rng = np.random.default_rng(seed)
    pos = np.asarray([7.0, 3.3, 7.0], np.float32) + rng.normal(
        0, 0.3, (n, 3)).astype(np.float32)
    ang = np.stack([np.zeros(n), 40.0 + rng.normal(0, 4.0, n)], -1
                   ).astype(np.float32)
    R, T = j_RT(jnp.asarray(pos), jnp.asarray(ang))
    return np.asarray(R), np.asarray(T)


# -- the shader ------------------------------------------------------------


def test_render_rgbd_matches_jax():
    """One frame: zbuf and the nearest-triangle index equal, the colour
    within 1e-6 (and capture_rgbd the same frame with its camera)."""
    params = default_params(**TINY)
    j_assets = pack_generated_scene(generate_scene("simple", seed=2),
                                    params=params)
    t_assets = TA.pack_generated_scene(TA.generate_scene("simple", seed=2),
                                       params=TC.default_params(**TINY))
    j_intr, t_intr = JIntr(image_height=H, image_width=W), CameraIntrinsics(
        image_height=H, image_width=W)
    pose = j_assets.pose_from_idx(j_assets.start_cam_idx).astype(np.float32)
    soa_j = JRT.tris_to_soa(jnp.asarray(j_assets.tris))
    colors = np.random.default_rng(0).uniform(
        0.2, 1.0, (j_assets.tris.shape[0], 3)).astype(np.float32)
    rgb_j, z_j, R_j, T_j = j_capture_rgbd(soa_j, j_assets.n_tris,
                                          jnp.asarray(pose), j_intr,
                                          tri_colors=jnp.asarray(colors))
    soa_t = TRT.tris_to_soa(_t(t_assets.tris))
    rgb_t, z_t, R_t, T_t = capture_rgbd(soa_t, t_assets.n_tris, _t(pose),
                                        t_intr, tri_colors=_t(colors))
    np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=1e-7)
    hit = z_t.numpy() > 0
    assert hit.mean() > 0.5 and (rgb_t.numpy()[~hit] == 0).all()
    # The index the shader reads: K1's plain version against the JAX cast.
    eye, d = TRT.frame_rays(R_t[None], T_t[None], t_intr)
    _, _, idx_t = TRT.ray_hits_pinhole(eye[0], d[0], soa_t, t_assets.n_tris,
                                       t_min=1.0, t_max=750.0)
    _, _, idx_j = JRT.ray_hits_pinhole(jnp.asarray(eye[0].numpy()),
                                       jnp.asarray(d[0].numpy()), soa_j,
                                       j_assets.n_tris, t_min=1.0,
                                       t_max=750.0)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    # The base gray without colours: the Lambert term alone varies.
    rgb_g, _ = TRT.render_rgbd(soa_t, t_assets.n_tris, R_t, T_t, t_intr)
    vals = rgb_g.numpy()[hit][:, 0]
    assert vals.min() >= 0.8 * 0.85 - 1e-6 and vals.max() <= 0.8 + 1e-6
    assert vals.std() > 0.005


# -- ResNet blocks, the expansion layer ------------------------------------


def _random_stats(variables, seed):
    """flax variables with random BatchNorm statistics and scales."""
    rng = np.random.default_rng(seed)
    v = _np(variables)

    def perturb(tree, stats):
        out = {}
        for k, x in tree.items():
            if isinstance(x, dict):
                out[k] = perturb(x, stats)
            elif k == "var":
                out[k] = rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
            elif k in ("mean", "bias") or (k == "scale" and not stats):
                out[k] = (x + rng.normal(0, 0.3, x.shape)).astype(np.float32)
            else:
                out[k] = x
        return out

    res = {"params": perturb(v["params"], False)}
    if "batch_stats" in v:
        res["batch_stats"] = perturb(v["batch_stats"], True)
    return res


def _nchw(x):
    return _t(x).permute(0, 3, 1, 2)


def _nhwc(y):
    return y.permute(0, 2, 3, 1)


@pytest.mark.parametrize("side", [(16, 28), (15, 29), (8, 15)])
@pytest.mark.parametrize("cin,features,strides", [(64, 128, 2), (64, 64, 1)])
def test_basic_block_and_layer_match_flax(side, cin, features, strides):
    """flax SAME padding: (0, 1) on an even side at stride 2, (1, 1) on an
    odd one; the 1x1 stride-2 shortcut unpadded; BatchNorm's statistics."""
    x = np.random.default_rng(1).normal(size=(2, *side, cin)).astype(
        np.float32)
    for j_mod, t_cls in ((JR.BasicBlock(features, strides), TR.BasicBlock),
                         (JR.ResNetLayer(features, strides), TR.ResNetLayer)):
        v = _random_stats(j_mod.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                          2)
        want = j_mod.apply(v, jnp.asarray(x))
        t = t_cls(cin, features, strides)
        t.load_state_dict(manydepth_from_flax(v))
        with torch.no_grad():
            _close(_nhwc(t(_nchw(x))), want)


def test_stem_pool_and_feature_extractor_match_flax():
    """The 7x7 stride-2 stem with (3, 3) padding, the max pool with (1, 1)
    of -inf, at odd sides, and the standalone FeatureExtractor."""
    x = np.random.default_rng(3).random((1, 31, 57, 3), dtype=np.float32)
    j_mod = JR.ResNetStem()
    v = _random_stats(j_mod.init(jax.random.PRNGKey(1), jnp.asarray(x)), 4)
    want = JR.maxpool_stem(j_mod.apply(v, jnp.asarray(x)))
    t = TR.ResNetStem()
    t.load_state_dict(manydepth_from_flax(v))
    with torch.no_grad():
        _close(_nhwc(TR.maxpool_stem(t(_nchw(x)))), want)
    j_fe = JMD.FeatureExtractor()
    v = _random_stats(j_fe.init(jax.random.PRNGKey(2), jnp.asarray(x)), 5)
    t_fe = TMD.FeatureExtractor()
    t_fe.load_state_dict(manydepth_from_flax(v))
    with torch.no_grad():
        _close(_nhwc(t_fe(_nchw(x))), j_fe.apply(v, jnp.asarray(x)))


@pytest.mark.parametrize("in_hw,out_hw,cin,inner,add",
                         [((8, 15), (16, 29), 64, 32, 16),
                          ((16, 29), (32, 57), 32, 16, 0)])
def test_expansion_layer_matches_flax(in_hw, out_hw, cin, inner, add):
    """The stride-1 ConvTranspose as stored (no flip) and the half-pixel
    nearest resize at 15 -> 29 and 29 -> 57."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1, *in_hw, cin)).astype(np.float32)
    x_add = (rng.normal(size=(1, *out_hw, add)).astype(np.float32)
             if add else None)
    j_mod = JMD.ExpansionLayer(inner, inner, out_hw)
    args = (jnp.asarray(x),) + ((jnp.asarray(x_add),) if add else ())
    v = _np(j_mod.init(jax.random.PRNGKey(2), *args))
    want = j_mod.apply(v, *args)
    t = TMD.ExpansionLayer(cin, inner, inner, out_hw, add)
    t.load_state_dict(manydepth_from_flax(v))
    with torch.no_grad():
        _close(_nhwc(t(_nchw(x), None if x_add is None else _nchw(x_add))),
               want)
    # torch's "nearest" (floor(i in/out)) picks other rows at these sizes.
    a = torch.arange(in_hw[1], dtype=torch.float32).reshape(1, 1, 1, -1)
    exact = torch.nn.functional.interpolate(a, size=(1, out_hw[1]),
                                            mode="nearest-exact")
    plain = torch.nn.functional.interpolate(a, size=(1, out_hw[1]),
                                            mode="nearest")
    assert not torch.equal(exact, plain)


# -- ManyDepth -------------------------------------------------------------


def _frames(seed=0, n_alpha=2):
    rng = np.random.default_rng(seed)
    x = rng.random((1, H, W, 3), dtype=np.float32)
    xa = rng.random((1, n_alpha, H, W, 3), dtype=np.float32)
    R, T = _cams(n_alpha + 1, seed)
    return x, xa, R, T


@pytest.fixture(scope="module")
def ckpt_vars():
    return load_checkpoint(CKPT)[0]


@pytest.mark.parametrize("weights", ["seeded", "depth_pre"])
def test_manydepth_matches_jax(weights, ckpt_vars):
    """The four disparities at 32x56 with 96 planes, and the cost volume
    (``return_cost_volume``) on the network's own features."""
    intr = JIntr(image_height=H, image_width=W)
    jm = JMD.ManyDepth(intr=intr)
    x, xa, R, T = _frames(1)
    args = (jnp.asarray(x), jnp.asarray(R[:1]), jnp.asarray(T[:1]),
            jnp.asarray(xa), jnp.asarray(R[None, 1:]), jnp.asarray(T[None, 1:]))
    if weights == "seeded":
        v = _random_stats(jm.init(jax.random.PRNGKey(3), *args), 6)
    else:
        v = ckpt_vars
    want = jm.apply(v, *args)
    tm = TMD.ManyDepth(CameraIntrinsics(image_height=H, image_width=W))
    tm.load_state_dict(manydepth_from_flax(v))
    targs = tuple(_t(np.asarray(a)) for a in args)
    with torch.no_grad():
        got = tm(*targs)
    assert len(got) == 4
    rtol = 1e-5 if weights == "seeded" else 2e-5
    for g, w in zip(got, want):
        _close(g, w, rtol)
        assert 0.0 < float(g.min()) and float(g.max()) < 1.0
    # The cost volume alone on random features.
    rng = np.random.default_rng(7)
    f = rng.normal(size=(1, 8, 14, 64)).astype(np.float32)
    fa = rng.normal(size=(1, 2, 8, 14, 64)).astype(np.float32)
    cv_args = (jnp.asarray(f), args[1], args[2], jnp.asarray(fa), args[4],
               args[5])
    res_j, cv_j = JMD.CostVolumeBuilder(intr=intr).apply(
        {"params": v["params"]["cost_volume"]}, *cv_args,
        return_cost_volume=True)
    with torch.no_grad():
        res_t, cv_t = tm.cost_volume(*(_t(np.asarray(a)) for a in cv_args),
                                     return_cost_volume=True)
    assert cv_t.shape == (1, 8, 14, 96)
    _close(cv_t, cv_j)
    _close(_nhwc(res_t), res_j)
    assert float((cv_t > 0).float().mean()) > 0.5


def test_manydepth_learn_pose_matches_jax():
    """learn_pose=True without context cameras: the PoseDecoder's relative
    poses composed with the target camera feed the cost volume."""
    intr = JIntr(image_height=H, image_width=W)
    jm = JMD.ManyDepth(intr=intr, learn_pose=True)
    x, xa, R, T = _frames(2)
    args = (jnp.asarray(x), jnp.asarray(R[:1]), jnp.asarray(T[:1]),
            jnp.asarray(xa))
    v = _random_stats(jm.init(jax.random.PRNGKey(4), *args), 8)
    want = jm.apply(v, *args)
    tm = TMD.ManyDepth(CameraIntrinsics(image_height=H, image_width=W),
                       learn_pose=True)
    tm.load_state_dict(manydepth_from_flax(v))
    with torch.no_grad():
        got = tm(*(_t(np.asarray(a)) for a in args))
    for g, w in zip(got, want):
        _close(g, w)
    with pytest.raises(ValueError):
        TMD.ManyDepth(CameraIntrinsics(image_height=H, image_width=W))(
            *(_t(np.asarray(a)) for a in args))
    # The pose pieces alone.
    aa = np.random.default_rng(3).normal(0, 0.3, (2, 4, 3)).astype(np.float32)
    _close(TMD.axis_angle_to_matrix(_t(aa)), JMD.axis_angle_to_matrix(
        jnp.asarray(aa)), 1e-6)
    tr = np.random.default_rng(4).normal(0, 0.01, (2, 4, 3)).astype(
        np.float32)
    Rj, Tj = JMD.PoseDecoder.compose(jnp.asarray(R[None, :1]),
                                     jnp.asarray(T[None, :1]),
                                     jnp.asarray(aa[:1]), jnp.asarray(tr[:1]))
    Rt, Tt = TMD.PoseDecoder.compose(_t(R[None, :1]), _t(T[None, :1]),
                                     _t(aa[:1]), _t(tr[:1]))
    _close(Rt, Rj, 1e-6)
    _close(Tt, Tj, 1e-6)
    d = np.linspace(0.5, 750, 11).astype(np.float32)
    np.testing.assert_allclose(
        TMD.disparity_to_depth(TMD.depth_to_disparity(_t(d))).numpy(), d,
        rtol=1e-5)
    np.testing.assert_allclose(TMD.depth_to_disparity(_t(d)).numpy(),
                               np.asarray(JMD.depth_to_disparity(d)),
                               rtol=1e-6)
    # The planes: torch's linspace is within an ulp of jnp's.
    np.testing.assert_allclose(torch.linspace(0.5, 750.0, 96).numpy(),
                               np.asarray(jnp.linspace(0.5, 750.0, 96)),
                               rtol=3e-7)


def test_converter_round_trip(ckpt_vars):
    """depth_pre loads strict; back to flax it is the checkpoint's tree."""
    tm = TMD.ManyDepth(CameraIntrinsics(image_height=H, image_width=W))
    tm.load_state_dict(manydepth_from_flax(ckpt_vars), strict=True)
    back = manydepth_to_flax(tm.state_dict())
    want = dict(jax.tree_util.tree_leaves_with_path(ckpt_vars))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert sorted(map(str, want)) == sorted(map(str, got))
    for k, a in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(a))


def test_macarons_bundle_dispatch(ckpt_vars):
    """The bundle from the JAX variables: each mode is its module with the
    bundle's variables; the visibility gains equal JAX's."""
    vis = JSconeVis()
    pts = np.random.default_rng(0).random((1, 32, 4), dtype=np.float32)
    vh = np.random.default_rng(1).random((1, 32, 64), dtype=np.float32)
    vis_vars = vis.init(jax.random.PRNGKey(0), jnp.asarray(pts),
                        view_harmonics=jnp.asarray(vh))
    from nextbestpath_tpu_torch.models.convert import scone_occ_to_flax
    from nextbestpath_tpu_torch.models.scone import SconeOcc
    occ_params = scone_occ_to_flax(SconeOcc().state_dict())
    m = Macarons.from_flax(ckpt_vars, occ_params, _np(vis_vars),
                           image_height=H, image_width=W)
    cams = np.random.default_rng(2).random((1, 5, 3), dtype=np.float32) * 3
    jmac = JMacarons(depth=None, scone_occ=None, scone_vis=vis,
                     vis_vars=vis_vars)
    want = jmac.compute_visibility_gains(jnp.asarray(pts), jnp.asarray(vh),
                                         jnp.asarray(cams))
    with torch.no_grad():
        got = m.compute_visibility_gains(_t(pts), _t(vh), _t(cams))
        direct = m.scone_vis(_t(pts), view_harmonics=_t(vh))
        via = m("visibility", _t(pts), view_harmonics=_t(vh))
    _close(got, want)
    assert torch.equal(direct, via)
    ref = TMD.ManyDepth(CameraIntrinsics(image_height=H, image_width=W))
    ref.load_state_dict(manydepth_from_flax(ckpt_vars))
    x, xa, R, T = _frames(3)
    a = (_t(x), _t(R[:1]), _t(T[:1]), _t(xa), _t(R[None, 1:]),
         _t(T[None, 1:]))
    with torch.no_grad():
        assert torch.equal(m("depth", *a)[0], ref(*a)[0])
    with pytest.raises(ValueError):
        m("nope")
    sv = scone_vis_from_flax(_np(vis_vars))
    assert sorted(sv) == sorted(m.vis_vars)


# -- losses and augmentations ----------------------------------------------


def _images(seed, n=3):
    rng = np.random.default_rng(seed)
    base = rng.random((H, W, 3), dtype=np.float32)
    return np.stack([np.clip(np.roll(base, i, axis=1)
                             + rng.normal(0, 0.02, base.shape), 0, 1)
                     for i in range(n)]).astype(np.float32)


def test_ssim_and_regularity_match_jax():
    imgs = _images(0)
    flat = np.full((H, W, 3), 0.5, np.float32)  # SSIM's cancelling case
    for a, b in ((imgs[0], imgs[1]), (flat, flat), (imgs[2], flat)):
        _close(TDL.ssim(_t(a), _t(b)), JDL.ssim(jnp.asarray(a),
                                                 jnp.asarray(b)), 1e-5)
    np.testing.assert_allclose(TDL.ssim(_t(flat), _t(flat)).numpy(), 1.0,
                               atol=1e-6)
    disp = np.random.default_rng(1).uniform(0.05, 0.9, (H, W)).astype(
        np.float32)
    _close(TDL.regularity_tab(_t(disp), _t(imgs[0])),
           JDL.regularity_tab(jnp.asarray(disp), jnp.asarray(imgs[0])), 1e-6)
    mask = np.random.default_rng(2).random((H, W)) < 0.7
    for m in (None, mask):
        want = float(JDL.regularity_loss(
            jnp.asarray(disp), jnp.asarray(imgs[0]),
            None if m is None else jnp.asarray(m, jnp.float32)))
        got = float(TDL.regularity_loss(
            _t(disp), _t(imgs[0]), None if m is None else _t(m).float()))
        assert got == pytest.approx(want, rel=1e-6)
    want = JDL.error_mask_from_disparity(jnp.asarray(disp),
                                         jnp.asarray(imgs[0]),
                                         jnp.asarray(mask))
    got = TDL.error_mask_from_disparity(_t(disp), _t(imgs[0]), _t(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0.5 < float(got.float().mean()) < 1.0


def test_photometric_loss_matches_jax():
    """Border-padded warps of three alpha frames through a depth map, the
    min over alphas, with and without a mask."""
    imgs = _images(3, 4)
    R, T = _cams(4, 5)
    depth = np.random.default_rng(6).uniform(3.0, 12.0, (H, W)).astype(
        np.float32)
    intr_j = JIntr(image_height=H, image_width=W)
    intr_t = CameraIntrinsics(image_height=H, image_width=W)
    mask = np.random.default_rng(7).random((H, W)) < 0.8
    for m in (None, mask):
        want = float(JDL.photometric_loss(
            jnp.asarray(imgs[0]), jnp.asarray(depth), jnp.asarray(R[0]),
            jnp.asarray(T[0]), jnp.asarray(imgs[1:]), jnp.asarray(R[1:]),
            jnp.asarray(T[1:]), intr_j,
            mask=None if m is None else jnp.asarray(m, jnp.float32)))
        got = float(TDL.photometric_loss(
            _t(imgs[0]), _t(depth), _t(R[0]), _t(T[0]), _t(imgs[1:]),
            _t(R[1:]), _t(T[1:]), intr_t,
            mask=None if m is None else _t(m).float()))
        assert got == pytest.approx(want, rel=1e-5)
        assert 0.0 < got < 1.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_color_jitter_and_flip_match_jax(seed):
    """The jitter with JAX's five draws of one key (split 5 ways), raw
    uniforms mapped to their ranges as jax.random.uniform does; the flip
    with the camera conjugate."""
    imgs = _images(seed)
    key = jax.random.PRNGKey(seed)
    keys = jax.random.split(key, 5)
    u = [_t(jax.random.uniform(k, ())) for k in keys]
    for prob in (1.0, 0.3):
        want = JDL.color_jitter(key, jnp.asarray(imgs), probability=prob)
        got = TDL.color_jitter(u, _t(imgs), probability=prob)
        _close(got, want, 1e-6)
    R, T = _cams(3, seed)
    fj = JDL.horizontal_flip(jnp.asarray(imgs), jnp.asarray(R),
                             jnp.asarray(T))
    ft = TDL.horizontal_flip(_t(imgs), _t(R), _t(T))
    for a, b in zip(ft, fj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ft1 = TDL.horizontal_flip(_t(imgs[0]), _t(R[0]), _t(T[0]))
    fj1 = JDL.horizontal_flip(jnp.asarray(imgs[0]), jnp.asarray(R[0]),
                              jnp.asarray(T[0]))
    for a, b in zip(ft1, fj1):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# -- the depth step in f64 -------------------------------------------------


class _F64Numpy:
    """jax.numpy with ``float32`` read as ``float64``."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@contextlib.contextmanager
def _jax_f64(monkeypatch):
    """x64 on, and the fixed f32 of the flax BatchNorms and of the SSIM
    window read as f64 through their modules' ``jnp``."""
    with monkeypatch.context() as mp, jax.enable_x64(True):
        mp.setattr(JR, "jnp", _F64Numpy())
        mp.setattr(JDL, "jnp", _F64Numpy())
        yield


class _Negate:
    """A transform whose update is -grad (optax.sgd(1.0)): the new
    variables minus the old ones are the gradient."""

    def init(self, params):
        return ()

    def update(self, grads, state):
        return {k: -g for k, g in grads.items()}, state


def _split_uniforms(key, shapes):
    keys = jax.random.split(key, len(shapes))
    return [_split_uniforms(k, s) if isinstance(s, list)
            else _t(jax.random.uniform(k, tuple(s)))
            for k, s in zip(keys, shapes)]


def test_depth_step_gradient_and_adam_f64(monkeypatch, ckpt_vars):
    """The online depth step from depth_pre in f64 on both sides: the
    gradient of photometric + regularity with respect to every variable
    (through the jitter and, for one of the two keys, the flip) within
    rtol 1e-4 of each tensor's largest magnitude, the Adam update with the
    global-norm clip within 1e-3 of each tensor's update norm, the losses
    to 1e-10. The JAX step runs with jit disabled: its jitted f64 program
    differs from its own op-by-op one by about 1e-8 (the forward alone,
    up to 6e-8 in disp4), which a bias gradient's cancelling sum over
    pixels amplifies past 1e-4."""
    p = default_params(**TINY)
    tp = TC.default_params(**TINY)
    imgs = _images(4, 4)
    R, T = _cams(4, 9)
    f64 = lambda a: np.asarray(a, np.float64)  # noqa: E731
    args = (f64(imgs[1]), f64(R[1]), f64(T[1]),
            f64(imgs[[2, 3, 0]]), f64(R[[2, 3, 0]]), f64(T[[2, 3, 0]]))
    m = Macarons.from_flax(ckpt_vars, scone_occ_params(), scone_vis_params(),
                           image_height=H, image_width=W, dtype=np.float64)
    intr_t = CameraIntrinsics(image_height=H, image_width=W)
    with _jax_f64(monkeypatch):
        j_model = JMD.ManyDepth(intr=JIntr(image_height=H, image_width=W),
                                dtype=jnp.float64)
        jv = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                    ckpt_vars)
        jargs = tuple(jnp.asarray(a) for a in args)
        flips = []
        for seed, tx, t_tx in ((0, optax.sgd(1.0), _Negate()),
                               (1, optax.sgd(1.0), _Negate()),
                               (0, optax.chain(optax.clip_by_global_norm(0.5),
                                               optax.adam(1e-3)),
                                Adam(1e-3, clip=0.5))):
            key = jax.random.PRNGKey(seed)
            step_j, _ = j_make_depth_steps(j_model, tx, JIntr(
                image_height=H, image_width=W), p)
            with jax.disable_jit():
                new_j, _, photo_j, reg_j = step_j(jv, tx.init(jv), *jargs,
                                                  key)
            aug = _split_uniforms(key, AUG_SHAPES)
            flips.append(float(aug[1]) < 0.5)
            step_t, _ = make_depth_steps(m, t_tx, intr_t, tp)
            new_t, _, photo_t, reg_t = step_t(
                m.depth_vars, t_tx.init(m.depth_vars),
                *(_t(a) for a in args), aug)
            assert float(photo_t) == pytest.approx(float(photo_j), rel=1e-10)
            assert float(reg_t) == pytest.approx(float(reg_j), rel=1e-10)
            want = manydepth_from_flax(_np(new_j), np.float64)
            for k, v in new_t.items():
                d_t = (v - m.depth_vars[k]).numpy()
                d_j = want[k].numpy() - m.depth_vars[k].numpy()
                if not np.abs(d_j).max() > 0:
                    assert np.abs(d_t).max() == 0, k
                elif isinstance(t_tx, _Negate):
                    _close(d_t, d_j, 1e-4)
                else:
                    # Adam's first step, lr g / (|g| + eps), amplifies the
                    # relative error of gradients near eps: its whole
                    # update within 1e-3 of its norm.
                    assert np.linalg.norm(d_t - d_j) <= 1e-3 * np.linalg.norm(
                        d_j), k
    assert flips[:2] in ([True, False], [False, True])
    assert float(photo_t) > 0.0


def scone_occ_params():
    from nextbestpath_tpu_torch.models.convert import scone_occ_to_flax
    from nextbestpath_tpu_torch.models.scone import SconeOcc
    torch.manual_seed(0)
    return scone_occ_to_flax(SconeOcc().state_dict())


def scone_vis_params():
    from nextbestpath_tpu_torch.models.convert import scone_vis_to_flax
    from nextbestpath_tpu_torch.models.scone import SconeVis
    torch.manual_seed(0)
    return scone_vis_to_flax(SconeVis().state_dict())
