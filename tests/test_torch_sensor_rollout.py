"""Sensor, buffers and the move/capture stage of the PyTorch port against
the JAX package, with the JAX package's random draws injected.

Selected pixel indices, validity and buffer counts must be identical;
world points agree to 1e-4 (f32 products summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextbestpath_tpu.assets import generate_scene, pack_generated_scene
from nextbestpath_tpu.geometry import CameraIntrinsics as JIntr
from nextbestpath_tpu.geometry import get_camera_RT as j_get_camera_RT
from nextbestpath_tpu.ops.raytrace import render_depth as j_render_depth
from nextbestpath_tpu.ops.raytrace import tris_to_soa as j_soa
from nextbestpath_tpu.sim import rollout as JR
from nextbestpath_tpu.sim import sensor as JS
from nextbestpath_tpu_torch.geometry.cameras import CameraIntrinsics, get_camera_RT
from nextbestpath_tpu_torch.ops.raytrace import tris_to_soa
from nextbestpath_tpu_torch.sim import rollout as TR
from nextbestpath_tpu_torch.sim import sensor as TS

H, W = 32, 56
PTS_ATOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def scene():
    assets = pack_generated_scene(generate_scene("simple", seed=8))
    return assets


def _frame(assets, pos=(7.0, 3.3, 7.0), ang=(0.0, 45.0)):
    intr = JIntr(H, W, 60.0, 1.0, 750.0)
    R, T = j_get_camera_RT(jnp.asarray([pos], jnp.float32),
                           jnp.asarray([ang], jnp.float32))
    zbuf = j_render_depth(j_soa(jnp.asarray(assets.tris)), assets.n_tris,
                          R[0], T[0], intr)
    return zbuf, R[0], T[0], intr


@pytest.mark.parametrize("n_slots,gf", [(256, 0.05), (64, 0.5), (1024, 1.0)])
def test_backproject_sample_selects_same_pixels(scene, n_slots, gf):
    zbuf, R, T, intr = _frame(scene)
    key = jax.random.PRNGKey(7)
    want = JS.backproject_sample(zbuf, R, T, intr, key, n_slots,
                                 gathering_factor=gf)
    u = _t(jax.random.uniform(key, (H * W,)))
    got = TS.backproject_sample(_t(zbuf), _t(R), _t(T),
                                CameraIntrinsics(H, W, 60.0, 1.0, 750.0), u,
                                n_slots, gathering_factor=gf)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    v = got.valid.numpy()
    assert v.sum() > 0
    np.testing.assert_allclose(got.points.numpy()[v], np.asarray(want.points)[v],
                               atol=PTS_ATOL)


def test_point_buffer_append_matches():
    rng = np.random.default_rng(0)
    cap = 40
    pj = JS.PointBuffer.create(cap)
    pt = TS.PointBuffer.create(cap, "cpu")
    for n_valid in (10, 0, 25, 12):  # the last batch overflows
        pts = rng.normal(size=(16, 3)).astype(np.float32)
        valid = np.arange(16) < min(n_valid, 16)
        pj = pj.append(JS.FramePoints(jnp.asarray(pts), jnp.asarray(valid)),
                       prefix_valid=True)
        pt.append(TS.FramePoints(_t(pts), _t(valid)), prefix_valid=True)
        assert int(pt.count) == int(pj.count)
        np.testing.assert_array_equal(pt.points.numpy(), np.asarray(pj.points))
        np.testing.assert_array_equal(pt.valid_mask().numpy(),
                                      np.asarray(pj.valid_mask()))
    with pytest.raises(NotImplementedError):
        pt.append(TS.FramePoints(_t(pts), _t(valid)), prefix_valid=False)


def test_trajectory_buffer_matches():
    tj = JR.TrajectoryBuffer.create(3)
    tt = TR.TrajectoryBuffer.create(3, "cpu")
    for i in range(5):
        p = np.full(3, float(i), np.float32)
        tj = tj.append(jnp.asarray(p))
        tt.append(_t(p))
        assert int(tt.count) == int(tj.count)
        np.testing.assert_array_equal(tt.xyz.numpy(), np.asarray(tj.xyz))


@pytest.mark.parametrize("old_a,new_a", [(0.0, 315.0), (315.0, 0.0),
                                         (45.0, 90.0), (270.0, 0.0),
                                         (0.0, 0.0)])
def test_interpolate_pose_wraparound_matches(old_a, new_a):
    old = np.array([1.0, 3.3, 2.0, 0.0, old_a], np.float32)
    new = np.array([4.0, 3.3, 2.0, 0.0, new_a], np.float32)
    for s in range(1, 5):
        want = np.asarray(JR.interpolate_pose(jnp.asarray(old), jnp.asarray(new),
                                              jnp.int32(s), 4, 8))
        got = TR.interpolate_pose(_t(old), _t(new), s, 4, 8).numpy()
        np.testing.assert_array_equal(got, want)


def test_move_and_capture_and_observe_match(scene):
    intr_j = JIntr(H, W, 60.0, 1.0, 750.0)
    intr_t = CameraIntrinsics(H, W, 60.0, 1.0, 750.0)
    old = np.array([7.0, 3.3, 7.0, 0.0, 315.0], np.float32)
    new = np.array([10.0, 3.3, 7.0, 0.0, 0.0], np.float32)
    key = jax.random.PRNGKey(3)
    kw = dict(n_steps=4, n_azim=8, n_slots=256)
    soa_j = j_soa(jnp.asarray(scene.tris))
    nt_j = jnp.asarray(scene.n_tris, jnp.int32)
    pc_j, tr_j, z_j = JR.move_and_capture(
        soa_j, nt_j, jnp.asarray(old), jnp.asarray(new),
        JS.PointBuffer.create(4096), JR.TrajectoryBuffer.create(16), key,
        intr_j, **kw)
    pc_j = JR.observe_current(soa_j, nt_j, jnp.asarray(new), pc_j,
                              jax.random.fold_in(key, 99), intr_j, n_slots=256)

    soa_t = tris_to_soa(_t(scene.tris))
    scores = [_t(jax.random.uniform(jax.random.fold_in(key, s), (H * W,)))
              for s in range(1, 5)]
    pc_t = TS.PointBuffer.create(4096, "cpu")
    tr_t = TR.TrajectoryBuffer.create(16, "cpu")
    _, _, z_t = TR.move_and_capture(soa_t, scene.n_tris, _t(old), _t(new), pc_t,
                                    tr_t, scores, intr_t, **kw)
    TR.observe_current(soa_t, scene.n_tris, _t(new), pc_t,
                       _t(jax.random.uniform(jax.random.fold_in(key, 99),
                                             (H * W,))), intr_t, n_slots=256)
    assert int(pc_t.count) == int(pc_j.count) > 0
    assert int(tr_t.count) == int(tr_j.count) == 4
    n = int(pc_t.count)
    np.testing.assert_allclose(pc_t.points[:n].numpy(),
                               np.asarray(pc_j.points)[:n], atol=PTS_ATOL)
    np.testing.assert_allclose(tr_t.xyz.numpy(), np.asarray(tr_j.xyz), atol=1e-6)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), atol=1e-4)


def test_move_and_capture_renders_substeps_as_frames(scene):
    """The batched render of a move gives each substep the frame that
    capture_depth renders for its pose alone, to the bit."""
    intr = CameraIntrinsics(H, W, 60.0, 1.0, 750.0)
    old = _t(np.array([7.0, 3.3, 7.0, 0.0, 315.0], np.float32))
    new = _t(np.array([10.0, 3.3, 7.0, 0.0, 0.0], np.float32))
    soa = tris_to_soa(_t(scene.tris))
    poses = TR.interpolate_move(old, new, 4, 8)
    zbufs, R, T_ = TS.capture_depth_batch(soa, scene.n_tris, poses, intr)
    for b in range(4):
        z, r, t = TS.capture_depth(soa, scene.n_tris, poses[b], intr)
        assert torch.equal(zbufs[b], z)
        assert torch.equal(R[b], r) and torch.equal(T_[b], t)
    scores = [torch.rand(H * W, generator=torch.Generator().manual_seed(s))
              for s in range(4)]
    _, _, last = TR.move_and_capture(soa, scene.n_tris, old, new,
                                     TS.PointBuffer.create(4096, "cpu"),
                                     TR.TrajectoryBuffer.create(16, "cpu"),
                                     scores, intr, n_steps=4, n_azim=8,
                                     n_slots=256)
    assert torch.equal(last, zbufs[-1])
