"""Ray casting of the PyTorch port against the JAX package.

The JAX side runs its Pallas kernels in interpret mode on the CPU (the
package's own default off the TPU); the port's wrappers take the kernels'
plain versions for CPU tensors. Tolerances: hit distances to 1e-5 relative
(the JAX pinhole kernel contracts through a matmul, the port sums in index
order); hit counts and indices exact, apart from rays that graze a triangle
edge, which the pinhole cases allow for at most 0.5% of the rays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextbestpath_tpu.assets import generate_scene, pack_generated_scene
from nextbestpath_tpu.geometry import CameraIntrinsics as JIntr
from nextbestpath_tpu.geometry import get_camera_RT as j_get_camera_RT
from nextbestpath_tpu.ops import raytrace as J
from nextbestpath_tpu_torch.geometry.cameras import CameraIntrinsics, get_camera_RT
from nextbestpath_tpu_torch.ops import raytrace as T

T_RTOL = 1e-5
GRAZING_SHARE = 5e-3


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _unit_box():
    v = np.array([[x, y, z] for x in (0.0, 10.0) for y in (0.0, 10.0)
                  for z in (0.0, 10.0)], dtype=np.float32)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    faces = []
    for a, b, c, d in quads:
        faces += [(a, b, c), (a, c, d)]
    return v[np.array(faces)]


def _assert_hits(got, want, grazing_share=0.0):
    t_g, n_g, i_g = (np.asarray(x) for x in got)
    t_w, n_w, i_w = (np.asarray(x) for x in want)
    hit_g, hit_w = t_g < 1e30, t_w < 1e30
    allowed = int(grazing_share * len(t_w))
    assert (hit_g != hit_w).sum() <= allowed
    assert (n_g != n_w).sum() <= allowed
    assert (i_g != i_w).sum() <= allowed
    both = hit_g & hit_w
    np.testing.assert_allclose(t_g[both], t_w[both], rtol=T_RTOL, atol=1e-5)


def test_tris_to_soa_matches():
    tris = np.random.default_rng(0).normal(size=(40, 3, 3)).astype(np.float32)
    np.testing.assert_array_equal(T.tris_to_soa(_t(tris)).numpy(),
                                  np.asarray(J.tris_to_soa(jnp.asarray(tris))))


def test_pinhole_soa_matches():
    rng = np.random.default_rng(1)
    tris = rng.normal(scale=5.0, size=(64, 3, 3)).astype(np.float32)
    origin = np.array([0.3, -0.2, 0.1], np.float32)
    want = np.asarray(J.pinhole_tri_soa(J.tris_to_soa(jnp.asarray(tris)),
                                        jnp.asarray(origin)))
    got = T.pinhole_tri_soa(T.tris_to_soa(_t(tris)), _t(origin)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_ray_hits_analytic_box():
    tris = _unit_box()
    o = np.array([[5.0, 4.0, 5.0]], np.float32)
    d = np.array([[0.0, 0.0, 1.0]], np.float32)
    t, n = T.ray_hits(_t(o), _t(d), T.tris_to_soa(_t(tris)), len(tris))
    assert abs(float(t[0]) - 5.0) < 1e-5 and int(n[0]) == 1
    t_r, n_r = T.ray_hits_ref(_t(o), _t(d), _t(tris))
    assert abs(float(t_r[0]) - 5.0) < 1e-5 and int(n_r[0]) == 1


def test_general_matches_pallas_random():
    rng = np.random.default_rng(0)
    tris = rng.normal(scale=5.0, size=(64, 3, 3)).astype(np.float32)
    o = rng.normal(scale=2.0, size=(200, 3)).astype(np.float32)
    d = rng.normal(size=(200, 3)).astype(np.float32)
    want = J.ray_hits_full(jnp.asarray(o), jnp.asarray(d),
                           J.tris_to_soa(jnp.asarray(tris)), 64)
    got = T.ray_hits_full(_t(o), _t(d), T.tris_to_soa(_t(tris)), 64)
    _assert_hits(got, want)
    # The dense reference agrees too.
    t_r, n_r, i_r = T.ray_hits_idx_ref(_t(o), _t(d), _t(tris))
    _assert_hits((t_r, n_r, i_r), want)


def test_pinhole_matches_pallas_random():
    rng = np.random.default_rng(1)
    tris = rng.normal(scale=5.0, size=(300, 3, 3)).astype(np.float32)
    origin = np.array([0.3, -0.2, 0.1], np.float32)
    d = rng.normal(size=(700, 3)).astype(np.float32)
    want = J.ray_hits_pinhole(jnp.asarray(origin), jnp.asarray(d),
                              J.tris_to_soa(jnp.asarray(tris)), 300)
    got = T.ray_hits_pinhole(_t(origin), _t(d), T.tris_to_soa(_t(tris)), 300)
    _assert_hits(got, want, GRAZING_SHARE)


def test_pinhole_respects_n_tris():
    rng = np.random.default_rng(2)
    tris = rng.normal(scale=5.0, size=(96, 3, 3)).astype(np.float32)
    d = rng.normal(size=(300, 3)).astype(np.float32)
    origin = np.zeros(3, np.float32)
    soa = T.tris_to_soa(_t(tris))
    got = T.ray_hits_pinhole(_t(origin), _t(d), soa, torch.tensor([40]))
    want = T.ray_hits_pinhole(_t(origin), _t(d), soa[:, :40].contiguous(), 40)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_segment_hits():
    tris = _unit_box()
    soa = T.tris_to_soa(_t(tris))
    starts = torch.tensor([[5.0, 5.0, 5.0], [2.0, 5.0, 5.0]])
    ends = torch.tensor([[5.0, 5.0, 15.0], [8.0, 5.0, 5.0]])
    assert T.segments_hit_mesh(starts, ends, soa, len(tris)).tolist() == [True, False]


def test_inside_parity_matches_pallas():
    assets = pack_generated_scene(generate_scene("simple", seed=1))
    rng = np.random.default_rng(3)
    lo = assets.tris[:assets.n_tris].reshape(-1, 3).min(0)
    hi = assets.tris[:assets.n_tris].reshape(-1, 3).max(0)
    pts = rng.uniform(lo - 5, hi + 5, size=(120, 3)).astype(np.float32)
    pts[:2] = [[7.5, 3.3, 7.5], [-50.0, 3.3, -50.0]]
    want = np.asarray(J.points_inside_mesh(
        jnp.asarray(pts), J.tris_to_soa(jnp.asarray(assets.tris)),
        assets.n_tris))
    got = T.points_inside_mesh(_t(pts), T.tris_to_soa(_t(assets.tris)),
                               assets.n_tris).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[:2].tolist() == [True, False]


def test_render_depth_matches_pallas_scene():
    assets = pack_generated_scene(generate_scene("simple", seed=8))
    intr_j = JIntr(32, 56, 60.0, 1.0, 750.0)
    intr_t = CameraIntrinsics(32, 56, 60.0, 1.0, 750.0)
    pos, ang = np.array([[7.0, 3.3, 7.0]], np.float32), np.array([[0.0, 45.0]], np.float32)
    Rj, Tj = j_get_camera_RT(jnp.asarray(pos), jnp.asarray(ang))
    want = np.asarray(J.render_depth(J.tris_to_soa(jnp.asarray(assets.tris)),
                                     assets.n_tris, Rj[0], Tj[0], intr_j))
    Rt, Tt = get_camera_RT(_t(pos), _t(ang))
    got = T.render_depth(T.tris_to_soa(_t(assets.tris)), assets.n_tris, Rt[0],
                         Tt[0], intr_t).numpy()
    assert got.shape == (32, 56)
    assert ((got > -1) != (want > -1)).mean() <= GRAZING_SHARE
    both = (got > -1) & (want > -1)
    assert both.mean() > 0.5
    np.testing.assert_allclose(got[both], want[both], rtol=T_RTOL, atol=1e-4)


def _move_cameras(assets, n_steps=4):
    """(poses (B, 5), R, T) of the four substeps of the main path's move from
    the start pose to a lattice neighbour."""
    from nextbestpath_tpu_torch.eval.nbp_planning import main_path_move

    poses = main_path_move(assets, n_steps, "cpu")
    R, T_ = get_camera_RT(poses[:, :3], poses[:, 3:])
    return poses.numpy(), R, T_


def test_render_depth_batch_matches_pallas_move():
    """The four substeps of one lattice move, rendered in one batch, against
    the JAX package's render_depth_batch (Pallas in interpret mode)."""
    assets = pack_generated_scene(generate_scene("simple", seed=8))
    intr_j = JIntr(32, 56, 60.0, 1.0, 750.0)
    intr_t = CameraIntrinsics(32, 56, 60.0, 1.0, 750.0)
    poses, Rt, Tt = _move_cameras(assets)
    Rj, Tj = j_get_camera_RT(jnp.asarray(poses[:, :3]),
                             jnp.asarray(poses[:, 3:]))
    want = np.asarray(J.render_depth_batch(
        J.tris_to_soa(jnp.asarray(assets.tris)), assets.n_tris, Rj, Tj,
        intr_j))
    got = T.render_depth_batch(T.tris_to_soa(_t(assets.tris)), assets.n_tris,
                               Rt, Tt, intr_t).numpy()
    assert got.shape == want.shape == (4, 32, 56)
    assert ((got > -1) != (want > -1)).mean() <= GRAZING_SHARE
    both = (got > -1) & (want > -1)
    assert both.mean() > 0.5
    np.testing.assert_allclose(got[both], want[both], rtol=T_RTOL, atol=1e-4)


def test_render_depth_batch_equals_stacked_frames():
    assets = pack_generated_scene(generate_scene("simple", seed=8))
    intr = CameraIntrinsics(32, 56, 60.0, 1.0, 750.0)
    _, R, T_ = _move_cameras(assets)
    soa = T.tris_to_soa(_t(assets.tris))
    nt = torch.tensor([assets.n_tris], dtype=torch.int32)
    got = T.render_depth_batch(soa, nt, R, T_, intr)
    want = torch.stack([T.render_depth(soa, nt, R[b], T_[b], intr)
                        for b in range(R.shape[0])])
    assert torch.equal(got, want)


def test_pinhole_soa_batch_equals_stacked_frames():
    rng = np.random.default_rng(6)
    soa = T.tris_to_soa(_t(rng.normal(scale=5.0, size=(70, 3, 3))
                           .astype(np.float32)))
    origins = _t(rng.normal(size=(4, 3)).astype(np.float32))
    got = T.pinhole_tri_soa(soa, origins)
    assert got.shape == (4, 10, 70)
    want = torch.stack([T.pinhole_tri_soa(soa, o) for o in origins])
    assert torch.equal(got, want)


@pytest.mark.parametrize("n_tris", [0, 1, 41, 70])
def test_pinhole_plain_batch_equals_frames(n_tris):
    rng = np.random.default_rng(7)
    soa = T.tris_to_soa(_t(rng.normal(scale=5.0, size=(70, 3, 3))
                           .astype(np.float32)))
    origins = _t(rng.normal(size=(3, 3)).astype(np.float32))
    dirs = _t(rng.normal(size=(3, 333, 3)).astype(np.float32))
    ph = T.pinhole_tri_soa(soa, origins)
    got = T.ray_hits_pinhole_plain(dirs, ph, n_tris, 1e-4, 3.4e38)
    per = [T.ray_hits_pinhole_plain(dirs[b], ph[b], n_tris, 1e-4, 3.4e38)
           for b in range(3)]
    for i, g in enumerate(got):
        assert g.shape == (3, 333)
        assert torch.equal(g, torch.stack([p[i] for p in per]))
    # The dispatching wrapper takes the same batched path on the CPU.
    for g, w in zip(T.ray_hits_pinhole(origins, dirs, soa, n_tris), got):
        assert torch.equal(g, w)
