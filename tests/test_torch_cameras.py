"""Camera math of the PyTorch port against the JAX package (f32, 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextbestpath_tpu.geometry import cameras as J
from nextbestpath_tpu_torch.geometry import cameras as T

ATOL = 1e-5


def _poses(n=16, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-20, 20, size=(n, 3)).astype(np.float32)
    ang = np.stack([rng.uniform(-60, 60, n), rng.uniform(0, 360, n)],
                   -1).astype(np.float32)
    ang[0] = [90.0, 0.0]  # straight up: the look-at substitution branch
    return pos, ang


def test_get_camera_RT_matches():
    pos, ang = _poses()
    Rj, Tj = J.get_camera_RT(jnp.asarray(pos), jnp.asarray(ang))
    Rt, Tt = T.get_camera_RT(torch.from_numpy(pos), torch.from_numpy(ang))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=ATOL)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-4)
    np.testing.assert_allclose(T.camera_center(Rt[3], Tt[3]).numpy(), pos[3],
                               atol=1e-4)


@pytest.mark.parametrize("hw", [(32, 56), (256, 456), (24, 24)])
def test_ndc_tables_and_rays_match(hw):
    H, W = hw
    for a, b in zip(T.ndc_tables(H, W), J.ndc_tables(H, W)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert T.ndc_bounds(H, W) == J.ndc_bounds(H, W)
    np.testing.assert_array_equal(
        T.CameraIntrinsics(H, W).pixel_ray_dirs_view().numpy(),
        np.asarray(J.CameraIntrinsics(H, W).pixel_ray_dirs_view()))


def test_project_unproject_and_fov_match():
    pos, ang = _poses(4, seed=1)
    Rj, Tj = J.get_camera_RT(jnp.asarray(pos), jnp.asarray(ang))
    Rt, Tt = T.get_camera_RT(torch.from_numpy(pos), torch.from_numpy(ang))
    pts = np.random.default_rng(2).uniform(-30, 30, (200, 3)).astype(np.float32)
    pj = np.asarray(J.project_points(jnp.asarray(pts), Rj[1], Tj[1], 0.577))
    pt = T.project_points(torch.from_numpy(pts), Rt[1], Tt[1], 0.577).numpy()
    np.testing.assert_allclose(pt, pj, rtol=1e-4, atol=1e-4)
    intr_j, intr_t = J.CameraIntrinsics(8, 12), T.CameraIntrinsics(8, 12)
    depth = np.random.default_rng(3).uniform(1, 9, (8, 12)).astype(np.float32)
    uj = np.asarray(J.unproject_depth(jnp.asarray(depth), Rj[2], Tj[2], intr_j))
    ut = T.unproject_depth(torch.from_numpy(depth), Rt[2], Tt[2], intr_t).numpy()
    np.testing.assert_allclose(ut, uj, atol=1e-4)
    mj = np.asarray(J.points_in_fov_mask(jnp.asarray(pts), Rj[1], Tj[1], intr_j,
                                         fov_range=25.0))
    mt = T.points_in_fov_mask(torch.from_numpy(pts), Rt[1], Tt[1], intr_t,
                              fov_range=25.0).numpy()
    np.testing.assert_array_equal(mt, mj)
