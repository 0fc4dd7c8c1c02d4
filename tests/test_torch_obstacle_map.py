"""The GT layout rasteriser of the port (``ops/obstacle_map.py``) against
the JAX one: the map is a binary training label, so it must be equal pixel
for pixel, on procgen simple and normal scenes at several lattice poses,
with the default 80 m window and a 16 m one that clips most segments at
the grid's border; the plane sections (segments and their validity) are
compared too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextbestpath_tpu.assets import generate_scene, pack_generated_scene
from nextbestpath_tpu.config import default_params
from nextbestpath_tpu.ops import obstacle_map as JO
from nextbestpath_tpu.ops.raytrace import tris_to_soa as j_soa
from nextbestpath_tpu_torch.ops import obstacle_map as TO
from nextbestpath_tpu_torch.ops.raytrace import tris_to_soa


def _poses(assets, n, seed):
    rng = np.random.default_rng(seed)
    idx = [np.array([rng.integers(assets.pose_l), 0, rng.integers(assets.pose_h),
                     2, rng.integers(assets.n_azim)]) for _ in range(n)]
    return [np.asarray(assets.pose_from_idx(i), np.float32) for i in idx]


@pytest.fixture(scope="module")
def scenes():
    return {d: pack_generated_scene(generate_scene(d, seed=s),
                                    params=default_params())
            for d, s in (("simple", 8), ("normal", 3))}


@pytest.mark.parametrize("difficulty", ["simple", "normal"])
@pytest.mark.parametrize("grid_range,grid_size", [((-40.0, 40.0), 256),
                                                  ((-8.0, 8.0), 256),
                                                  ((-40.0, 40.0), 64)])
def test_gt_obstacle_map_equal(scenes, difficulty, grid_range, grid_size):
    a = scenes[difficulty]
    tris_t = torch.from_numpy(a.tris)
    n_t = torch.tensor([a.n_tris], dtype=torch.int32)
    for pose in _poses(a, 4, seed=len(difficulty) + grid_size):
        want = np.asarray(JO.gt_obstacle_map(
            jnp.asarray(a.tris), a.n_tris, jnp.asarray(pose),
            grid_size=grid_size, grid_range=grid_range))
        got = TO.gt_obstacle_map(tris_t, n_t, torch.from_numpy(pose),
                                 grid_size=grid_size,
                                 grid_range=grid_range).numpy()
        assert got.dtype == np.float32 and got.shape == (grid_size,) * 2
        assert want.sum() > 0
        np.testing.assert_array_equal(got, want)
        raw = TO.gt_obstacle_map(tris_t, n_t, torch.from_numpy(pose),
                                 grid_size=grid_size, grid_range=grid_range,
                                 stroke_dilation=False).numpy()
        np.testing.assert_array_equal(raw, np.asarray(JO.gt_obstacle_map(
            jnp.asarray(a.tris), a.n_tris, jnp.asarray(pose),
            grid_size=grid_size, grid_range=grid_range,
            stroke_dilation=False)))


def test_sections_and_soa_variant_equal(scenes):
    """plane_section_segments (and the SoA entry) give the JAX segments
    and validity; the SoA layout map equals the dense one."""
    a = scenes["normal"]
    pose = _poses(a, 1, seed=7)[0]
    y = np.float32(pose[1])
    seg_j, ok_j = JO.plane_section_segments(jnp.asarray(a.tris), a.n_tris,
                                            jnp.asarray(y))
    seg_t, ok_t = TO.plane_section_segments(
        torch.from_numpy(a.tris), torch.tensor([a.n_tris], dtype=torch.int32),
        torch.tensor(y))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    ok = np.asarray(ok_j)
    assert ok.sum() > 10
    np.testing.assert_array_equal(seg_t.numpy()[ok], np.asarray(seg_j)[ok])
    soa_t = tris_to_soa(torch.from_numpy(a.tris))
    n_t = torch.tensor([a.n_tris], dtype=torch.int32)
    got = TO.gt_obstacle_map_soa(soa_t, n_t, torch.from_numpy(pose)).numpy()
    np.testing.assert_array_equal(got, TO.gt_obstacle_map(
        torch.from_numpy(a.tris), n_t, torch.from_numpy(pose)).numpy())
    np.testing.assert_array_equal(got, np.asarray(JO.gt_obstacle_map_soa(
        j_soa(jnp.asarray(a.tris)), a.n_tris, jnp.asarray(pose))))


def test_rasterize_clips_long_segments():
    """A chord far longer than the window is clipped before it is sampled:
    it draws a solid line across the grid, equal to the JAX one."""
    seg = np.array([[[-500.0, 3.1], [500.0, 3.1]],     # across, clipped
                    [[0.2, -0.3], [0.2, -0.3]],         # a point
                    [[900.0, 900.0], [950.0, 990.0]]],  # outside
                   np.float32)
    valid = np.array([True, True, True])
    want = np.asarray(JO.rasterize_segments(
        jnp.asarray(seg), jnp.asarray(valid), jnp.float32(0.0),
        jnp.float32(0.0), grid_size=64))
    got = TO.rasterize_segments(torch.from_numpy(seg), torch.from_numpy(valid),
                                torch.tensor(0.0), torch.tensor(0.0),
                                grid_size=64).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum(axis=1).max() == 64  # one full row
