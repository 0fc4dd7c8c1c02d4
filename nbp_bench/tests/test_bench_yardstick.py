"""The yardstick's counts: the U-Net's operations against PyTorch's FLOP
counter on the reference U-Net, K1's bytes and K3's pairs on hand-made
shapes, and the guard against the JAX package."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from nbp_bench import arith, common
from nbp_bench.reference.unet import Net


def _meta_state(width: int):
    from nextbestpath_tpu_torch.models.unet import NBP
    with torch.device("meta"):
        return NBP(width=width).state_dict()


def test_unet_flops_match_the_counter_on_the_reference_unet():
    sd = _meta_state(64)
    x = torch.empty(1, 256, 256, 5, device="meta")
    with FlopCounterMode(display=False) as fc:
        Net(sd)(x)
    assert fc.get_total_flops() == arith.unet_forward_flops() \
        == 182_411_329_536


def test_unet_flops_scale_with_batch_and_shape():
    sd = _meta_state(8)
    x = torch.empty(3, 64, 64, 5, device="meta")
    with FlopCounterMode(display=False) as fc:
        Net(sd)(x)
    assert fc.get_total_flops() == arith.unet_forward_flops(3, width=8,
                                                            size=64)


def test_k1_bytes_count_rays_and_each_frames_triangles_once():
    # Two frames of 6 rays against 5 triangles: 24 B a ray, 40 B a
    # triangle a frame.
    assert arith.k1_bytes(2, 6, 5) == 2 * (24 * 6 + 40 * 5)
    assert arith.k1_bytes(0, 116736, 252) == 0


def test_k3_ops_are_nine_a_pair():
    assert arith.k3_ops(20000 * 40960) == 9 * 20000 * 40960


def test_forbidden_modules_compare_top_level_names_whole():
    mods = ["nextbestpath_tpu_torch", "nextbestpath_tpu_torch.kernels",
            "torch", "nbp_bench.run", "jaxtyping", "flaxen"]
    assert common.forbidden_loaded(mods) == []
    assert common.forbidden_loaded(mods + ["jax.numpy"]) == ["jax"]
    assert common.forbidden_loaded(
        mods + ["nextbestpath_tpu.ops", "flax", "jaxlib"]) == [
        "flax", "jaxlib", "nextbestpath_tpu"]


def _wall(z: float, half: float = 50.0):
    """Two triangles of the plane at depth z, facing a camera at the
    origin that looks along +z."""
    a, b, c, d = ([-half, -half, z], [half, -half, z], [half, half, z],
                  [-half, half, z])
    return [[a, b, c], [a, c, d]]


@pytest.mark.parametrize("near, read", [(1.0 + 1e-6, 0.0), (1.01, 1.0)])
def test_sensor_reads_a_wall_on_the_near_plane_either_way(near, read):
    """Points on the far wall, behind a wall that lies on the near plane
    to rounding, are sound; behind a wall clear of the plane they are
    not."""
    import random
    from types import SimpleNamespace

    from nbp_bench import checks
    from nbp_bench.reference import geometry as rgeo

    params = SimpleNamespace(image_height=8, image_width=12,
                             fov_degrees=60.0, camera_znear=1.0, zfar=750.0,
                             sensor_range=70.0, gathering_factor=0.05)
    tris = torch.tensor(_wall(near) + _wall(2.5), dtype=torch.float32)
    frames = torch.zeros((1, 5), dtype=torch.float32)
    eye, axes = rgeo.camera_axes(frames)
    dirs = rgeo.pixel_dirs(axes, 8, 12, 60.0)[0]
    # 5% of the 96 pixels: 4 points, on the far wall.
    pts = (eye[0] + 2.5 * dirs[[0, 17, 50, 95]]).to(torch.float32)
    errs, n_exp, n_prog = checks._sensor(
        {"tris": tris}, frames, pts, 0, params, random.Random(0), 6144,
        10 ** 6, torch.float64)
    assert n_exp == n_prog == 4
    assert float(errs.max()) == pytest.approx(read, abs=1e-6)
