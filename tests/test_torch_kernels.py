"""The port's kernel launchers (nextbestpath_tpu_torch/kernels.py).

Imports torch and the port only, so that the card, which has no JAX, can
run it without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tests marked ``cuda`` decide inside the test whether a card is present and
skip without one. On the card each kernel must equal its plain version
exactly: both round every product and sum once, in the same order.
"""

import os

import numpy as np
import pytest
import torch

from nextbestpath_tpu_torch import kernels
from nextbestpath_tpu_torch.ops import coverage as C
from nextbestpath_tpu_torch.ops import raytrace as R


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _rays(n_tris=700, n_rays=5000, seed=4):
    rng = np.random.default_rng(seed)
    tris = rng.normal(scale=5.0, size=(n_tris, 3, 3)).astype(np.float32)
    o = rng.normal(scale=2.0, size=(n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    return torch.from_numpy(tris), torch.from_numpy(o), torch.from_numpy(d)


def test_library_path_is_hashed_under_build_dir():
    path = kernels.library_path()
    assert os.path.dirname(path) == kernels.BUILD_DIR
    assert os.path.basename(path).startswith("libnbp_kernels_")
    assert path.endswith(".so") and path == kernels.library_path()
    names = sorted(os.path.basename(p) for p in kernels._sources())
    assert names == ["common.cuh", "coverage.cu", "raytrace.cu"]


def test_find_nvcc_raises_when_absent(monkeypatch):
    monkeypatch.setattr(kernels.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.find_nvcc()


@pytest.mark.parametrize("launch", ["pinhole", "general", "min_sq"])
def test_launchers_refuse_cpu_tensors(launch):
    """A launcher never falls back: a CPU tensor is an error, checked before
    any build."""
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        if launch == "pinhole":
            kernels.ray_hits_pinhole(x[None], torch.zeros(1, 10, 4), 4, 0.0,
                                     1.0)
        elif launch == "general":
            kernels.ray_hits(x, x, torch.zeros(9, 4), 4, 0.0, 1.0)
        else:
            kernels.min_sq_dists(x, x, 4)


@pytest.mark.parametrize("t_min", [-1.0, -1e-30, float("nan")])
def test_pinhole_launcher_refuses_negative_t_min(t_min):
    """K1 folds each triangle's sign into its data, which holds only for
    hits in front of the origin: the launcher refuses t_min < 0 (and NaN),
    before any build, on any device."""
    devices = ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])
    for dev in devices:
        dirs = torch.zeros(1, 4, 3, device=dev)
        ph = torch.zeros(1, 10, 4, device=dev)
        kernels.reset_launch_counts()
        with pytest.raises(ValueError, match="t_min"):
            kernels.ray_hits_pinhole(dirs, ph, 4, t_min, 1.0)
        assert kernels.LAUNCHES["ray_hits_pinhole"] == 0


def test_cpu_wrappers_take_plain_versions_and_count_nothing():
    kernels.reset_launch_counts()
    tris, o, d = _rays(50, 64)
    soa = R.tris_to_soa(tris)
    R.ray_hits_full(o, d, soa, 50)
    R.ray_hits_pinhole(o[0], d, soa, 50)
    C.min_dists(o, d, torch.ones(64, dtype=torch.bool))
    assert kernels.LAUNCHES == {"ray_hits_pinhole": 0, "ray_hits": 0,
                                "min_sq_dists": 0}


@pytest.mark.cuda
def test_ray_kernels_equal_plain_versions_on_card():
    _need_card()
    tris, o, d = _rays()
    soa = R.tris_to_soa(tris).cuda()
    o, d = o.cuda(), d.cuda()
    kernels.reset_launch_counts()
    for n_tris in (700, 650, 0):
        got = R.ray_hits_full(o, d, soa, n_tris)
        want = R.ray_hits_plain(o, d, soa, n_tris, 1e-4, 3.4e38)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        origin = o[0]
        got = R.ray_hits_pinhole(origin, d, soa, torch.tensor([n_tris]))
        want = R.ray_hits_pinhole_plain(d, R.pinhole_tri_soa(soa, origin),
                                        n_tris, 1e-4, 3.4e38)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert kernels.LAUNCHES["ray_hits"] == 3
    assert kernels.LAUNCHES["ray_hits_pinhole"] == 3


@pytest.mark.cuda
def test_min_sq_dists_equals_plain_version_on_card():
    _need_card()
    rng = np.random.default_rng(5)
    g = torch.from_numpy(rng.uniform(-100, 100, (3000, 3)).astype(np.float32)).cuda()
    s = torch.from_numpy(rng.uniform(-100, 100, (5000, 3)).astype(np.float32)).cuda()
    for count in (0, 1, 1023, 1024, 1025, 5000, 9000):
        got = kernels.min_sq_dists(g, s, torch.tensor(count, device="cuda"))
        want = C.min_sq_dists_plain(g, s, count)
        assert torch.equal(got, want), count


@pytest.mark.cuda
@pytest.mark.parametrize("g_case", ["one", "block-1", "block+1", "main"])
def test_min_sq_dists_tiling_edges_on_card(g_case):
    """K3 at the edges of its tiling: GT counts around the points a block
    holds, and sample counts around a split boundary, against the plain
    version, bit for bit. The main path's 20000 x 40960 is one case."""
    _need_card()
    n_s = 40960
    block = kernels.min_sq_dists_tiling(20000, n_s)["points_per_block"]
    n_g = {"one": 1, "block-1": block - 1, "block+1": block + 1,
           "main": 20000}[g_case]
    tiling = kernels.min_sq_dists_tiling(n_g, n_s)
    assert tiling["splits"] * tiling["chunk"] >= n_s
    rng = np.random.default_rng(n_g)
    g = torch.from_numpy(rng.uniform(-30, 30, (n_g, 3)).astype(np.float32)).cuda()
    s = torch.from_numpy(rng.uniform(-30, 30, (n_s, 3)).astype(np.float32)).cuda()
    chunk = tiling["chunk"]
    for count in (0, 1, 1023, 1025, chunk - 1, min(2 * chunk, n_s) - 1, n_s):
        got = kernels.min_sq_dists(g, s, torch.tensor(count, device="cuda"))
        want = C.min_sq_dists_plain(g, s, count)
        assert torch.equal(got, want), (n_g, count, tiling)


@pytest.mark.cuda
@pytest.mark.parametrize("n_frames", [1, 4])
@pytest.mark.parametrize("n_tris", [0, 1, 257])
def test_pinhole_kernel_frames_and_tiles_on_card(n_frames, n_tris):
    """K1 over B frames in one launch, with a ray count that is no multiple
    of the rays a block covers and triangle counts at the tile's edges,
    equals its plain version frame by frame, bit for bit."""
    _need_card()
    rng = np.random.default_rng(10 * n_frames + n_tris)
    tris = rng.normal(scale=5.0, size=(300, 3, 3)).astype(np.float32)
    soa = R.tris_to_soa(torch.from_numpy(tris)).cuda()
    origins = torch.from_numpy(rng.normal(size=(n_frames, 3)).astype(np.float32)).cuda()
    dirs = torch.from_numpy(rng.normal(size=(n_frames, 5003, 3)).astype(np.float32)).cuda()
    ph = R.pinhole_tri_soa(soa, origins)
    nt = torch.tensor([n_tris], dtype=torch.int32, device="cuda")
    kernels.reset_launch_counts()
    got = kernels.ray_hits_pinhole(dirs, ph, nt, 1e-4, 3.4e38)
    assert kernels.LAUNCHES["ray_hits_pinhole"] == 1
    want = R.ray_hits_pinhole_plain(dirs, ph, n_tris, 1e-4, 3.4e38)
    for g, w in zip(got, want):
        assert g.shape == (n_frames, 5003)
        assert torch.equal(g, w)
    if n_tris:
        assert bool((got[1] > 0).any())


@pytest.mark.cuda
def test_launchers_check_dtype_and_shape_on_card():
    _need_card()
    x = torch.zeros(4, 3, device="cuda")
    with pytest.raises(ValueError, match="float32"):
        kernels.min_sq_dists(x.double(), x, 4)
    with pytest.raises(ValueError, match="shape"):
        kernels.ray_hits_pinhole(x, torch.zeros(1, 10, 4, device="cuda"), 4, 0.0, 1.0)
    with pytest.raises(ValueError, match="shape"):
        kernels.ray_hits_pinhole(x[None], torch.zeros(1, 9, 4, device="cuda"), 4, 0.0, 1.0)
    with pytest.raises(ValueError, match="shape"):
        kernels.ray_hits_pinhole(x[None], torch.zeros(2, 10, 4, device="cuda"), 4, 0.0, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.ray_hits(x, torch.zeros(3, 4, device="cuda").T, torch.zeros(9, 4, device="cuda"), 4, 0.0, 1.0)
