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
from nextbestpath_tpu_torch.draws import TorchDraws
from nextbestpath_tpu_torch.geometry.cameras import CameraIntrinsics
from nextbestpath_tpu_torch.ops import coverage as C
from nextbestpath_tpu_torch.ops import raytrace as R
from nextbestpath_tpu_torch.planning import grid_paths as G


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
    assert names == ["common.cuh", "coverage.cu", "gumbel.cu", "plan.cu",
                     "raytrace.cu"]


def test_find_nvcc_raises_when_absent(monkeypatch):
    monkeypatch.setattr(kernels.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.find_nvcc()


@pytest.mark.parametrize("launch", ["pinhole", "general", "min_sq",
                                    "pinhole_scenes", "min_sq_scenes",
                                    "bfs_scenes", "path_scenes"])
def test_launchers_refuse_cpu_tensors(launch):
    """A launcher never falls back: a CPU tensor is an error, checked before
    any build."""
    x = torch.zeros(4, 3)
    n2 = torch.zeros(2, dtype=torch.int32)
    blocked = torch.zeros((2, 4, 3, 3), dtype=torch.bool)
    start = torch.zeros((2, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        if launch == "pinhole":
            kernels.ray_hits_pinhole(x[None], torch.zeros(1, 10, 4), 4, 0.0,
                                     1.0, 4)
        elif launch == "general":
            kernels.ray_hits(x, x, torch.zeros(9, 4), 4, 0.0, 1.0)
        elif launch == "min_sq":
            kernels.min_sq_dists(x, x, 4)
        elif launch == "pinhole_scenes":
            kernels.ray_hits_pinhole_scenes(torch.stack([x, x]),
                                            torch.zeros(2, 10, 4), n2, 0.0,
                                            1.0, 4)
        elif launch == "min_sq_scenes":
            kernels.min_sq_dists_scenes(torch.stack([x, x]),
                                        torch.stack([x, x]), n2)
        elif launch == "bfs_scenes":
            kernels.bfs_field_scenes(blocked, start)
        else:
            kernels.extract_path_scenes(torch.zeros((2, 3, 3),
                                                    dtype=torch.int32),
                                        blocked, start, 8)


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
            kernels.ray_hits_pinhole(dirs, ph, 4, t_min, 1.0, 4)
        assert kernels.LAUNCHES["ray_hits_pinhole"] == 0


def test_cpu_wrappers_take_plain_versions_and_count_nothing():
    kernels.reset_launch_counts()
    tris, o, d = _rays(50, 64)
    soa = R.tris_to_soa(tris)
    R.ray_hits_full(o, d, soa, 50)
    R.ray_hits_pinhole(o[0], d, soa, 50)
    C.min_dists(o, d, torch.ones(64, dtype=torch.bool))
    blocked = torch.zeros((4, 5, 6), dtype=torch.bool)
    dist = G.bfs_distance_field(blocked, torch.tensor([1, 2]), 5, 6)
    G.extract_path(dist, blocked, torch.tensor([4, 5]), 5, 6, max_len=8)
    n2 = torch.tensor([50, 0], dtype=torch.int32)
    R.render_depth_scenes(torch.stack([soa, soa]), n2,
                          torch.eye(3).expand(2, 1, 3, 3),
                          torch.zeros(2, 1, 3),
                          CameraIntrinsics(4, 6, 60.0, 0.1, 100.0))
    C.coverage_percentage_scenes(torch.stack([o, o]), torch.stack([d, d]),
                                 torch.tensor([64, 3], dtype=torch.int32),
                                 torch.tensor([1, 0]), torch.tensor([2, 1]),
                                 torch.ones((2, 64), dtype=torch.bool))
    dists = G.bfs_distance_field_scenes(torch.stack([blocked, blocked]),
                                        torch.tensor([[1, 2], [0, 0]]), 5, 6)
    G.extract_path_scenes(dists, torch.stack([blocked, blocked]),
                          torch.tensor([[4, 5], [2, 2]]), 5, 6, max_len=8)
    TorchDraws(0, torch.device("cpu")).gumbels("gain", [(3, 5), (3, 5)])
    assert kernels.LAUNCHES == {"ray_hits_pinhole": 0, "ray_hits": 0,
                                "min_sq_dists": 0, "bfs_field": 0,
                                "extract_path": 0,
                                "ray_hits_pinhole_scenes": 0,
                                "min_sq_dists_scenes": 0,
                                "bfs_field_scenes": 0,
                                "extract_path_scenes": 0,
                                "gumbel_noise": 0, "gumbel_argmax": 0}


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
    """K3 at the edges of its work split: GT counts around the points an
    item holds, and sample counts around a chunk boundary of the plan
    (``min_sq_dists_plan`` at each count), against the plain version, bit
    for bit. The main path's 20000 x 40960 is one case."""
    _need_card()
    n_s = 40960
    block = kernels.K3_POINTS_PER_ITEM
    n_g = {"one": 1, "block-1": block - 1, "block+1": block + 1,
           "main": 20000}[g_case]
    n_blocks = kernels.min_sq_dists_blocks()
    rng = np.random.default_rng(n_g)
    g = torch.from_numpy(rng.uniform(-30, 30, (n_g, 3)).astype(np.float32)).cuda()
    s = torch.from_numpy(rng.uniform(-30, 30, (n_s, 3)).astype(np.float32)).cuda()
    chunk = kernels.min_sq_dists_plan([n_s], n_g, n_s, n_blocks)["chunk"]
    for count in (0, 1, 63, 65, 127, 129, 1023, 1025, chunk - 1, chunk + 1,
                  min(2 * chunk, n_s) - 1, n_s):
        plan = kernels.min_sq_dists_plan([count], n_g, n_s, n_blocks)
        assert plan["chunk"] % kernels.K3_TILE == 0
        count_t = torch.tensor(count, device="cuda")
        got = kernels.min_sq_dists(g, s, count_t)
        want = C.min_sq_dists_plain(g, s, count)
        assert torch.equal(got, want), (n_g, count, plan["chunk"])
        dev_plan = kernels.min_sq_dists_device_plan(
            count_t.reshape(1).to(torch.int32), n_g, n_s)
        assert dev_plan.tolist() == [0, plan["chunk"]] + plan["prefix"]


def _ragged_scenes(counts, n_g=2500, n_s=3000, seed=0):
    rng = np.random.default_rng(seed)
    b = len(counts)
    g = torch.from_numpy(rng.uniform(-40, 40, (b, n_g, 3)).astype(np.float32))
    s = torch.from_numpy(rng.uniform(-40, 40, (b, n_s, 3)).astype(np.float32))
    s = torch.where((torch.arange(n_s) < torch.tensor(counts)[:, None])[..., None],
                    s, torch.full_like(s, 1e9))
    return g.cuda(), s.contiguous().cuda(), torch.tensor(counts, dtype=torch.int32).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("counts", [[3000], [0], [1, 128, 0, 3000, 129, 2999],
                                    [40, 0, 0, 7, 3000, 1, 255, 256]])
def test_min_sq_dists_scenes_ragged_counts_on_card(counts):
    """K3 over scenes at ragged valid counts (0, 1, a tile and past it, the
    capacity) against its plain version and against single launches, bit
    for bit; the device plan's chunk and prefix equal the host model's."""
    _need_card()
    g, s, c = _ragged_scenes(counts)
    kernels.reset_launch_counts()
    got = kernels.min_sq_dists_scenes(g, s, c)
    assert kernels.LAUNCHES["min_sq_dists_scenes"] == 1
    assert torch.equal(got, C.min_sq_dists_scenes_plain(g, s, c))
    single = torch.stack([kernels.min_sq_dists(gb, sb, cb) for gb, sb, cb in zip(g, s, c)])
    assert torch.equal(got, single)
    plan = kernels.min_sq_dists_plan(counts, g.shape[1], s.shape[1],
                                     kernels.min_sq_dists_blocks())
    dev_plan = kernels.min_sq_dists_device_plan(c, g.shape[1], s.shape[1])
    assert dev_plan.tolist() == [0, plan["chunk"]] + plan["prefix"]


@pytest.mark.cuda
def test_min_sq_dists_graph_replay_on_card():
    """Two K3 launches captured in one CUDA graph and replayed three times
    equal their plain versions every time: the fill kernel resets the item
    counter, so each replay draws its items from 0."""
    _need_card()
    g, s, c = _ragged_scenes([3000, 12, 0, 2000], seed=3)
    g1, s1, c1 = g[0], s[0], torch.tensor([1500], dtype=torch.int32, device="cuda")
    want_b = C.min_sq_dists_scenes_plain(g, s, c)
    want_1 = C.min_sq_dists_plain(g1, s1, 1500)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernels.min_sq_dists_scenes(g, s, c)
        kernels.min_sq_dists(g1, s1, c1)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_b = kernels.min_sq_dists_scenes(g, s, c)
        out_1 = kernels.min_sq_dists(g1, s1, c1)
    for _ in range(3):
        out_b.zero_()
        out_1.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out_b, want_b)
        assert torch.equal(out_1, want_1)


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(64, 114), (32, 56), (20, 37), (256, 456)])
def test_pinhole_kernel_ragged_tiles_on_card(hw):
    """K1 over a move's four frames of procgen simple/8 at frame sizes that
    are no multiple of the 8 x 16 pixel tile (and 256 x 456) equals its
    plain version bit for bit."""
    _need_card()
    from nextbestpath_tpu_torch.assets import (generate_scene,
                                               pack_generated_scene)
    from nextbestpath_tpu_torch.eval.nbp_planning import main_path_move
    from nextbestpath_tpu_torch.geometry.cameras import get_camera_RT

    a = pack_generated_scene(generate_scene("simple", seed=8))
    intr = CameraIntrinsics(hw[0], hw[1], 60.0, 1.0, 750.0)
    poses = main_path_move(a, 4, "cuda")
    Rm, Tm = get_camera_RT(poses[:, :3], poses[:, 3:])
    eyes, dirs = R.frame_rays(Rm, Tm, intr)
    ph = R.pinhole_tri_soa(R.tris_to_soa(torch.from_numpy(a.tris).cuda()), eyes)
    nt = torch.tensor([a.n_tris], dtype=torch.int32, device="cuda")
    got = kernels.ray_hits_pinhole(dirs.contiguous(), ph, nt, 1.0, 750.0,
                                   hw[1])
    want = R.ray_hits_pinhole_plain(dirs.contiguous(), ph, a.n_tris, 1.0, 750.0)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert bool((got[0] < 3.4e38).any())


@pytest.mark.cuda
@pytest.mark.parametrize("width", [3, 0, -5])
def test_pinhole_launcher_refuses_a_width_that_does_not_divide(width):
    _need_card()
    dirs = torch.zeros(1, 10, 3, device="cuda")
    ph = torch.zeros(1, 10, 4, device="cuda")
    with pytest.raises(ValueError, match="width"):
        kernels.ray_hits_pinhole(dirs, ph, 4, 0.0, 1.0, width)


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
    got = kernels.ray_hits_pinhole(dirs, ph, nt, 1e-4, 3.4e38, 5003)
    assert kernels.LAUNCHES["ray_hits_pinhole"] == 1
    want = R.ray_hits_pinhole_plain(dirs, ph, n_tris, 1e-4, 3.4e38)
    for g, w in zip(got, want):
        assert g.shape == (n_frames, 5003)
        assert torch.equal(g, w)
    if n_tris:
        assert bool((got[1] > 0).any())


def _k2_lanes_expected(n_rays: int, n_sm: int) -> int:
    g = 1
    while g < 32 and n_rays * g < n_sm * 16 * 32:
        g *= 2
    return g


def _k2_against_plain(o, d, soa, n_tris, t_min=1e-6, t_max=3.4e38):
    kernels.reset_launch_counts()
    nt = torch.tensor([n_tris], dtype=torch.int32, device="cuda")
    got = kernels.ray_hits(o, d, soa, nt, t_min, t_max)
    assert kernels.LAUNCHES["ray_hits"] == 1
    want = R.ray_hits_plain(o, d, soa, n_tris, t_min, t_max)
    for g, w in zip(got, want):
        assert g.shape == (o.shape[0],)
        assert torch.equal(g, w)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n_tris", [0, 1, 252, 257, 2784])
@pytest.mark.parametrize("n_rays", [1, 31, 289, 2023, 23548, 116736])
def test_general_kernel_lanes_and_tiles_on_card(n_rays, n_tris):
    """K2 at the ray counts of the planner's and the later per-frame casts
    (on an H100's 132 SMs they take G = 32, 32, 32, 32, 4 and 1 lanes a
    ray; test_general_kernel_every_lane_count_on_card takes the others) and
    triangle counts at the edges of its 256-triangle tile, read from the
    device, equals its plain version bit for bit."""
    _need_card()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    assert kernels.ray_hits_lanes(n_rays) == _k2_lanes_expected(n_rays, n_sm)
    tris, o, d = _rays(2784, n_rays, seed=n_rays + n_tris)
    soa = R.tris_to_soa(tris).cuda()
    t, cnt, idx = _k2_against_plain(o.cuda(), d.cuda(), soa, n_tris)
    if n_tris >= 252 and n_rays >= 289:
        assert bool((cnt > 1).any()) and bool((idx >= 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
def test_general_kernel_every_lane_count_on_card(lanes):
    """Each lane count G that K2 can take, at the least ray count that
    selects it on this card (from its SM count), equals its plain version
    bit for bit."""
    _need_card()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    n_rays = -(-n_sm * 16 * 32 // lanes)
    assert kernels.ray_hits_lanes(n_rays) == lanes
    assert _k2_lanes_expected(n_rays, n_sm) == lanes
    tris, o, d = _rays(300, n_rays, seed=lanes)
    soa = R.tris_to_soa(tris).cuda()
    t, cnt, idx = _k2_against_plain(o.cuda(), d.cuda(), soa, 257)
    assert bool((cnt > 1).any()) and bool((idx >= 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("n_rays", [31, 2023, 116736])
def test_general_kernel_ties_take_lower_index_on_card(n_rays):
    """Every triangle twice, the copies 300 apart (so a ray's G lanes split
    them) and the SoA padded past the count: the nearest index is the lower
    copy's, as the plain version's, whatever G is."""
    _need_card()
    tris, o, d = _rays(300, n_rays, seed=7)
    soa = R.tris_to_soa(torch.cat([tris, tris, tris[:5]])).cuda()
    t, cnt, idx = _k2_against_plain(o.cuda(), d.cuda(), soa, 600)
    hit = idx >= 0
    assert bool(hit.any())
    assert bool((idx[hit] < 300).all())
    assert bool((cnt[hit] % 2 == 0).all())


@pytest.mark.cuda
def test_general_kernel_scene_table_rays_on_card():
    """The rays of simple/8's tables (sim/tables.py::table_rays), which
    graze the shared edges of the procgen walls, in the one launch of
    build_scene_tables."""
    _need_card()
    from nextbestpath_tpu_torch.assets import (generate_scene,
                                               pack_generated_scene)
    from nextbestpath_tpu_torch.planning.grid_paths import lattice_positions
    from nextbestpath_tpu_torch.sim.tables import table_rays

    a = pack_generated_scene(generate_scene("simple", seed=8))
    pos = lattice_positions(torch.from_numpy(a.pose_origin).cuda(),
                            a.pose_l, a.pose_h)
    o, d = table_rays(pos)
    soa = R.tris_to_soa(torch.from_numpy(a.tris).cuda())
    t, cnt, _ = _k2_against_plain(o.contiguous(), d.contiguous(), soa,
                                  a.n_tris)
    assert o.shape[0] == 7 * a.pose_l * a.pose_h
    assert bool((cnt > 0).any()) and bool((t < 1.0).any())


@pytest.mark.cuda
def test_rollout_turns_tf32_off_on_card():
    """NBPPlanningRollout on the card runs the U-Net's convolutions with
    cuDNN's TF32 off whatever the caller set, and the caller's flags are
    back after the run."""
    _need_card()
    from nextbestpath_tpu_torch.assets import (generate_scene,
                                               pack_generated_scene)
    from nextbestpath_tpu_torch.config import default_params
    from nextbestpath_tpu_torch.eval.nbp_planning import NBPPlanningRollout
    from nextbestpath_tpu_torch.models.unet import NBP

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        p = default_params(image_height=32, image_width=56, points_per_frame=256,
                           full_pc_capacity=65536, n_gt_surface_points=2048,
                           max_path_len=32, pc2img_size=[64, 64],
                           value_map_size=[16, 16])
        a = pack_generated_scene(generate_scene("simple", seed=4), params=p)
        model = NBP(width=4)
        seen = []
        model.conv_blocks[0].register_forward_pre_hook(
            lambda *_: seen.append(torch.backends.cudnn.allow_tf32))
        NBPPlanningRollout(a, model, params=p, shared_rng=True,
                           device="cuda").run(n_poses=1)
        assert seen and not any(seen)
        assert torch.backends.cudnn.allow_tf32 is True
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


@pytest.mark.cuda
def test_launchers_check_dtype_and_shape_on_card():
    _need_card()
    x = torch.zeros(4, 3, device="cuda")
    with pytest.raises(ValueError, match="float32"):
        kernels.min_sq_dists(x.double(), x, 4)
    with pytest.raises(ValueError, match="shape"):
        kernels.ray_hits_pinhole(x, torch.zeros(1, 10, 4, device="cuda"), 4, 0.0, 1.0, 4)
    with pytest.raises(ValueError, match="shape"):
        kernels.ray_hits_pinhole(x[None], torch.zeros(1, 9, 4, device="cuda"), 4, 0.0, 1.0, 4)
    with pytest.raises(ValueError, match="shape"):
        kernels.ray_hits_pinhole(x[None], torch.zeros(2, 10, 4, device="cuda"), 4, 0.0, 1.0, 4)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.ray_hits(x, torch.zeros(3, 4, device="cuda").T, torch.zeros(9, 4, device="cuda"), 4, 0.0, 1.0)


# ---------------------------------------------------------------------------
# The planner kernels (csrc/plan.cu) and the captured scan rollout
# ---------------------------------------------------------------------------


def _lattice(case, L, H, seed=0):
    """(4, L, H) bool edge-blocked masks: an open grid, a serpentine maze
    (one opening a row, alternating ends), random blocks, or a walled
    start (nothing reachable)."""
    blocked = np.zeros((4, L, H), bool)
    if case == "maze":
        for j in range(H - 1):
            open_row = (L - 1) if j % 2 == 0 else 0
            for i in range(L):
                if i != open_row:
                    blocked[2, i, j] = True
                    blocked[3, i, j + 1] = True
    elif case == "random":
        blocked = np.random.default_rng(seed).random((4, L, H)) < 0.3
    elif case == "walled":
        blocked[:] = True
    return torch.from_numpy(blocked)


@pytest.mark.parametrize("shape", [(1, 1), (65, 64), (4097, 1)])
def test_plan_launchers_refuse_large_lattices(shape):
    """On CPU tensors the planner launchers refuse every lattice, the large
    ones included, before they build or read the kernels' limits: a CPU
    tensor is the plain version's (planning/grid_paths.py), never the
    launcher's. The limits themselves, which csrc/plan.cu holds, are held
    on the card (test_plan_kernels_refuse_large_lattice_on_card)."""
    L, H = shape
    blocked = torch.zeros((4, L, H), dtype=torch.bool)
    start = torch.zeros(2, dtype=torch.int64)
    dist = torch.zeros((L, H), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.bfs_field(blocked, start)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.extract_path(dist, blocked, start, 8)


def _procgen_lattice(difficulty, seed=8):
    """The GT edge table (4, L, H) of a procgen scene, built on the card
    (K2), and its start node."""
    from nextbestpath_tpu_torch.assets import (generate_scene,
                                               pack_generated_scene)
    from nextbestpath_tpu_torch.sim.tables import build_scene_tables

    a = pack_generated_scene(generate_scene(difficulty, seed=seed))
    soa = R.tris_to_soa(torch.from_numpy(a.tris).cuda())
    t = build_scene_tables(soa, torch.tensor([a.n_tris], dtype=torch.int32,
                                             device="cuda"),
                           torch.from_numpy(a.pose_origin).cuda(), a.pose_l,
                           a.pose_h)
    return (t.gt_edge_blocked.cpu().contiguous(),
            (int(a.start_cam_idx[0]), int(a.start_cam_idx[2])))


# The one-warp shapes (bits along h or along l, 1 to 2 rows a lane) and the
# long thin ones of the block path, then the procgen GT lattices.
PLAN_SHAPES = [(10, 10), (17, 17), (58, 58), (64, 64), (3, 41), (41, 3),
               (4096, 1), (1, 4096)]
PLAN_LATTICES = ([(case, shape) for case in ("open", "maze", "random",
                                             "walled")
                  for shape in PLAN_SHAPES]
                 + [("hard", None), ("insane", None)])


@pytest.mark.cuda
@pytest.mark.parametrize("case,shape", PLAN_LATTICES,
                         ids=[f"{c}-{s[0]}x{s[1]}" if s else c
                              for c, s in PLAN_LATTICES])
def test_plan_kernels_equal_plain_versions_on_card(case, shape):
    """nbp_bfs_field and nbp_extract_path against their plain versions:
    the field for two starts, and the path to a near goal, the far corner
    (past max_len in the maze), the farthest reachable node, the start
    itself and two goals off the lattice, at max_len 8 and 96; then the
    scene axis over B = 4 starts with mixed skip flags. Both are
    integer-exact."""
    _need_card()
    from nextbestpath_tpu_torch.planning import grid_paths as G

    if shape is None:
        blocked, first = _procgen_lattice(case)
        L, H = blocked.shape[1:]
    else:
        L, H = shape
        blocked = _lattice(case, L, H, seed=L * H)
        first = (0, 0)
    starts = (first, (L // 2, H // 3))
    kernels.reset_launch_counts()
    runs = 0
    for start in starts:
        s = torch.tensor(start, dtype=torch.int64)
        want = G.bfs_distance_field_plain(blocked, s, L, H)
        got = G.bfs_distance_field(blocked.cuda(), s.cuda(), L, H)
        assert torch.equal(got.cpu(), want), (case, shape, start)
        runs += 1
        reach = want < G.INF
        far = int(torch.argmax(torch.where(reach, want, -1)))
        for goal in ((min(2, L - 1), min(1, H - 1)), (L - 1, H - 1),
                     (far // H, far % H), start, (-1, 0), (L, H)):
            g = torch.tensor(goal, dtype=torch.int64)
            for max_len in (8, 96):
                pw, lw, rw = G.extract_path_plain(want, blocked, g, L, H,
                                                  max_len)
                pk, lk, rk = G.extract_path(got, blocked.cuda(), g.cuda(), L,
                                            H, max_len)
                assert torch.equal(pk.cpu(), pw), (case, shape, start, goal)
                assert int(lk) == int(lw) and bool(rk) == bool(rw)
                runs += 1
    assert kernels.LAUNCHES["bfs_field"] == 2
    assert kernels.LAUNCHES["extract_path"] == runs - 2
    B = 4
    bs = blocked.expand(B, 4, L, H).contiguous()
    st = torch.tensor([first, (L // 2, H // 3), (L - 1, 0), first],
                      dtype=torch.int64)
    goal = torch.tensor([(L - 1, H - 1), (0, 0), (L // 3, H - 1),
                         (L // 2, H // 2)], dtype=torch.int64)
    for skip in ([False, True, False, True], [True] * B, [False] * B):
        k = torch.tensor(skip)
        want_d = G.bfs_distance_field_scenes_plain(bs, st, L, H, k)
        got_d = G.bfs_distance_field_scenes(bs.cuda(), st.cuda(), L, H,
                                            k.cuda())
        assert torch.equal(got_d.cpu(), want_d), (case, shape, skip)
        want_p = G.extract_path_scenes_plain(want_d, bs, goal, L, H, 96, k)
        got_p = G.extract_path_scenes(got_d, bs.cuda(), goal.cuda(), L, H,
                                      96, k.cuda())
        for gk, wk in zip(got_p, want_p):
            assert torch.equal(gk.cpu(), wk), (case, shape, skip)
    assert kernels.LAUNCHES["bfs_field_scenes"] == 3
    assert kernels.LAUNCHES["extract_path_scenes"] == 3


@pytest.mark.cuda
def test_plan_kernels_refuse_large_lattice_on_card():
    """The limits that csrc/plan.cu holds, read through nbp_plan_limits: a
    lattice past 4096 nodes or a path buffer outside [1, 1024] is refused
    with the limit named, and never handed to the plain version."""
    _need_card()
    from nextbestpath_tpu_torch.planning import grid_paths as G

    assert kernels.plan_limits() == {"nodes": 4096, "path": 1024}
    start = torch.zeros(2, dtype=torch.int64, device="cuda")
    for L, H in ((65, 64), (4097, 1)):
        blocked = torch.zeros((4, L, H), dtype=torch.bool, device="cuda")
        dist = torch.zeros((L, H), dtype=torch.int32, device="cuda")
        with pytest.raises(ValueError, match="at most 4096"):
            G.bfs_distance_field(blocked, start, L, H)
        with pytest.raises(ValueError, match="at most 4096"):
            G.extract_path(dist, blocked, start, L, H, max_len=8)
    blocked = torch.zeros((4, 8, 8), dtype=torch.bool, device="cuda")
    dist = torch.zeros((8, 8), dtype=torch.int32, device="cuda")
    for max_len in (0, 1025):
        with pytest.raises(ValueError, match=r"\[1, 1024\]"):
            kernels.extract_path(dist, blocked, start, max_len)


def _small_scan(device, graphs=True, **options):
    from nextbestpath_tpu_torch.assets import (generate_scene,
                                               pack_generated_scene)
    from nextbestpath_tpu_torch.config import default_params
    from nextbestpath_tpu_torch.draws import TorchDraws
    from nextbestpath_tpu_torch.eval.nbp_planning import seeded_nbp
    from nextbestpath_tpu_torch.eval.scan_rollout import ScanRollout

    p = default_params(image_height=32, image_width=56, points_per_frame=256,
                       full_pc_capacity=65536, n_gt_surface_points=2048,
                       max_path_len=32, pc2img_size=[64, 64],
                       value_map_size=[16, 16], **options)
    a = pack_generated_scene(generate_scene("normal", seed=3), params=p)
    dev = torch.device(device)
    roll = ScanRollout(a, seeded_nbp(), params=p, device=dev,
                       draws=TorchDraws(8, dev, "cpu"))
    roll._use_graphs = graphs and dev.type == "cuda"
    return roll


@pytest.mark.cuda
def test_scan_rollout_captures_its_step_on_card():
    """The scan rollout's step captured as CUDA graphs (a capture fails on
    any host sync left in the step) equals the same step run eagerly on
    the card, bit for bit, and the CPU's within 1e-3 with the same
    trajectory; each pose launches K1 twice and K3 once, and the planner
    kernels max_plan_retries times each on regeneration poses only."""
    _need_card()
    n = 8
    runs = {}
    for label, dev, graphs in (("graphs", "cuda", True),
                               ("eager", "cuda", False), ("cpu", "cpu", False)):
        roll = _small_scan(dev, graphs)
        roll.run(n_poses=2)
        kernels.reset_launch_counts()
        res = roll.run(n_poses=n)
        runs[label] = (res, dict(kernels.LAUNCHES), list(roll.regen_poses),
                       roll.state.pc.points[:res.n_points].cpu())
    (g, lg, rg, pg), (e, le, re_, pe), (c, _, rc, _) = (
        runs["graphs"], runs["eager"], runs["cpu"])
    assert g.coverage_evolution == e.coverage_evolution
    assert np.array_equal(g.cam_positions, e.cam_positions)
    assert g.n_points == e.n_points and torch.equal(pg, pe)
    assert rg == re_ == rc and rg[0] and not all(rg)
    assert lg == le
    k = sum(rg)
    assert lg == {"ray_hits_pinhole": 1 + 2 * n, "ray_hits": 0,
                  "min_sq_dists": n, "bfs_field": 4 * k, "extract_path": 4 * k,
                  "ray_hits_pinhole_scenes": 0, "min_sq_dists_scenes": 0,
                  "bfs_field_scenes": 0, "extract_path_scenes": 0}
    np.testing.assert_allclose(g.coverage_evolution, c.coverage_evolution,
                               atol=1e-3)
    np.testing.assert_allclose(g.cam_positions, c.cam_positions, atol=1e-4)
    assert g.n_points == c.n_points


@pytest.mark.cuda
def test_scan_rollout_capture_options_on_card():
    """The scan with the stratified draw and the batched capture: captured
    as CUDA graphs it equals the same step run eagerly on the card bit for
    bit, and the CPU's within 1e-3 with the same trajectory."""
    _need_card()
    opts = dict(stratified_sampling=True, batched_capture=True)
    runs = {}
    for label, dev, graphs in (("graphs", "cuda", True),
                               ("eager", "cuda", False), ("cpu", "cpu", False)):
        roll = _small_scan(dev, graphs, **opts)
        assert roll.stratified and roll.batched_capture
        res = roll.run(n_poses=8)
        runs[label] = (res, list(roll.regen_poses),
                       roll.state.pc.points[:res.n_points].cpu())
    (g, rg, pg), (e, re_, pe), (c, rc, _) = (runs[k] for k in
                                             ("graphs", "eager", "cpu"))
    assert g.coverage_evolution == e.coverage_evolution
    assert np.array_equal(g.cam_positions, e.cam_positions)
    assert g.n_points == e.n_points and torch.equal(pg, pe)
    assert rg == re_ == rc
    np.testing.assert_allclose(e.coverage_evolution, c.coverage_evolution,
                               atol=1e-3)
    np.testing.assert_allclose(e.cam_positions, c.cam_positions, atol=1e-4)
    assert e.n_points == c.n_points


@pytest.mark.cuda
def test_bf16_unet_on_card():
    """The bf16 U-Net on the card: its convolutions return bf16, its
    outputs are f32 and within 1e-2 of the same forward on the CPU and
    within 0.05 of the f32 forward of the same weights, folded or not."""
    _need_card()
    from nextbestpath_tpu_torch.models.fold import fold_bn
    from nextbestpath_tpu_torch.models.unet import NBP, Conv

    x = torch.rand(1, 64, 64, 5, generator=torch.Generator().manual_seed(0))
    for fold in (False, True):
        torch.manual_seed(1)
        m32 = NBP(width=16).eval()
        m16 = NBP(width=16, dtype=torch.bfloat16).eval()
        m16.load_state_dict(m32.state_dict())
        if fold:
            m32, m16 = fold_bn(m32), fold_bn(m16)
        outs = {}
        for label, m, dev in (("bf16", m16, "cuda"), ("bf16_cpu", m16, "cpu"),
                              ("f32", m32, "cuda")):
            seen = []
            hooks = [c.register_forward_hook(
                lambda mod, i, o: seen.append(o.dtype))
                for c in m.modules() if isinstance(c, Conv)]
            with torch.no_grad():
                outs[label] = [t.cpu() for t in m.to(dev)(x.to(dev))]
            for h in hooks:
                h.remove()
            assert set(seen) == {torch.float32 if label == "f32"
                                 else torch.bfloat16}
        for a, b in zip(outs["bf16"], outs["bf16_cpu"]):
            assert a.dtype == torch.float32
            torch.testing.assert_close(a, b, rtol=0, atol=1e-2)
        for a, b in zip(outs["bf16"], outs["f32"]):
            torch.testing.assert_close(a, b, rtol=0, atol=0.05)


def _train_data(n, size, seed):
    from nextbestpath_tpu_torch.train.replay import Experience

    rng = np.random.default_rng(seed)
    return [Experience(
        model_input=(rng.random((5, size, size)) * 3).astype(np.float16),
        gt_layout=(rng.random((size, size)) > 0.7).astype(np.uint8),
        pixels=np.stack([rng.integers(0, 8, 4), rng.integers(0, size // 4, 4),
                         rng.integers(0, size // 4, 4)], 1).astype(np.int32),
        gains=(rng.random(4) * 5).astype(np.float32), pose_i=12)
        for _ in range(n)]


@pytest.mark.cuda
def test_train_step_turns_tf32_off_on_card():
    """The training step on the card: forward, backward and the optimizer
    step run with cuDNN's TF32 off whatever the caller set, the caller's
    flags are back after each micro step, and the parameters move on the
    k-th micro step only. The micro step is a CUDA graph from its second
    call on, so the hooks fire on the eager and capture calls (the
    forward's and the gradient's, twice each) and at the optimizer step;
    the second and third calls replay. One accumulation cycle in f64
    equals the CPU's within rtol 1e-4 (parameters and batch
    statistics)."""
    _need_card()
    import random

    from nextbestpath_tpu_torch.models.unet import as_float64
    from nextbestpath_tpu_torch.train import train_nbp as TT
    from nextbestpath_tpu_torch.train.driver import seeded_train_model
    from nextbestpath_tpu_torch.utils import timing

    data = _train_data(6, 64, 0)
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        model = seeded_train_model(1, width=8).cuda()
        st = TT.init_train_state(model, accumulation_steps=3)
        ds, _ = TT.build_device_dataset(data, torch.device("cuda"))
        seen = []
        model.final2.register_forward_hook(
            lambda *a: seen.append(torch.backends.cudnn.allow_tf32))
        model.conv_blocks[0].conv0.weight.register_hook(
            lambda g: seen.append(torch.backends.cudnn.allow_tf32))
        st.optimizer.register_step_pre_hook(
            lambda *a: seen.append(torch.backends.cudnn.allow_tf32))
        w0 = model.final1.weight.detach().clone()
        with timing.run("t") as rec:
            for i, (idx, sw) in enumerate(TT._micro_chunks(
                    list(range(6)), 2, device=torch.device("cuda"))):
                TT._train_step_ds(st, ds, idx, sw)
                assert torch.backends.cudnn.allow_tf32 is True
                assert torch.backends.cuda.matmul.allow_tf32 is True
                assert torch.equal(model.final1.weight, w0) == (i < 2)
        assert len(seen) == 5 and not any(seen)
        assert rec.counts == {"graph_captures": 1, "graph_replays": 2}
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    out = {}
    for dev in ("cuda", "cpu"):
        m = as_float64(seeded_train_model(1, width=8)).to(dev)
        st = TT.init_train_state(m, accumulation_steps=3)
        ds, _ = TT.build_device_dataset(data, torch.device(dev))
        TT.train_epoch_ds(st, ds, list(range(6)), random.Random(0),
                          micro_batch=2)
        out[dev] = {k: v.cpu() for k, v in m.state_dict().items()}
    for k, want in out["cpu"].items():
        torch.testing.assert_close(out["cuda"][k], want, rtol=1e-4,
                                   atol=1e-10, msg=k)


@pytest.mark.cuda
def test_scan_rollout_captures_insane_on_card():
    """The scan rollout on the procgen ``insane`` scene (seed 8, a 58x58
    lattice whose corridors wind) at the small config: captured as CUDA
    graphs it equals the same step run eagerly on the card bit for bit,
    with the same launches (max_plan_retries of each planner kernel a
    regeneration pose, the attempts after a done one skipped on the
    device)."""
    _need_card()
    from nextbestpath_tpu_torch.assets import (generate_scene,
                                               pack_generated_scene)
    from nextbestpath_tpu_torch.config import default_params
    from nextbestpath_tpu_torch.draws import TorchDraws
    from nextbestpath_tpu_torch.eval.nbp_planning import seeded_nbp
    from nextbestpath_tpu_torch.eval.scan_rollout import ScanRollout

    p = default_params(image_height=32, image_width=56, points_per_frame=256,
                       full_pc_capacity=65536, n_gt_surface_points=2048,
                       max_path_len=32, pc2img_size=[64, 64],
                       value_map_size=[16, 16])
    a = pack_generated_scene(generate_scene("insane", seed=8), params=p)
    assert (a.pose_l, a.pose_h) == (58, 58)
    dev = torch.device("cuda")
    runs = {}
    for graphs in (True, False):
        roll = ScanRollout(a, seeded_nbp(), params=p, device=dev,
                           draws=TorchDraws(8, dev, "cpu"))
        roll._use_graphs = graphs
        roll.run(n_poses=2)
        kernels.reset_launch_counts()
        res = roll.run(n_poses=8)
        runs[graphs] = (res, dict(kernels.LAUNCHES), list(roll.regen_poses),
                        roll.state.pc.points[:res.n_points].cpu())
    (g, lg, rg, pg), (e, le, re_, pe) = runs[True], runs[False]
    assert g.coverage_evolution == e.coverage_evolution
    assert np.array_equal(g.cam_positions, e.cam_positions)
    assert g.n_points == e.n_points and torch.equal(pg, pe)
    assert rg == re_ and rg[0]
    assert lg == le
    assert lg["bfs_field"] == lg["extract_path"] == 4 * sum(rg)


# ---------------------------------------------------------------------------
# The scene axis: K1, K3 and the planner kernels over B scenes, the
# collection's capture (ROADMAP C.2) and the multi-scene modes
# ---------------------------------------------------------------------------


def _scene_inputs(kernel, n_scenes, seed=0):
    """Seeded inputs of one scene-axis launcher on the card, with unequal
    counts (one of them 0) and padding past them."""
    gen = torch.Generator().manual_seed(seed)
    counts = torch.tensor([(0, 700, 257, 1, 512, 650, 3, 699)[b % 8]
                           for b in range(n_scenes)], dtype=torch.int32)
    if kernel == "pinhole":
        soas, dirs = [], []
        for b in range(n_scenes):
            tris, o, d = _rays(700, 1500, seed=seed + b)
            soa = R.tris_to_soa(tris)
            soa[:, int(counts[b]):] = 1e8
            soas.append(R.pinhole_tri_soa(soa, o[0]))
            dirs.append(d)
        return (torch.stack(dirs).cuda(), torch.stack(soas).cuda(),
                counts.cuda())
    if kernel == "min_sq":
        g = torch.rand((n_scenes, 3000, 3), generator=gen) * 200 - 100
        s = torch.rand((n_scenes, 2048, 3), generator=gen) * 200 - 100
        c = torch.tensor([(0, 2048, 1023, 1, 2000, 5, 1500, 777)[b % 8]
                          for b in range(n_scenes)], dtype=torch.int32)
        s = torch.where((torch.arange(2048) < c[:, None])[..., None], s,
                        torch.full_like(s, 1e9))
        return g.cuda(), s.contiguous().cuda(), c.cuda()
    L, H = (17, 17) if kernel == "bfs" else (58, 58)
    cases = ("open", "maze", "random", "walled")
    blocked = torch.stack([_lattice(cases[b % 4], L, H, seed=seed + b)
                           for b in range(n_scenes)])
    start = torch.tensor([[b % L, (2 * b) % H] for b in range(n_scenes)],
                         dtype=torch.int64)
    return blocked.cuda(), start.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("n_scenes", [1, 4, 8])
@pytest.mark.parametrize("kernel", ["pinhole", "min_sq", "bfs", "path"])
def test_scene_kernels_equal_plain_versions_on_card(kernel, n_scenes):
    """Each scene-axis launch against its plain version (each scene's own
    plain call, stacked) and against a stack of today's single-scene
    launches, bit for bit, with one count a launch; path at a 58x58 maze
    and random lattices, past max_len."""
    _need_card()
    from nextbestpath_tpu_torch.planning import grid_paths as G

    args = _scene_inputs(kernel, n_scenes)
    kernels.reset_launch_counts()
    if kernel == "pinhole":
        dirs, ph, counts = args
        got = kernels.ray_hits_pinhole_scenes(dirs, ph, counts, 1e-4, 3.4e38,
                                              50)
        want = R.ray_hits_pinhole_scenes_plain(
            dirs, ph, counts, 1e-4, 3.4e38)
        single = [kernels.ray_hits_pinhole(d[None], p[None], c, 1e-4, 3.4e38,
                                           50)
                  for d, p, c in zip(dirs, ph, counts)]
        single = tuple(torch.cat([x[i] for x in single]) for i in range(3))
        key = "ray_hits_pinhole"
    elif kernel == "min_sq":
        g, s, c = args
        got = (kernels.min_sq_dists_scenes(g, s, c),)
        want = (C.min_sq_dists_scenes_plain(g, s, c),)
        single = (torch.stack([kernels.min_sq_dists(gb, sb, cb)
                               for gb, sb, cb in zip(g, s, c)]),)
        key = "min_sq_dists"
    else:
        blocked, start = args
        L, H = blocked.shape[2:]
        dist = kernels.bfs_field_scenes(blocked, start)
        want_d = G.bfs_distance_field_scenes_plain(blocked, start, L, H)
        if kernel == "bfs":
            got, want = (dist,), (want_d,)
            single = (torch.stack([kernels.bfs_field(b, s)
                                   for b, s in zip(blocked, start)]),)
            key = "bfs_field"
        else:
            assert torch.equal(dist, want_d)
            goal = torch.tensor([[L - 1, H - 1], [1, 0], [L // 2, H // 2],
                                 [0, 0]] * 2, dtype=torch.int64,
                                device="cuda")[:n_scenes]
            path, meta = kernels.extract_path_scenes(dist, blocked, goal, 96)
            got = (path, meta[:, 0], meta[:, 1] != 0)
            want = G.extract_path_scenes_plain(dist, blocked, goal, L, H, 96)
            outs = [kernels.extract_path(d, b, g, 96)
                    for d, b, g in zip(dist, blocked, goal)]
            single = (torch.stack([o[0] for o in outs]),
                      torch.stack([o[1][0] for o in outs]),
                      torch.stack([o[1][1] != 0 for o in outs]))
            key = "extract_path"
    for gk, wk, sk in zip(got, want, single):
        assert torch.equal(gk, wk.to(gk.device)), kernel
        assert torch.equal(gk, sk), kernel
    assert kernels.LAUNCHES[key + "_scenes"] == 1
    assert kernels.LAUNCHES[key] == n_scenes


@pytest.mark.cuda
def test_scene_launchers_check_shapes_on_card():
    _need_card()
    x = torch.zeros(2, 4, 3, device="cuda")
    with pytest.raises(ValueError, match="int32"):
        kernels.ray_hits_pinhole_scenes(
            x, torch.zeros(2, 10, 4, device="cuda"),
            torch.zeros(2, dtype=torch.int64, device="cuda"), 0.0, 1.0, 4)
    with pytest.raises(ValueError, match="shape"):
        kernels.min_sq_dists_scenes(
            x, torch.zeros(3, 4, 3, device="cuda"),
            torch.zeros(2, dtype=torch.int32, device="cuda"))
    with pytest.raises(ValueError, match="shape"):
        kernels.bfs_field_scenes(
            torch.zeros((2, 4, 3, 3), dtype=torch.bool, device="cuda"),
            torch.zeros((3, 2), dtype=torch.int64, device="cuda"))


TINY_CARD = dict(image_height=32, image_width=56, points_per_frame=256,
                 full_pc_capacity=32768, n_gt_surface_points=1024,
                 max_path_len=32, pc2img_size=[64, 64],
                 value_map_size=[16, 16])


def _tiny_scenes(seeds, difficulty="simple"):
    from nextbestpath_tpu_torch.assets import (generate_scene,
                                               pack_generated_scene,
                                               pad_assets_to_common)
    from nextbestpath_tpu_torch.config import default_params

    p = default_params(**TINY_CARD)
    return p, pad_assets_to_common([pack_generated_scene(
        generate_scene(difficulty, seed=s), params=p) for s in seeds])


def _cpu_draws(dev):
    from nextbestpath_tpu_torch.draws import TorchDraws

    return lambda s: TorchDraws(s, torch.device(dev), "cpu")


@pytest.mark.cuda
def test_scan_collection_captures_its_step_on_card():
    """ScanCollection at TINY: captured as CUDA graphs it equals the same
    step run eagerly on the card, record for record and bit for bit
    (ROADMAP C.2)."""
    _need_card()
    from nextbestpath_tpu_torch.eval.nbp_planning import seeded_nbp
    from nextbestpath_tpu_torch.train.scan_collection import ScanCollection

    p, scenes = _tiny_scenes((2, 3))
    outs = {}
    for graphs in (True, False):
        m = seeded_nbp()
        coll = ScanCollection(scenes, m, params=p, device="cuda",
                              make_draws=_cpu_draws("cuda"))
        coll._use_graphs = graphs
        outs[graphs] = [coll.run(i, m, seed=4 + i, n_poses=8)
                        for i in range(2)]
        if graphs:
            assert coll.host_reads == 8
    for g, e in zip(outs[True], outs[False]):
        assert all(np.array_equal(a, b) for a, b in zip(g, e))
        assert g.valid.any() and g.planned.any()


@pytest.mark.cuda
def test_batched_rollout_captures_its_step_on_card():
    """The true-batch BatchedScanRollout over three padded scenes (ROADMAP
    C.1): as CUDA graphs it equals the same step run eagerly bit for bit,
    with one flag read a pose, K1 twice and K3 once a pose for all scenes
    and the planner kernels max_plan_retries times on any-regeneration
    poses; three single captured ScanRollouts with the same draws give the
    same trajectories and coverage."""
    _need_card()
    from nextbestpath_tpu_torch.eval.nbp_planning import seeded_nbp
    from nextbestpath_tpu_torch.eval.scan_rollout import (BatchedScanRollout,
                                                          ScanRollout)

    p, scenes = _tiny_scenes((5, 6, 7))
    n = 8
    runs = {}
    for graphs in (True, False):
        kernels.reset_launch_counts()
        b = BatchedScanRollout(scenes, seeded_nbp(), params=p, device="cuda",
                               make_draws=_cpu_draws("cuda"))
        b._use_graphs = graphs
        b.run(n_poses=2, seed=8)
        before = dict(kernels.LAUNCHES)
        res = b.run(n_poses=n, seed=8)
        launches = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        runs[graphs] = (res, list(b.regen_poses), launches, b.host_reads)
    (g, rg, lg, hg), (e, re_, le, _) = runs[True], runs[False]
    assert rg == re_ and hg == n and lg == le
    k = sum(any(f) for f in rg)
    assert lg == dict(dict.fromkeys(lg, 0), ray_hits_pinhole_scenes=1 + 2 * n,
                      min_sq_dists_scenes=n, bfs_field_scenes=4 * k,
                      extract_path_scenes=4 * k)
    for i, (a, sc) in enumerate(zip(scenes, b.scenes)):
        assert g[i].coverage_evolution == e[i].coverage_evolution
        assert np.array_equal(g[i].cam_positions, e[i].cam_positions)
        solo = ScanRollout(a, seeded_nbp(), params=p, scene=sc, device="cuda",
                           draws=_cpu_draws("cuda")(8 + i))
        r = solo.run(n_poses=n)
        assert solo.regen_poses == [f[i] for f in rg]
        assert r.coverage_evolution == g[i].coverage_evolution
        assert np.array_equal(r.cam_positions, g[i].cam_positions)


@pytest.mark.cuda
def test_run_interleaved_matches_single_runs_on_card():
    """run_interleaved over three captured ScanRollouts equals each
    rollout's own run, bit for bit, with one host read a scene and pose."""
    _need_card()
    from nextbestpath_tpu_torch.eval.nbp_planning import seeded_nbp
    from nextbestpath_tpu_torch.eval.scan_rollout import (ScanRollout,
                                                          run_interleaved)

    p, scenes = _tiny_scenes((5, 6, 7))
    rolls = [ScanRollout(a, seeded_nbp(), params=p, device="cuda")
             for a in scenes]
    got = run_interleaved(rolls, n_poses=8, seeds=[3, 1, 2])
    assert all(r.host_reads == 8 for r in rolls)
    for r, s, res in zip(rolls, (3, 1, 2), got):
        want = r.run(n_poses=8, seed=s)
        assert res.coverage_evolution == want.coverage_evolution
        assert np.array_equal(res.cam_positions, want.cam_positions)
        assert res.wall_time_s == got[0].wall_time_s


@pytest.mark.cuda
def test_scan_random_walk_captures_on_card():
    """ScanRandomWalk over three scenes: one captured graph a pose and no
    host read, equal to the eager walk bit for bit; one K1 launch and one
    K3 launch a pose for all scenes."""
    _need_card()
    from nextbestpath_tpu_torch.eval.random_walk import ScanRandomWalk

    p, scenes = _tiny_scenes((5, 6, 7))
    runs = {}
    for graphs in (True, False):
        w = ScanRandomWalk(scenes, params=p, device="cuda",
                           make_draws=_cpu_draws("cuda"))
        w._use_graphs = graphs
        w.run(n_poses=2, seed=3)
        kernels.reset_launch_counts()
        runs[graphs] = (w.run(n_poses=8, seed=3), dict(kernels.LAUNCHES),
                        w.host_reads, dict(w.replays))
    (g, lg, hg, rg), (e, le, _, _) = runs[True], runs[False]
    assert hg == 0 and rg == {"pose": 8} and lg == le
    assert lg["ray_hits_pinhole_scenes"] == 1 + 8
    assert lg["min_sq_dists_scenes"] == 8
    for a, b in zip(g, e):
        assert a.coverage_evolution == b.coverage_evolution
        assert np.array_equal(a.cam_positions, b.cam_positions)
        assert max(a.coverage_evolution[1:]) > a.coverage_evolution[0]


@pytest.mark.cuda
def test_macarons_nbv_on_card_matches_cpu():
    """The MACARONS greedy NBV at 32x56 for 3 poses, learned and oracle,
    and the object NBV, on the card against the CPU with one CPU
    generator's draws: the same picks, coverage within 1e-3; on the card
    K2 once (the tables), K1 once a move (and once a pose for the oracle's
    20 candidate frames), K3 once a pose (and the oracle's covered points
    and its candidates on a scene axis); the object NBV K2 once a view."""
    _need_card()
    from nextbestpath_tpu_torch.assets import (generate_scene,
                                               pack_generated_scene)
    from nextbestpath_tpu_torch.assets.objects import generate_object
    from nextbestpath_tpu_torch.config import default_params
    from nextbestpath_tpu_torch.draws import TorchDraws
    from nextbestpath_tpu_torch.eval.macarons_nbv import (
        NBV_SMALL, NBV_SMALL_TOKENS, macarons_nbv_rollout, seeded_scone)
    from nextbestpath_tpu_torch.eval.object_nbv import object_nbv_rollout

    p = default_params(**NBV_SMALL)
    assets = pack_generated_scene(generate_scene("simple", seed=6), params=p)
    obj = generate_object(seed=6, n_gt_surface_points=512)
    n = 3
    runs = {}
    for dev in ("cuda", "cpu"):
        occ, vis = seeded_scone(small=True)
        for oracle in (False, True):
            kernels.reset_launch_counts()
            res = macarons_nbv_rollout(
                assets, occ, vis, params=p, n_poses=n, seed=1, oracle=oracle,
                draws=TorchDraws(1, torch.device(dev), "cpu"), device=dev,
                **NBV_SMALL_TOKENS)
            runs[dev, oracle] = (res, dict(kernels.LAUNCHES))
        kernels.reset_launch_counts()
        runs[dev, "object"] = (object_nbv_rollout(
            obj, vis, n_views=4, n_candidates=8, n_tokens=64, seed=0,
            device=dev, return_views=True), dict(kernels.LAUNCHES))
    zero = dict.fromkeys(kernels.LAUNCHES, 0)
    assert runs["cpu", False][1] == zero and runs["cpu", True][1] == zero
    assert runs["cuda", False][1] == dict(zero, ray_hits=1,
                                          ray_hits_pinhole=1 + n,
                                          min_sq_dists=n)
    assert runs["cuda", True][1] == dict(zero, ray_hits=1,
                                         ray_hits_pinhole=1 + 2 * n,
                                         min_sq_dists=2 * n,
                                         min_sq_dists_scenes=n)
    for oracle in (False, True):
        g, c = runs["cuda", oracle][0], runs["cpu", oracle][0]
        np.testing.assert_allclose(g.coverage_evolution, c.coverage_evolution,
                                   atol=1e-3)
        assert g.n_points == c.n_points
        np.testing.assert_allclose(g.cam_positions, c.cam_positions,
                                   atol=1e-4)
        assert g.coverage_evolution[-1] > g.coverage_evolution[0] > 0.0
    (g_curve, g_views), g_launch = runs["cuda", "object"]
    (c_curve, c_views), _ = runs["cpu", "object"]
    assert g_views == c_views and g_curve == c_curve
    assert g_launch == dict(zero, ray_hits=4)


@pytest.mark.cuda
def test_render_rgbd_on_card_matches_cpu():
    """One RGB-D frame at the trainer's 256x456 on the card, one camera
    for both devices, against the CPU's: K1 is bit-equal to its plain
    version on the same device, but the rays the two devices build may
    differ in an ulp, so a pixel on a triangle edge may change hands (at
    most 1 in 10,000); elsewhere depth within rtol 1e-5 and colour within
    1e-5. One K1 launch."""
    _need_card()
    from nextbestpath_tpu_torch.assets import (generate_scene,
                                               pack_generated_scene)
    from nextbestpath_tpu_torch.geometry.cameras import get_camera_RT

    assets = pack_generated_scene(generate_scene("simple", seed=8))
    intr = CameraIntrinsics(256, 456)
    pose = torch.tensor(assets.pose_from_idx(assets.start_cam_idx),
                        dtype=torch.float32)
    Rc, Tc = get_camera_RT(pose[None, :3], pose[None, 3:])
    out = {}
    for dev in ("cuda", "cpu"):
        kernels.reset_launch_counts()
        soa = R.tris_to_soa(torch.from_numpy(assets.tris).to(dev))
        rgb, zbuf = R.render_rgbd(
            soa, assets.n_tris, Rc[0].to(dev), Tc[0].to(dev), intr,
            tri_colors=torch.from_numpy(assets.tri_colors).to(dev))
        out[dev] = (rgb.cpu(), zbuf.cpu(), kernels.LAUNCHES["ray_hits_pinhole"])
    (rgb_g, z_g, n_g), (rgb_c, z_c, n_c) = out["cuda"], out["cpu"]
    col = (rgb_g - rgb_c).abs().amax(dim=-1)
    depth = (z_g - z_c).abs() <= 1e-5 * z_c.abs()
    moved = ~depth | (col > 1e-5)
    assert float(moved.float().mean()) <= 1e-4, (
        int(moved.sum()), float((z_g - z_c).abs().max()), float(col.max()))
    assert float((z_c > 0).float().mean()) > 0.5
    assert n_g == 1 and n_c == 0


@pytest.mark.cuda
def test_macarons_trainer_on_card_matches_cpu():
    """The MACARONS online trainer at TINY on the card against the CPU,
    the same seeded weights and one CPU generator's draws: 3 perfect-depth
    poses (the same gains, coverage within 1e-3, losses within 1e-3
    relative; K2 once, K1 1 + 3 a pose, K3 once a pose on the card) and 4
    poses with learned and predicted depth (the depth step at the fourth
    pose: its loss within 1e-3 relative)."""
    _need_card()
    from nextbestpath_tpu_torch.assets import (generate_scene,
                                               pack_generated_scene)
    from nextbestpath_tpu_torch.config import default_params
    from nextbestpath_tpu_torch.draws import TorchDraws
    from nextbestpath_tpu_torch.train.train_macarons import (
        TINY, MacaronsTrainState, train_macarons_online)

    p = default_params(**TINY)
    assets = pack_generated_scene(generate_scene("simple", seed=2), params=p)
    runs = {}
    for dev in ("cuda", "cpu"):
        for mode, n, kw in (("perfect", 3, {}),
                            ("learned", 4, dict(learn_depth=True,
                                                use_perfect_depth=False))):
            kernels.reset_launch_counts()
            st = MacaronsTrainState.create(0, params=p, device=dev)
            logs = train_macarons_online(
                assets, st, params=p, n_poses=n, seed=3, verbose=False,
                draws=TorchDraws(3, torch.device(dev), "cpu"), **kw)
            runs[dev, mode] = (logs, dict(kernels.LAUNCHES))
    zero = dict.fromkeys(kernels.LAUNCHES, 0)
    assert runs["cuda", "perfect"][1] == dict(zero, ray_hits=1,
                                              ray_hits_pinhole=10,
                                              min_sq_dists=3)
    assert runs["cpu", "perfect"][1] == zero
    g, c = runs["cuda", "perfect"][0], runs["cpu", "perfect"][0]
    assert g["gain"] == c["gain"]
    for mode in ("perfect", "learned"):
        g, c = runs["cuda", mode][0], runs["cpu", mode][0]
        np.testing.assert_allclose(g["coverage"], c["coverage"], atol=1e-3)
        for k in ("occ_loss", "cov_loss", "depth_loss"):
            assert len(g[k]) == len(c[k])
            np.testing.assert_allclose(g[k], c[k], rtol=1e-3, atol=1e-6)
    assert len(runs["cuda", "learned"][0]["depth_loss"]) == 1


@pytest.mark.cuda
def test_depth_pretrainer_on_card_matches_cpu(tmp_path):
    """``pretrain_depth`` at 64x114 (96 planes, batch 1) for 3 steps on the
    card and on the CPU, the same seeded weights and one CPU generator's
    draws: the losses and held-out errors within 1e-3 relative, every
    parameter within 2 x 3 x lr of the CPU's (Adam's first steps move a
    parameter by about lr whatever its gradient's size, so a gradient
    near zero may move the two apart by that much each step), and the
    running statistics within 1e-2 of their scale (each of the 3 updates
    averages a batch statistic taken through parameters so moved apart;
    measured 1.1e-3 on the H100); on the
    card K2 once a scene and K1 three times a sample built (the held-out
    batch included)."""
    _need_card()
    from nextbestpath_tpu_torch.assets import (generate_scene,
                                               pack_generated_scene)
    from nextbestpath_tpu_torch.config import default_params
    from nextbestpath_tpu_torch.draws import TorchDraws
    from nextbestpath_tpu_torch.models.manydepth import ManyDepth, flax_init_
    from nextbestpath_tpu_torch.train.pretrain_depth import pretrain_depth

    p = default_params(image_height=64, image_width=114, points_per_frame=256,
                       full_pc_capacity=16384, n_gt_surface_points=1024)
    sc = [pack_generated_scene(generate_scene("simple", seed=8), params=p)]
    ev = pack_generated_scene(generate_scene("simple", seed=708), params=p)
    runs = {}
    for dev in ("cuda", "cpu"):
        kernels.reset_launch_counts()
        model = flax_init_(ManyDepth(CameraIntrinsics(64, 114)), 0)
        logs = str(tmp_path / dev)
        model, best = pretrain_depth(
            sc, ev, steps=3, batch=1, seed=8, out_dir=logs, log_dir=logs,
            eval_every=3, image_height=64, image_width=114, params=p,
            model=model, draws=TorchDraws(8, torch.device(dev), "cpu"),
            verbose=False, device=dev)
        with open(os.path.join(logs, "depth_pre_loss.json")) as f:
            import json
            runs[dev] = (json.load(f), model.state_dict(),
                         dict(kernels.LAUNCHES))
    zero = dict.fromkeys(kernels.LAUNCHES, 0)
    assert runs["cuda"][2] == dict(zero, ray_hits=2, ray_hits_pinhole=12)
    (lg, sg, _), (lc, sc_, _) = runs["cuda"], runs["cpu"]
    np.testing.assert_allclose(lg["loss"], lc["loss"], rtol=1e-3)
    np.testing.assert_allclose([e["err"] for e in lg["eval_err"]],
                               [e["err"] for e in lc["eval_err"]], rtol=1e-3)
    for k, v in sc_.items():
        diff = float((sg[k].cpu() - v).abs().max())
        if "running" in k:
            assert diff <= 1e-2 * float(v.abs().max()), k
        else:
            assert diff <= 2 * 3 * 1e-4, k


@pytest.mark.cuda
def test_scone_pretrainer_on_card_matches_cpu():
    """The object and interior sample builders and 3 occupancy and
    visibility steps on the card and on the CPU with one CPU generator's
    draws: the samples' decisions equal and their points within 1e-5 of
    their scale, the losses within 1e-3 relative; K1 once a view and K2
    (inside test, visibility rays) launched on the card."""
    _need_card()
    from nextbestpath_tpu_torch.draws import TorchDraws
    from nextbestpath_tpu_torch.models.scone import SconeOcc, SconeVis
    from nextbestpath_tpu_torch.train import pretrain_scone as P

    small = dict(n_partial=256, n_query=128, n_candidates=4, n_views=2)
    samples, launches = {}, {}
    for dev in ("cuda", "cpu"):
        d = torch.device(dev)
        kernels.reset_launch_counts()
        samples[dev] = [
            P.make_pretrain_sample(0, **small, device=d,
                                   draws=TorchDraws(0, d, "cpu")),
            P.make_interior_sample(1, **small, scenes=2, device=d,
                                   draws=TorchDraws(1, d, "cpu"))]
        launches[dev] = dict(kernels.LAUNCHES)
    assert launches["cuda"]["ray_hits_pinhole"] == 4
    assert launches["cuda"]["ray_hits"] >= 5
    for g, c in zip(samples["cuda"], samples["cpu"]):
        for f in ("query_x", "query_occ", "candidate_cams", "gt_coverage"):
            np.testing.assert_array_equal(getattr(g, f), getattr(c, f))
        for f in ("partial_pc", "view_harmonics"):
            a, b = getattr(g, f), getattr(c, f)
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-5 * np.abs(b).max())
    losses = {}
    for dev in ("cuda", "cpu"):
        d = torch.device(dev)
        torch.manual_seed(0)
        occ, vis = SconeOcc(seq_len=256), SconeVis()
        kw = dict(n_steps=3, seed=0, samples=samples["cpu"], batch=2,
                  verbose=False, device=d)
        losses[dev] = (
            P.pretrain_scone_occ(model=occ, draws=TorchDraws(0, d, "cpu"),
                                 **kw)[1],
            P.pretrain_scone_vis(model=vis, draws=TorchDraws(0, d, "cpu"),
                                 **kw)[1])
    for g, c in zip(losses["cuda"], losses["cpu"]):
        np.testing.assert_allclose(g, c, rtol=1e-3)
