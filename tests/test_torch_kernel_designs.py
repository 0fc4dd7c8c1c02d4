"""The designs of K1 and K3 (nextbestpath_tpu_torch/csrc/raytrace.cu and
coverage.cu), held to the plain versions and the JAX package on the CPU.

The CUDA kernels run only on a card, so this file models what each design
adds to the plain arithmetic:

- K1 culls, for each block of rays (an 8 x 16 pixel tile of the frame's
  image), the triangles whose folded pair test fails for every
  direction in the block's ray box, then tests the survivors in ascending
  index order. ``ops/raytrace.py::pinhole_cull_keep`` is the cull in f32,
  each rounding the kernel directs taken one float further with
  ``torch.nextafter``. These tests hold that it never drops a pair that
  ``ray_hits_pinhole_plain`` passes and that culled-then-tested results
  equal the plain version exactly: on Hypothesis-made triangles and
  frames, the first move's frames of procgen ``simple``/8 and
  ``insane``/8, and pairs built to sit on an edge, on a vertex and at
  det' near eps.
- K3 splits the valid pairs into items (scene, GT block, sample range) by
  a plan made from the counts (``kernels.min_sq_dists_plan``, the plan
  kernel's rule) and lets persistent blocks draw them. These tests hold
  that every valid (scene, GT point, sample) pair lies in exactly one item,
  that no item reaches past its scene's count, that the kernel's search
  finds each item's scene, and that the items' minima, met in any order,
  equal the plain version bit for bit and the JAX Pallas kernel (interpret
  mode) to 1e-6.

The card holds the kernels to the plain versions (tests/test_torch_kernels.py,
chip_smoke.py phase 3), and K1 on this file's edge-case and random frames
(the ``cuda``-marked test). JAX is imported only by the tests that use it,
so that the card, which has no JAX, runs that one:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernel_designs.py
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from nextbestpath_tpu_torch import kernels
from nextbestpath_tpu_torch.assets import generate_scene, pack_generated_scene
from nextbestpath_tpu_torch.eval.nbp_planning import main_path_move
from nextbestpath_tpu_torch.geometry.cameras import (CameraIntrinsics,
                                                     get_camera_RT)
from nextbestpath_tpu_torch.ops import coverage as C
from nextbestpath_tpu_torch.ops import raytrace as R

INF = 3.4e38
N_BLOCKS = 132 * 8  # K3's resident blocks on an H100 (ptxas: 64 registers)


# ---------------------------------------------------------------------------
# K1: the cull
# ---------------------------------------------------------------------------


def _block_of_ray(n_rays, width):
    """The block (of pinhole_ray_boxes) each ray of a frame belongs to."""
    i = torch.arange(n_rays)
    tiles_x = -(-width // R.K1_TILE_W)
    return (i // width // R.K1_TILE_H) * tiles_x + (i % width) // R.K1_TILE_W


def _culled_then_tested(dirs, ph, n_tris, t_min, t_max, width):
    """(t, cnt, idx) of K1's design, frame by frame: each ray tests only
    the triangles its block keeps, with the plain version's arithmetic.
    Asserts on the way that no dropped pair passes the test."""
    n = R._n_valid(n_tris, ph.shape[2])
    lo, hi, _ = R.pinhole_ray_boxes(dirs, width)
    keep = R.pinhole_cull_keep(ph[:, :, :n], lo, hi)
    blocks = _block_of_ray(dirs.shape[1], width)
    out = []
    for b in range(dirs.shape[0]):
        if n == 0:
            out.append(R._empty_result(dirs.shape[1], dirs.device))
            continue
        soa = ph[b, :, :n]
        dx, dy, dz = dirs[b, :, 0:1], dirs[b, :, 1:2], dirs[b, :, 2:3]
        det = -R._dot3(dx, dy, dz, soa[0], soa[1], soa[2])
        u = -R._dot3(dx, dy, dz, soa[3], soa[4], soa[5])
        v = R._dot3(dx, dy, dz, soa[6], soa[7], soa[8])
        t, ok = R._hit_test(det, u, v, soa[9], t_min, t_max)
        _, front = R._hit_test(det, u, v, soa[9], 0.0, INF)
        kept = keep[b][blocks]
        assert not bool((front & ~kept).any()), "the cull dropped a passing pair"
        out.append(R._nearest(t, ok & kept))
    return tuple(torch.stack([o[i] for o in out]) for i in range(3))


def _assert_culled_equals_plain(dirs, ph, n_tris, t_min, t_max, width):
    got = _culled_then_tested(dirs, ph, n_tris, t_min, t_max, width)
    want = R.ray_hits_pinhole_plain(dirs, ph, n_tris, t_min, t_max)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    return want


def _frames(assets, hw, n_steps=4):
    """The first move's n_steps frames of ``assets`` at image size hw:
    (dirs (B, H*W, 3), pinhole SoA (B, 10, F))."""
    intr = CameraIntrinsics(hw[0], hw[1], 60.0, 1.0, 750.0)
    poses = main_path_move(assets, n_steps, "cpu")
    Rm, Tm = get_camera_RT(poses[:, :3], poses[:, 3:])
    eyes, dirs = R.frame_rays(Rm, Tm, intr)
    ph = R.pinhole_tri_soa(R.tris_to_soa(torch.from_numpy(assets.tris)), eyes)
    return dirs.contiguous(), ph


@pytest.fixture(scope="module")
def procgen():
    return {d: pack_generated_scene(generate_scene(d, seed=8))
            for d in ("simple", "insane")}


@pytest.mark.parametrize("difficulty", ["simple", "insane"])
@pytest.mark.parametrize("hw", [(32, 56), (21, 40), (9, 17), (3, 70)])
def test_cull_on_procgen_first_move(procgen, difficulty, hw):
    """The first move's four frames of procgen simple/8 (252 triangles) and
    insane/8 (2,784), at sizes that are no multiple of the tile, culled
    then tested, equal the plain version, and the frames see the scene."""
    a = procgen[difficulty]
    dirs, ph = _frames(a, hw)
    want = _assert_culled_equals_plain(dirs, ph, a.n_tris, 1.0, 750.0, hw[1])
    assert bool((want[0] < INF).float().mean() > 0.5)


@pytest.mark.parametrize("difficulty, most", [("simple", 0.036),
                                              ("insane", 0.016)])
def test_cull_keeps_few_pairs_at_full_size(procgen, difficulty, most):
    """At the main path's 256 x 456 the cull leaves at most twice the
    share of pairs an f64 estimate of the same bounds gave (1.8% at
    simple/8, 0.8% at insane/8 for 8 x 16 tiles)."""
    a = procgen[difficulty]
    dirs, ph = _frames(a, (256, 456), n_steps=1)
    assert 0.0 < R.pinhole_tested_share(dirs, ph, a.n_tris, 456) < most


def _edge_case_scene():
    """One 8 x 16 tile of rays d = (x, y, 1), x = -8/16 .. 7/16, y = -4/16
    .. 3/16 (exact floats) from the origin, and triangles that the rays
    meet exactly on a vertex, on the edges u' = 0, v' = 0 and u' + v' =
    det', tiny ones whose det' sits at eps = 1e-10 on both sides, one in a
    plane through the rays (det' = 0), one behind the camera and one whose
    plane holds the eye (t_num = 0)."""
    xs, ys = np.arange(-8, 8) / 16.0, np.arange(-4, 4) / 16.0
    dirs = np.stack(list(np.meshgrid(xs, ys)) + [np.ones((8, 16))], -1)
    dirs = dirs.reshape(1, -1, 3).astype(np.float32)
    z = 4.0
    tris = [
        [[0, 0, z], [1, 0, z], [0, 1, z]],            # a vertex on d = (0, 0, 1)
        [[0, 0, z], [0.5, 0, z], [0, 0.5, z]],        # (0.25, 0.25) on its long edge
        [[-1, 0.25, z], [1, 0.25, z], [0, 3, z]],     # y = 1/16 on an edge
        [[0.25, -1, z], [0.25, 1, z], [3, 0, z]],     # x = 1/16 on an edge
        [[0, -1, 2], [0, 1, 2], [0, 0, 6]],           # the plane x = 0 holds rays
        [[-1, -1, -z], [1, -1, -z], [0, 1, -z]],      # behind the camera
        [[0, 0, 0], [1, 0, 1], [0, 1, 1]],            # its plane holds the eye
    ]
    for s in (0.99e-5, 1e-5, 1.000001e-5, 1.01e-5, 2e-5):
        for (cx, cy) in ((0.0, 0.0), (0.125, -0.0625)):
            v0 = [cx * z - s / 4, cy * z - s / 4, z]
            tris.append([v0, [v0[0] + s, v0[1], z], [v0[0], v0[1] + s, z]])
            tris.append([v0, [v0[0], v0[1] + s, z], [v0[0] + s, v0[1], z]])
    return torch.from_numpy(dirs), torch.tensor(tris, dtype=torch.float32)


def test_cull_keeps_pairs_on_edges_and_near_eps():
    """Rays through a vertex, along the edges u' = 0, v' = 0 and u' + v' =
    det', and tiny triangles at det' within a few ulps of eps: the cull
    drops none of the pairs that pass, and culled then tested equals the
    plain version (t, counts and the lowest index among ties), with the
    rays as one 8 x 16 tile and as a 16 x 8 image (two tiles)."""
    dirs, tris = _edge_case_scene()
    ph = R.pinhole_tri_soa(R.tris_to_soa(tris), torch.zeros(1, 3))
    want = _assert_culled_equals_plain(dirs, ph, tris.shape[0], 0.0, INF, 16)
    _assert_culled_equals_plain(dirs, ph, tris.shape[0], 0.0, INF, 8)
    t, cnt, idx = want
    centre = 4 * 16 + 8  # d = (0, 0, 1)
    assert int(cnt[0, centre]) >= 2 and int(idx[0, centre]) == 0
    assert bool((cnt[0] > 0).sum() > 8)


SCALES = (1e-3, 0.3, 5.0, 200.0)


def _random_frame(seed, h, w, n_tris, scale, fov):
    """A pinhole frame of h x w rays (any pose and field of view) and
    n_tris triangles of ``scale`` placed on its rays, around the eye and
    behind it: (dirs (1, h*w, 3), pinhole SoA (1, 10, n_tris))."""
    rng = np.random.default_rng(seed)
    intr = CameraIntrinsics(h, w, fov, 0.01, 1e4)
    pos = rng.normal(scale=10.0, size=(1, 3)).astype(np.float32)
    ang = np.array([[rng.uniform(-80, 80), rng.uniform(-180, 180)]], np.float32)
    Rm, Tm = get_camera_RT(torch.from_numpy(pos), torch.from_numpy(ang))
    eye, dirs = R.frame_rays(Rm, Tm, intr)
    ray = rng.integers(0, h * w, n_tris)
    dist = rng.uniform(-2.0, 50.0, n_tris)[:, None]
    centre = eye[0].numpy() + dirs[0, ray].numpy() * dist
    tris = (centre[:, None, :] + rng.normal(scale=scale, size=(n_tris, 3, 3)))
    tris = torch.from_numpy(tris.astype(np.float32))
    return dirs.contiguous(), R.pinhole_tri_soa(R.tris_to_soa(tris), eye)


@settings(max_examples=30, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2 ** 31 - 1), h=st.integers(1, 20),
       w=st.integers(1, 40), n_tris=st.integers(0, 160),
       scale=st.sampled_from(SCALES), fov=st.floats(20.0, 150.0))
def test_cull_never_drops_a_passing_pair(seed, h, w, n_tris, scale, fov):
    """Random pinhole frames (``_random_frame``): no pair that passes is
    dropped, and culled then tested equals the plain version."""
    dirs, ph = _random_frame(seed, h, w, n_tris, scale, fov)
    _assert_culled_equals_plain(dirs, ph, n_tris, 0.01, 1e4, w)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["edges", "random"])
def test_pinhole_kernel_on_edge_cases_and_random_frames_on_card(case):
    """K1 on the card equals its plain version bit for bit where its cull
    is tightest: the edge-case scene (``_edge_case_scene``) as one 8 x 16
    tile and as a 16 x 8 image, and 40 seeded draws of the random frames
    the Hypothesis test makes (``_random_frame``, the same ranges). The CPU
    tests hold only the looser PyTorch model of the cull."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if case == "edges":
        dirs, tris = _edge_case_scene()
        ph = R.pinhole_tri_soa(R.tris_to_soa(tris), torch.zeros(1, 3))
        runs = [(dirs, ph, tris.shape[0], 0.0, INF, w) for w in (16, 8)]
    else:
        rng = np.random.default_rng(19)
        runs = []
        for _ in range(40):
            h, w, n = (int(rng.integers(1, 21)), int(rng.integers(1, 41)),
                       int(rng.integers(0, 161)))
            dirs, ph = _random_frame(int(rng.integers(0, 2 ** 31)), h, w, n,
                                     SCALES[rng.integers(0, 4)],
                                     float(rng.uniform(20.0, 150.0)))
            runs.append((dirs, ph, n, 0.01, 1e4, w))
    for dirs, ph, n, t_min, t_max, w in runs:
        dirs, ph = dirs.cuda(), ph.cuda()
        nt = torch.tensor([n], dtype=torch.int32, device="cuda")
        got = kernels.ray_hits_pinhole(dirs, ph, nt, t_min, t_max, w)
        want = R.ray_hits_pinhole_plain(dirs, ph, n, t_min, t_max)
        for g, x in zip(got, want):
            assert torch.equal(g, x), (case, dirs.shape, n, w)


def test_culled_render_matches_pallas_kernel(procgen):
    """The culled design's depth of simple/8's first move at 32 x 56
    against the JAX package's pinhole kernel (Pallas in interpret mode),
    within test_torch_raytrace.py's tolerances: hit distances 1e-5
    relative, hits, counts and indices apart from grazing rays (0.5%)."""
    import jax.numpy as jnp

    from nextbestpath_tpu.ops import raytrace as JR

    a = procgen["simple"]
    dirs, ph = _frames(a, (32, 56))
    t, cnt, idx = _culled_then_tested(dirs, ph, a.n_tris, 1.0, 750.0, 56)
    poses = main_path_move(a, 4, "cpu")
    Rm, Tm = get_camera_RT(poses[:, :3], poses[:, 3:])
    eyes, _ = R.frame_rays(Rm, Tm, CameraIntrinsics(32, 56, 60.0, 1.0, 750.0))
    soa_j = JR.tris_to_soa(jnp.asarray(a.tris))
    for b in range(dirs.shape[0]):
        t_j, n_j, i_j = (np.asarray(x) for x in JR.ray_hits_pinhole(
            jnp.asarray(eyes[b].numpy()), jnp.asarray(dirs[b].numpy()), soa_j,
            a.n_tris, t_min=1.0, t_max=750.0, interpret=True))
        hit_g, hit_j = t[b].numpy() < 1e30, t_j < 1e30
        allowed = int(5e-3 * len(t_j))
        assert (hit_g != hit_j).sum() <= allowed
        assert (cnt[b].numpy() != n_j).sum() <= allowed
        assert (idx[b].numpy() != i_j).sum() <= allowed
        both = hit_g & hit_j
        np.testing.assert_allclose(t[b].numpy()[both], t_j[both], rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# K3: the plan and the persistent blocks
# ---------------------------------------------------------------------------


def _decode(plan, counts, items):
    """The kernel's decoding of items (an int array): the scene by a binary
    search for the last b with prefix[b] <= item, then GT block and sample
    range. -> (scene, gt_block, s0, s1) arrays."""
    prefix = np.asarray(plan["prefix"], dtype=np.int64)
    n_gb, chunk = plan["gt_blocks"], plan["chunk"]
    scene = np.searchsorted(prefix[:-1], items, side="right") - 1
    local = items - prefix[scene]
    s0 = (local // n_gb) * chunk
    s1 = s0 + np.minimum(chunk, np.asarray(counts)[scene] - s0)
    return scene, local % n_gb, s0, s1


def _kernel_search(prefix, n_b, item):
    """min_sq_dist_kernel's search: the last b < n_b with prefix[b] <= item."""
    lo, hi = 0, n_b - 1
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if prefix[mid] <= item:
            lo = mid
        else:
            hi = mid - 1
    return lo


def _assert_plan_covers(counts, n_g, n_s, n_blocks):
    """Every valid (scene, GT block, sample) lies in exactly one item and
    no item reaches past its scene's count."""
    plan = kernels.min_sq_dists_plan(counts, n_g, n_s, n_blocks)
    clamped = np.clip(np.asarray(counts, dtype=np.int64), 0, n_s)
    chunk, n_gb = plan["chunk"], plan["gt_blocks"]
    assert chunk % kernels.K3_TILE == 0 and chunk >= kernels.K3_TILE
    assert n_gb == -(-n_g // kernels.K3_POINTS_PER_ITEM)
    items = np.arange(plan["items"], dtype=np.int64)
    if plan["items"] == 0:
        assert int(clamped.sum()) == 0 or n_gb == 0
        return plan
    scene, gblock, s0, s1 = _decode(plan, clamped, items)
    prefix = np.asarray(plan["prefix"])
    assert bool(np.all((prefix[scene] <= items) & (items < prefix[scene + 1])))
    for i in items[::max(1, len(items) // 500)]:
        assert _kernel_search(plan["prefix"], len(counts), int(i)) == scene[i]
    assert bool(np.all((0 <= s0) & (s0 < s1) & (s1 <= clamped[scene])))
    assert bool(np.all((0 <= gblock) & (gblock < n_gb)))
    # Per (scene, GT block): the ranges, in order, tile [0, count) once.
    order = np.lexsort((s0, gblock, scene))
    key = scene[order] * n_gb + gblock[order]
    a, b = s0[order], s1[order]
    first = np.r_[True, key[1:] != key[:-1]]
    last = np.r_[key[1:] != key[:-1], True]
    assert bool(np.all(a[first] == 0))
    assert bool(np.all(b[last] == clamped[key[last] // n_gb]))
    assert bool(np.all(a[~first] == b[np.flatnonzero(~first) - 1]))
    # Every (scene with samples, GT block) has its items.
    want_keys = {(bb, k) for bb in range(len(counts)) if clamped[bb] > 0
                 for k in range(n_gb)} if len(counts) <= 64 else None
    if want_keys is not None:
        assert set(zip(scene.tolist(), gblock.tolist())) == want_keys
    else:
        assert len(np.unique(key)) == int((clamped > 0).sum()) * n_gb
    return plan


@pytest.mark.parametrize("counts", [
    [0], [1], [128], [40960], [0, 0, 0],
    [40960, 12345, 0, 30000], [40960, 12345, 0, 30000, 40960, 777, 20000, 40960],
    [1, 128, 0, 40960, 129, 127, 40959],
    [5000, 0, 1], [40960] * 8])
@pytest.mark.parametrize("n_g", [1, 1023, 1025, 20000])
def test_k3_plan_covers_every_valid_pair_once(counts, n_g):
    """Counts that mix 0, 1, a tile, past a tile and the capacity, B = 1 to
    8, GT counts around the points an item holds."""
    plan = _assert_plan_covers(counts, n_g, 40960, N_BLOCKS)
    if sum(counts) * plan["gt_blocks"] > 8 * N_BLOCKS * kernels.K3_TILE:
        # Large enough to split: about 8 items a resident block (or fewer,
        # the chunk rounded up to whole tiles), never under 4.
        assert 4 * N_BLOCKS <= plan["items"] <= 8 * N_BLOCKS + len(counts) * plan["gt_blocks"]


def test_k3_plan_at_the_main_paths_counts():
    """Phase 3's shapes: 20,000 GT against 40,960 samples at the full count
    gives two-tile chunks (128 samples), 6,400 items; at 12,345 valid one
    tile, 3,860 items; the B = 8 counts 448-sample chunks."""
    full = kernels.min_sq_dists_plan([40960], 20000, 40960, N_BLOCKS)
    assert full["chunk"] == 128 and full["items"] == 20 * 320
    part = kernels.min_sq_dists_plan([12345], 20000, 40960, N_BLOCKS)
    assert part["chunk"] == 64 and part["items"] == 20 * 193
    b8 = kernels.min_sq_dists_plan(
        [40960, 12345, 0, 30000, 40960, 777, 20000, 40960], 20000, 40960,
        N_BLOCKS)
    assert b8["chunk"] == 448
    assert b8["prefix"][3] == b8["prefix"][2]  # the empty scene has none


def test_k3_plan_65535_scenes_of_small_counts():
    """B = 65,535, the grid limit of the earlier design, with small counts
    (0 to 300): every pair in one item, the prefix monotone."""
    rng = np.random.default_rng(0)
    counts = rng.integers(0, 301, 65535).tolist()
    counts[:3] = [0, 300, 0]
    plan = _assert_plan_covers(counts, 700, 300, N_BLOCKS)
    assert plan["items"] == sum(-(-c // plan["chunk"]) for c in counts)
    assert all(a <= b for a, b in zip(plan["prefix"], plan["prefix"][1:]))


def _persistent_model(g, s, counts, n_blocks, seed):
    """K3's design on the CPU: the plan's items drawn in a shuffled order
    (as blocks draw them by atomicAdd), each one's minima over its GT block
    and sample range from the plain version's arithmetic, met by a min."""
    n_b, n_g, n_s = g.shape[0], g.shape[1], s.shape[1]
    plan = kernels.min_sq_dists_plan(counts, n_g, n_s, n_blocks)
    clamped = [max(0, min(int(c), n_s)) for c in counts]
    out = torch.full((n_b, n_g), 1e30, dtype=torch.float32)
    items = np.random.default_rng(seed).permutation(plan["items"])
    scene, gblock, s0, s1 = _decode(plan, clamped, items)
    pts = kernels.K3_POINTS_PER_ITEM
    for b, k, a, e in zip(scene, gblock, s0, s1):
        gg = g[b, k * pts:(k + 1) * pts]
        part = C.min_sq_dists_plain(gg, s[b, a:e].contiguous(), e - a)
        out[b, k * pts:(k + 1) * pts] = torch.minimum(
            out[b, k * pts:(k + 1) * pts], part)
    return out


@pytest.mark.parametrize("counts, n_blocks", [
    ([700, 0, 1, 128, 129, 333], 3), ([0], 1), ([700], 1000),
    ([1, 700, 700, 0], 2)])
def test_k3_persistent_model_equals_plain_and_pallas(counts, n_blocks):
    """The items' minima, met in any order, equal the plain version bit for
    bit (a min is exact and free of order), and the JAX Pallas kernel in
    interpret mode to 1e-6 relative (test_torch_coverage.py's tolerance)."""
    import jax.numpy as jnp

    from nextbestpath_tpu.ops import coverage as JC

    rng = np.random.default_rng(len(counts) + n_blocks)
    n_g, n_s = 2100, 700
    g = rng.uniform(-50, 50, (len(counts), n_g, 3)).astype(np.float32)
    s = rng.uniform(-50, 50, (len(counts), n_s, 3)).astype(np.float32)
    valid = np.arange(n_s)[None, :] < np.asarray(counts)[:, None]
    s_t = torch.where(torch.from_numpy(valid)[..., None], torch.from_numpy(s),
                      torch.full((1,), 1e9))
    g_t = torch.from_numpy(g)
    want = C.min_sq_dists_scenes_plain(g_t, s_t, torch.tensor(counts))
    for seed in (0, 1):
        got = _persistent_model(g_t, s_t, counts, n_blocks, seed)
        assert torch.equal(got, want)
    for b, c in enumerate(counts):
        if c == 0:
            assert bool((want[b] == 1e30).all())
            continue
        j = np.asarray(JC.min_dists(jnp.asarray(g[b]), jnp.asarray(s[b]),
                                    jnp.asarray(valid[b]),
                                    s_count=jnp.int32(c), use_kernel=True))
        np.testing.assert_allclose(torch.sqrt(want[b]).numpy(), j, rtol=1e-6,
                                   atol=1e-6)
