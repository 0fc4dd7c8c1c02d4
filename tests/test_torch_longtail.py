"""The port's last host-side modules against the JAX package, on the same
numpy inputs and keys: pose validity (the lattice's frustum masks, the
Gumbel pick of a valid pose, the range sampler), the point-cloud
collision predicates, the bidirectional planner's edges and paths, the
object and frame datasets, the native OBJ parser, the four small helpers
(``view_to_world_dirs``, ``scatter_count_img``, ``scatter_mean_img``,
``pc_similarity``), and the packages' exports.

Tolerances, and why: masks, edges, paths, indices, counts, dataset items
and parsed meshes exact (decisions, integers, or numpy copies); distances
and directions within 1e-6 of their scale (f32 products in another
order); the mean image within 1e-6 (sums in another order).
"""

import ast
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextbestpath_tpu.assets import object_dataset as JOD
from nextbestpath_tpu.assets import obj_native as JON
from nextbestpath_tpu.geometry import cameras as JC
from nextbestpath_tpu.ops import coverage as JCOV
from nextbestpath_tpu.ops import pc_collision as JPC
from nextbestpath_tpu.ops import scatter2d as JS
from nextbestpath_tpu.planning import bidirectional as JB
from nextbestpath_tpu.sim import pose_validity as JPV
from nextbestpath_tpu_torch.assets import obj_io as TOI
from nextbestpath_tpu_torch.assets import object_dataset as TOD
from nextbestpath_tpu_torch.assets import obj_native as TON
from nextbestpath_tpu_torch.geometry import cameras as TC
from nextbestpath_tpu_torch.ops import coverage as TCOV
from nextbestpath_tpu_torch.ops import pc_collision as TPC
from nextbestpath_tpu_torch.ops import scatter2d as TS
from nextbestpath_tpu_torch.planning import bidirectional as TB
from nextbestpath_tpu_torch.sim import pose_validity as TPV

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol=1e-6):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


class JaxKeyDraws:
    """One JAX key a draw: ``gumbel`` and ``uniform`` of PRNGKey(seed)."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def gumbel(self, role, shape, step=None):
        return _t(jax.random.gumbel(self.key, tuple(shape)))

    def uniform(self, role, shape, step=None):
        return _t(jax.random.uniform(self.key, tuple(shape)))


# -- pose validity -----------------------------------------------------------


def _intr(j=False):
    kw = dict(image_height=32, image_width=56, fov_degrees=60.0, znear=0.5,
              zfar=50.0)
    return JC.CameraIntrinsics(**kw) if j else TC.CameraIntrinsics(**kw)


def _lattice(L=5, H=4, seed=0):
    rng = np.random.default_rng(seed)
    ll, hh = np.meshgrid(np.arange(L), np.arange(H), indexing="ij")
    pos = np.stack([ll * 3.0, np.full_like(ll, 1.5, dtype=float), hh * 3.0],
                   -1).astype(np.float32)
    pts = rng.uniform(-30, 45, (40, 3)).astype(np.float32)
    pts[:, 1] = rng.uniform(0, 3, 40)
    valid = rng.random(40) < 0.7
    proxy = rng.uniform(-10, 25, (60, 3)).astype(np.float32)
    return pos, pts, valid, proxy


@pytest.mark.parametrize("with_proxy", [False, True])
def test_lattice_validity_mask_matches_jax(with_proxy):
    """Every (l, h, a) of a 5x4 lattice with 8 azimuths at elevation 10,
    chunked by 7 cameras (the JAX package's lax.map batch)."""
    pos, pts, valid, proxy = _lattice()
    azims = np.arange(8, dtype=np.float32) * 45.0
    kw = dict(proxy_points=proxy) if with_proxy else {}
    want = JPV.lattice_validity_mask(
        jnp.asarray(pos), jnp.asarray(azims), 10.0, jnp.asarray(pts),
        jnp.asarray(valid), _intr(True), 4.0,
        **{k: jnp.asarray(v) for k, v in kw.items()}, batch_size=7)
    got = TPV.lattice_validity_mask(
        _t(pos), _t(azims), 10.0, _t(pts), _t(valid), _intr(), 4.0,
        **{k: _t(v) for k, v in kw.items()}, batch_size=7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < got.numel()


def test_fov_nonempty_mask_matches_jax():
    pos, pts, valid, _ = _lattice(seed=1)
    X = pos.reshape(-1, 3)
    V = np.stack([np.zeros(len(X)), np.arange(len(X)) * 37.0 % 360],
                 -1).astype(np.float32)
    want = JPV.fov_nonempty_mask(jnp.asarray(pts), jnp.asarray(valid),
                                 jnp.asarray(X), jnp.asarray(V), _intr(True),
                                 20.0, batch_size=3)
    got = TPV.fov_nonempty_mask(_t(pts), _t(valid), _t(X), _t(V), _intr(),
                                20.0, batch_size=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_check_if_pose_is_occupied_matches_jax():
    occ = np.zeros((3, 3), bool)
    occ[1, 2] = True
    assert not bool(TPV.check_if_pose_is_occupied())
    assert not bool(TPV.check_if_pose_is_occupied(occupied=_t(occ),
                                                  idx=(1, 2)))
    for idx in ((1, 2), (0, 0)):
        want = JPV.check_if_pose_is_occupied(
            reference_behavior=False, occupied=jnp.asarray(occ), idx=idx)
        got = TPV.check_if_pose_is_occupied(
            reference_behavior=False, occupied=_t(occ), idx=idx)
        assert bool(got) == bool(want)


@pytest.mark.parametrize("case", ["sparse", "none"])
def test_random_valid_pose_matches_jax(case):
    """The Gumbel argmax over the mask with the JAX keys; an empty mask
    falls back to the whole lattice."""
    mask = np.zeros((3, 4, 2), bool)
    if case == "sparse":
        mask[1, 2, 1] = mask[2, 0, 0] = mask[0, 3, 1] = True
    picks = set()
    for seed in range(12):
        want = JPV.random_valid_pose(jax.random.PRNGKey(seed),
                                     jnp.asarray(mask))
        got = TPV.random_valid_pose(JaxKeyDraws(seed), _t(mask))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        picks.add(tuple(got.tolist()))
    if case == "sparse":
        assert len(picks) == 3 and all(mask[p] for p in picks)


@pytest.mark.parametrize("keep_frac", [1.0, 0.2])
def test_sample_valid_poses_in_range_matches_jax(keep_frac):
    rng = np.random.default_rng(2)
    valid = rng.random((7, 6, 3)) < 0.8
    cur = np.asarray([3, 2])
    want = JPV.sample_valid_poses_in_range(
        jax.random.PRNGKey(4), jnp.asarray(valid), jnp.asarray(cur), 2,
        keep_frac=keep_frac)
    got = TPV.sample_valid_poses_in_range(JaxKeyDraws(4), _t(valid), _t(cur),
                                          2, keep_frac=keep_frac)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum())


# -- point-cloud collision -----------------------------------------------------


def _cloud(n=500, seed=3):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-2, 6, (n, 3)).astype(np.float32)
    valid = rng.random(n) < 0.8
    probs = rng.random((n, 1)).astype(np.float32)
    return pts, valid, probs


@pytest.mark.parametrize("seg", [((0, 0, 0), (4, 1, 2)), ((1, 1, 1),
                                                          (1, 1, 1))])
def test_pc_collision_matches_jax(seg):
    """Distances to a segment (and a degenerate one), the 0.2 and 1.0
    predicates and the occupancy count, at several thresholds."""
    pts, valid, probs = _cloud()
    a, b = (np.asarray(x, np.float32) for x in seg)
    _close(TPC.segment_point_distances(_t(pts), _t(a), _t(b)),
           JPC.segment_point_distances(jnp.asarray(pts), jnp.asarray(a),
                                       jnp.asarray(b)))
    for thr in (0.05, 0.2, 0.5):
        assert bool(TPC.segment_intersects_point_cloud(
            _t(pts), _t(valid), _t(a), _t(b), thr)) == bool(
            JPC.segment_intersects_point_cloud(
                jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(a),
                jnp.asarray(b), thr))
    for dist, mc in ((1.0, 5), (0.3, 2), (0.3, 40)):
        assert bool(TPC.collision_with_occupancy_field(
            _t(pts), _t(probs), _t(valid), _t(a), _t(b), dist, 0.9,
            mc)) == bool(JPC.collision_with_occupancy_field(
                jnp.asarray(pts), jnp.asarray(probs), jnp.asarray(valid),
                jnp.asarray(a), jnp.asarray(b), dist, 0.9, mc))


def test_segment_distances_batched_equal_single():
    """E segments at once give each segment's own row, bit for bit."""
    pts, _, _ = _cloud(200)
    rng = np.random.default_rng(4)
    a = _t(rng.uniform(0, 4, (5, 3)).astype(np.float32))
    b = _t(rng.uniform(0, 4, (5, 3)).astype(np.float32))
    batched = TPC.segment_point_distances(_t(pts), a, b)
    for e in range(5):
        assert torch.equal(batched[e],
                           TPC.segment_point_distances(_t(pts), a[e], b[e]))


# -- the bidirectional planner -------------------------------------------------


def _grid_positions(L, H, step=1.0):
    ll, hh = np.meshgrid(np.arange(L), np.arange(H), indexing="ij")
    return np.stack([ll * step, np.zeros_like(ll), hh * step],
                    axis=-1).astype(np.float32)


@pytest.mark.parametrize("chunk_pairs", [1 << 23, 500])
def test_pc_edge_blocked_matches_jax(chunk_pairs):
    """Every edge of a 9x8 lattice against a random cloud with invalid
    slots, in one chunk and in chunks of a few points."""
    pos = _grid_positions(9, 8, 1.0)
    rng = np.random.default_rng(5)
    pts = np.stack([rng.uniform(0, 8, 400), rng.normal(0, 0.1, 400),
                    rng.uniform(0, 7, 400)], -1).astype(np.float32)
    valid = rng.random(400) < 0.3
    want = np.asarray(JB.pc_edge_blocked(jnp.asarray(pos), jnp.asarray(pts),
                                         jnp.asarray(valid)))
    got = TB.pc_edge_blocked(_t(pos), _t(pts), _t(valid),
                             chunk_pairs=chunk_pairs)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size


@pytest.mark.parametrize("goal", [(6, 0), (0, 6), (4, 3)])
def test_bidirectional_paths_match_jax(goal):
    """Around a wall of points: the same node lists, and the same move
    positions; a sealed lattice gives None on both sides."""
    pos = _grid_positions(7, 7)
    wall = np.asarray([[3.0, 0.0, z * 0.5] for z in range(11)], np.float32)
    valid = np.ones(len(wall), bool)
    blocked = TB.pc_edge_blocked(_t(pos), _t(wall), _t(valid)).numpy()
    want = JB.bidirectional_grid_path(blocked, (0, 0), goal)
    assert TB.bidirectional_grid_path(blocked, (0, 0), goal) == want
    assert want is not None and want[-1] == goal
    wp_j = JB.bidirectional_path_positions(pos, jnp.asarray(wall),
                                           jnp.asarray(valid), (0, 0), goal)
    wp_t = TB.bidirectional_path_positions(_t(pos), _t(wall), _t(valid),
                                           (0, 0), goal)
    np.testing.assert_array_equal(wp_t, wp_j)
    dense = np.stack(np.meshgrid(np.linspace(0, 6, 25),
                                 np.linspace(0, 6, 25)), -1).reshape(-1, 2)
    pts = np.stack([dense[:, 0], np.zeros(len(dense)), dense[:, 1]],
                   -1).astype(np.float32)
    assert TB.bidirectional_path_positions(
        _t(pos), _t(pts), torch.ones(len(pts), dtype=torch.bool), (0, 0),
        goal) is None


# -- datasets and the OBJ parser -----------------------------------------------


def _write_objs(tmp_path):
    verts = np.asarray([[0, 0, 0], [4, 0, 0], [0, 2, 0], [0, 0, 1]],
                       np.float32)
    faces = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    (tmp_path / "sub").mkdir()
    TOI.save_obj(str(tmp_path / "a.obj"), verts, faces)
    TOI.save_obj(str(tmp_path / "sub" / "b.obj"), verts * 2 + 1, faces)
    return verts


@pytest.mark.parametrize("diag", [False, True])
def test_object_dataset_matches_jax(tmp_path, diag):
    """The walk, the items, the JSON list and the size threshold."""
    verts = _write_objs(tmp_path)
    j = JOD.ObjectDataset(str(tmp_path), adjust_diagonally=diag)
    t = TOD.ObjectDataset(str(tmp_path), adjust_diagonally=diag)
    assert t.models == j.models and len(t) == 2
    for i in range(2):
        a, b = t[i], j[i]
        assert sorted(a) == sorted(b) and a["path"] == b["path"]
        np.testing.assert_array_equal(a["verts"], b["verts"])
        np.testing.assert_array_equal(a["faces"], b["faces"])
    np.testing.assert_array_equal(TOD.adjust_mesh(verts),
                                  JOD.adjust_mesh(verts))
    np.testing.assert_array_equal(TOD.adjust_mesh_diagonally(verts),
                                  JOD.adjust_mesh_diagonally(verts))
    listed = str(tmp_path / "list.json")
    TOD.ObjectDataset(str(tmp_path), save_to_json=True, json_name=listed)
    assert JOD.ObjectDataset(str(tmp_path), load_from_json=True,
                             json_name=listed).models == t.models
    assert len(TOD.ObjectDataset(str(tmp_path), memory_threshold=1)) == 0


@pytest.mark.parametrize("future", [False, True])
def test_frame_dataset_matches_jax(tmp_path, future):
    for scene, n in (("sceneA", 6), ("sceneB", 5)):
        traj = tmp_path / scene / "images" / "0"
        traj.mkdir(parents=True)
        for k in range(n):
            np.savez(traj / f"{k}.npz", depth=np.full((2, 2), float(k)),
                     pose=np.arange(5.0) + k)
    with open(tmp_path / "frames_to_remove.json", "w") as fh:
        json.dump(["sceneA/images/0/3.npz"], fh)
    j = JOD.FrameDataset(str(tmp_path), alpha_max=2, use_future_images=future)
    t = TOD.FrameDataset(str(tmp_path), alpha_max=2, use_future_images=future)
    assert t.index == j.index and len(t) > 0
    for i in range(len(t)):
        for alpha in (0, -2, -1) + ((2,) if future else ()):
            a = t.get_neighbor_frame(i, alpha) if alpha else t[i]
            b = j.get_neighbor_frame(i, alpha) if alpha else j[i]
            assert sorted(a) == sorted(b)
            np.testing.assert_array_equal(a["depth"], b["depth"])


def test_native_obj_parser_matches_jax_and_python(tmp_path):
    """The tracked library loads read only; the parse equals the JAX
    package's native parse and the python parser's."""
    from nextbestpath_tpu_torch.assets import generate_scene

    assert TON.native_available()
    native = os.path.join(ROOT, "native")
    before = {n: os.path.getmtime(os.path.join(native, n))
              for n in os.listdir(native)}
    scn = generate_scene("simple", seed=5)
    path = str(tmp_path / "scene.obj")
    TOI.save_obj(path, scn.verts, scn.faces)
    v, f = TON.load_obj_fast(path)
    vj, fj = JON.load_obj_fast(path)
    vp, fp = TOI.load_obj(path)
    np.testing.assert_array_equal(v, vj)
    np.testing.assert_array_equal(f, fj)
    np.testing.assert_allclose(v, vp, atol=1e-5)
    np.testing.assert_array_equal(f, fp)
    assert before == {n: os.path.getmtime(os.path.join(native, n))
                      for n in os.listdir(native)}


def test_native_obj_parser_builds_when_tracked_library_fails(tmp_path,
                                                             monkeypatch):
    """Where the tracked library does not load, the source is built into
    the build directory (a temporary one here) and parses alike."""
    import shutil

    from nextbestpath_tpu_torch import native as N

    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the parser")
    monkeypatch.setattr(N, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(N, "_open", lambda p: None if p.startswith(
        N.NATIVE_DIR) else __import__("ctypes").CDLL(p))
    monkeypatch.setattr(TON, "_lib", None)
    assert TON.native_available()
    assert os.path.exists(tmp_path / "build" / "libobj_fast.so")
    verts = _write_objs(tmp_path)
    v, f = TON.load_obj_fast(str(tmp_path / "a.obj"))
    np.testing.assert_array_equal(v, verts)
    monkeypatch.setattr(TON, "_lib", None)


# -- the helpers ----------------------------------------------------------------


def test_view_to_world_dirs_matches_jax():
    rng = np.random.default_rng(6)
    R, _ = JC.get_camera_RT(jnp.asarray(rng.normal(size=(1, 3)), jnp.float32),
                            jnp.asarray([[20.0, 135.0]], jnp.float32))
    d = rng.normal(size=(50, 3)).astype(np.float32)
    _close(TC.view_to_world_dirs(_t(d), _t(R[0])),
           JC.view_to_world_dirs(jnp.asarray(d), R[0]))


@pytest.mark.parametrize("count", [None, 220])
def test_scatter_count_img_matches_jax(count):
    """A prefix-valid buffer, with and without its count."""
    rng = np.random.default_rng(7)
    p2 = rng.uniform(-12, 12, (300, 2)).astype(np.float32)
    valid = np.arange(300) < 220
    kw = {} if count is None else {"count": count}
    want = JS.scatter_count_img(jnp.asarray(p2), jnp.asarray(valid), 32,
                                (-10.0, 10.0),
                                **{k: jnp.asarray(v) for k, v in kw.items()})
    got = TS.scatter_count_img(_t(p2), _t(valid), 32, (-10.0, 10.0),
                               **{k: torch.tensor(v) for k, v in kw.items()})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got.sum()) > 0


def test_scatter_mean_img_matches_jax():
    rng = np.random.default_rng(8)
    p2 = rng.uniform(-12, 12, (400, 2)).astype(np.float32)
    vals = rng.random((400, 1)).astype(np.float32)
    valid = rng.random(400) < 0.8
    want = JS.scatter_mean_img(jnp.asarray(p2), jnp.asarray(vals),
                               jnp.asarray(valid), 16, (-10.0, 10.0))
    got = TS.scatter_mean_img(_t(p2), _t(vals), _t(valid), 16, (-10.0, 10.0))
    _close(got, want)
    np.testing.assert_array_equal(got.numpy() > 0, np.asarray(want) > 0)


@pytest.mark.parametrize("n_rec", [0, 50, 2000])
def test_pc_similarity_matches_jax(n_rec):
    rng = np.random.default_rng(9)
    gt = rng.uniform(0, 20, (3000, 3)).astype(np.float32)
    rec = rng.uniform(-2, 22, (n_rec, 3)).astype(np.float32)
    assert TCOV.pc_similarity(gt, rec) == JCOV.pc_similarity(gt, rec)
    assert TCOV.pc_similarity(np.zeros((0, 3)), rec) == 0.0


# -- the packages -----------------------------------------------------------------


@pytest.mark.parametrize("sub", ["assets", "geometry", "models", "ops",
                                 "planning", "sim", "train", "utils",
                                 "eval"])
def test_package_exports_those_of_jax(sub):
    """Each subpackage's ``__init__`` exports every name the JAX one does,
    apart from a name that is also one of its submodules (the JAX
    package's ``train.train_nbp`` and ``models.attention`` functions hide
    their modules; the port keeps the modules reachable)."""
    import importlib
    import types

    pkg = os.path.join(ROOT, "nextbestpath_tpu", sub)
    tree = ast.parse(open(os.path.join(pkg, "__init__.py")).read())
    names = [a.asname or a.name for node in tree.body
             if isinstance(node, ast.ImportFrom) for a in node.names]
    mod = importlib.import_module(f"nextbestpath_tpu_torch.{sub}")
    shadowing = [n for n in names if os.path.exists(os.path.join(pkg,
                                                                 f"{n}.py"))]
    for n in shadowing:
        assert isinstance(getattr(mod, n), types.ModuleType), n
    assert names and [n for n in names if not hasattr(mod, n)] == []


def test_every_jax_module_has_a_counterpart():
    """Every module of the JAX package has one of the same name in the
    port, apart from the ones not ported on purpose."""
    on_purpose = {"utils/jaxcache.py"}

    def modules(pkg):
        base = os.path.join(ROOT, pkg)
        return {os.path.relpath(os.path.join(d, f), base)
                for d, _, fs in os.walk(base) for f in fs
                if f.endswith(".py") and "__pycache__" not in d}

    missing = modules("nextbestpath_tpu") - modules(
        "nextbestpath_tpu_torch") - on_purpose
    assert sorted(missing) == []


def test_port_imports_no_jax():
    """Importing every module of the port loads neither JAX nor the JAX
    package (in a fresh interpreter)."""
    code = ("import importlib, pkgutil, sys, nextbestpath_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'flax', 'optax', 'nextbestpath_tpu')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
