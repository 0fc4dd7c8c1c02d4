"""The MACARONS online trainer of the port against the JAX package: the
surface store, the memory (written by one package, read by the other),
the curriculum, the coverage-distribution losses, and
``train_macarons_online`` itself with the JAX trainer's key stream
injected (``JaxTrainDraws``), at the ``TINY`` config of the JAX package's
own online-trainer tests (32x56 frames) with the full-width models, the
weights the same on both sides.

Tolerances: the store's counts, flags and points exact; the trainer's
coverage within 1e-3 and its measured gains exact (the same trajectory);
its SCONE losses within 1e-4 relative (and 1e-5 absolute), its depth and
replay losses likewise (f32 sums in another order, autograd's against
XLA's gradients, two Adam steps).
"""

import copy
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
from nextbestpath_tpu.models.macarons import Macarons as JMacarons
from nextbestpath_tpu.models.manydepth import ManyDepth as JManyDepth
from nextbestpath_tpu.models.scone import SconeOcc as JSconeOcc
from nextbestpath_tpu.models.scone import SconeVis as JSconeVis
from nextbestpath_tpu.sim import curriculum as JCur
from nextbestpath_tpu.sim import surface_store as JSS
from nextbestpath_tpu.sim.memory import Memory as JMemory
from nextbestpath_tpu.train import pretrain_scone as JPS
from nextbestpath_tpu.train.train_macarons import \
    MacaronsTrainState as JState
from nextbestpath_tpu.train.train_macarons import \
    train_macarons_online as j_train
from nextbestpath_tpu.utils.checkpoint import \
    load_checkpoint as j_load_checkpoint
from nextbestpath_tpu_torch import assets as TA
from nextbestpath_tpu_torch import config as TC
from nextbestpath_tpu_torch.geometry.cameras import CameraIntrinsics
from nextbestpath_tpu_torch.models.convert import (manydepth_to_flax,
                                                   scone_occ_to_flax,
                                                   scone_vis_to_flax)
from nextbestpath_tpu_torch.models.macarons import (Adam, Frozen, Macarons,
                                                    apply_updates,
                                                    macarons_optimizer)
from nextbestpath_tpu_torch.sim import curriculum as TCur
from nextbestpath_tpu_torch.sim import surface_store as TSS
from nextbestpath_tpu_torch.sim.memory import Memory as TMemory
from nextbestpath_tpu_torch.train import pretrain_scone as TPS
from nextbestpath_tpu_torch.train.train_macarons import (
    TINY, MacaronsTrainState, train_macarons_online)

COV_ATOL = 1e-3
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5
KW = dict(seed=3, n_tokens=128, n_proxy_tokens=128, verbose=False)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the tier-1 run puts several test processes on
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


class JaxTrainDraws:
    """The JAX trainer's key stream: ``begin_group`` takes the next key as
    its ``next_key()`` does; a substep folds its index in; ``uniforms``
    splits the key once a shape, and again for a list entry (the depth
    step's ``split(rng)`` then ``split(k_j, 5)``); ``gumbel`` is
    ``categorical``'s noise; ``permutation`` serves SconeOcc's split of
    its key."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)
        self.cur = None
        self.groups = []

    def begin_group(self, role):
        self.key, self.cur = jax.random.split(self.key)
        self.groups.append(role)

    def _key(self, step):
        return self.cur if step is None else jax.random.fold_in(self.cur, step)

    def uniform(self, role, shape, step=None):
        return _t(jax.random.uniform(self._key(step), tuple(shape)))

    def _split_uniforms(self, key, shapes):
        keys = jax.random.split(key, len(shapes))
        return [self._split_uniforms(k, s) if isinstance(s, list)
                else _t(jax.random.uniform(k, tuple(s)))
                for k, s in zip(keys, shapes)]

    def uniforms(self, role, shapes, step=None):
        return self._split_uniforms(self._key(step), shapes)

    def gumbel(self, role, shape, step=None):
        return _t(jax.random.gumbel(self._key(step), tuple(shape)))

    def randint(self, role, low, high, step=None, shape=()):
        return _t(jax.random.randint(self._key(step), tuple(shape), int(low),
                                     int(high))).long()

    def permutation(self, role, n, step=None):
        k_global, k_ds = jax.random.split(self.cur)
        k = k_global if step is None else jax.random.fold_in(k_ds, step)
        return _t(jax.random.permutation(k, n)).long()


@pytest.fixture(scope="module")
def scenes():
    j = pack_generated_scene(generate_scene("simple", seed=2),
                             params=default_params(**TINY))
    t = TA.pack_generated_scene(TA.generate_scene("simple", seed=2),
                                params=TC.default_params(**TINY))
    return j, t


@pytest.fixture(scope="module")
def models():
    """The port's seeded bundle at 32x56 and the same weights as the JAX
    package's Macarons (through the converters; flax's init would compile
    for a minute)."""
    m = Macarons.create(0, image_height=32, image_width=56)
    jm = JMacarons(
        depth=JManyDepth(intr=JIntr(image_height=32, image_width=56)),
        scone_occ=JSconeOcc(seq_len=2048), scone_vis=JSconeVis(),
        depth_vars=jax.tree_util.tree_map(jnp.asarray,
                                          manydepth_to_flax(m.depth_vars)),
        occ_vars={"params": jax.tree_util.tree_map(
            jnp.asarray, scone_occ_to_flax(m.occ_vars))},
        vis_vars={"params": jax.tree_util.tree_map(
            jnp.asarray, scone_vis_to_flax(m.vis_vars))})
    return m, jm


def _j_state(jm):
    txs = [optax.adam(1e-4) for _ in range(3)]
    model = copy.copy(jm)
    return JState(model=model, occ_opt_state=txs[0].init(model.occ_vars),
                  vis_opt_state=txs[1].init(model.vis_vars),
                  depth_opt_state=txs[2].init(model.depth_vars),
                  occ_tx=txs[0], vis_tx=txs[1], depth_tx=txs[2])


def _t_state(m):
    return MacaronsTrainState.create(params=TC.default_params(**TINY),
                                     model=m, device="cpu")


def _losses_close(got, want, keys):
    for k in keys:
        assert len(got[k]) == len(want[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL, err_msg=k)


# -- surface store ---------------------------------------------------------


def _store_inputs(seed, n=600, lo=0.0, hi=8.0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    pts[n // 2:] = pts[:n // 2] + rng.normal(0, 0.05, (n - n // 2, 3)
                                             ).astype(np.float32)
    valid = rng.random(n) < 0.8
    return pts, valid


def _same_store(t, j):
    np.testing.assert_array_equal(t.points.numpy(), np.asarray(j.points))
    np.testing.assert_array_equal(t.occupied.numpy(), np.asarray(j.occupied))
    np.testing.assert_array_equal(t.covered.numpy(), np.asarray(j.covered))
    assert int(t.count) == int(j.count)


@pytest.mark.parametrize("capacity", [4096, 700])
def test_surface_store_fill_and_gain_match_jax(capacity):
    """Two fills with duplicate voxels and invalid rows (the second batch
    overflowing the small capacity), then the coverage gain of two clouds:
    counts, points, voxel flags and covered flags equal."""
    lo, hi, res = np.zeros(3, np.float32), np.full(3, 8.0, np.float32), 0.5
    j = JSS.SurfaceStore.create(capacity, lo, hi, res)
    t = TSS.SurfaceStore.create(capacity, lo, hi, res)
    assert t.occupied.shape[0] == j.occupied.shape[0] == 17 ** 3
    for seed in (0, 1):
        pts, valid = _store_inputs(seed)
        j = j.fill(jnp.asarray(pts), jnp.asarray(valid))
        t = t.fill(_t(pts), _t(valid))
        _same_store(t, j)
    assert 0 < int(t.count) <= capacity
    for seed in (2, 3):
        pts, valid = _store_inputs(seed, n=300)
        gj, j = JSS.camera_coverage_gain(j, jnp.asarray(pts),
                                         jnp.asarray(valid), 0.3)
        gt, t = TSS.camera_coverage_gain(t, _t(pts), _t(valid), 0.3)
        assert float(gt) == float(gj)
        _same_store(t, j)
    assert float(t.covered.sum()) > 0


def test_capacity_dropped_points_leave_their_voxel_free():
    t = TSS.SurfaceStore.create(3, np.zeros(3), np.full(3, 4.0), 1.0)
    pts = np.array([[0.5, 0.5, 0.5], [1.5, 0.5, 0.5], [2.5, 0.5, 0.5],
                    [3.5, 0.5, 0.5]], np.float32)
    t = t.fill(_t(pts), torch.ones(4, dtype=torch.bool))
    assert int(t.count) == 3
    assert not bool(t.occupied[t.voxel_id(_t(pts[3:]))[0]])


def test_scene_coverage_matches_jax():
    rng = np.random.default_rng(4)
    gt = rng.uniform(0, 10, (500, 3)).astype(np.float32)
    rec = gt + rng.normal(0, 0.3, (500, 3)).astype(np.float32)
    rec = np.concatenate([rec, rng.uniform(0, 10, (2500, 3))]).astype(
        np.float32)
    gt_cells = (gt[:, 0] // 2.5).astype(np.int32)
    rec_cells = (rec[:, 0] // 2.5).astype(np.int32)
    rec_valid = rng.random(len(rec)) < 0.9
    gt_valid = rng.random(len(gt)) < 0.95
    for gv in (None, gt_valid):
        want = float(JSS.scene_coverage(
            jnp.asarray(gt), jnp.asarray(gt_cells), jnp.asarray(rec),
            jnp.asarray(rec_cells), jnp.asarray(rec_valid), 0.4,
            gt_valid=None if gv is None else jnp.asarray(gv)))
        got = float(TSS.scene_coverage(
            _t(gt), _t(gt_cells), _t(rec), _t(rec_cells), _t(rec_valid), 0.4,
            gt_valid=None if gv is None else _t(gv)))
        assert got == pytest.approx(want, abs=1e-7)
        assert 0.1 < got < 1.0


def test_trainer_store_grid(scenes):
    """The trainer's 262,144-point store on the scene's box: the same
    voxel grid (107 x 20 x 107 on simple/8 at the default scale)."""
    j_assets, t_assets = scenes
    for a in (j_assets, t_assets):
        lo = a.settings.scene.x_min - 0.2
        hi = a.settings.scene.x_max + 0.2
        j = JSS.SurfaceStore.create(16, jnp.asarray(lo), jnp.asarray(hi), 0.5)
        t = TSS.SurfaceStore.create(16, lo, hi, 0.5)
        np.testing.assert_array_equal(t.dims.numpy(), np.asarray(j.dims))
    t_assets8 = TA.pack_generated_scene(TA.generate_scene("simple", seed=8))
    s = t_assets8.settings.scene
    t = TSS.SurfaceStore.create(16, s.x_min - 0.2, s.x_max + 0.2, 0.5)
    assert t.dims.tolist() == [107, 20, 107]
    assert t.occupied.shape[0] == 228980


# -- memory, curriculum, losses --------------------------------------------


def _write_memory(mem, path, rng, intr_hw=(32, 56)):
    H, W = intr_hw
    for i in range(6):
        d = rng.uniform(2.0, 30.0, (H, W)).astype(np.float32)
        d[0, :5] = -1.0
        R = np.eye(3, dtype=np.float32)
        T = np.asarray([0.1 * i, 0.0, 0.0], np.float32)
        rgb = rng.random((H, W, 3)).astype(np.float32)
        mem.save_frame(path, 1, i, d, R, T, 750.0, rgb=rgb)
        mem.save_depth(path, 1, i, d, R, T)
    P = 64
    mem.save_occupancy(path, 1, rng.uniform(0, 40, (P, 3)),
                       rng.uniform(size=(P, 1)), rng.uniform(size=(P, 1)),
                       rng.uniform(size=(P, 98)), np.ones((P, 1)))
    mem.save_surface(path, 1, rng.uniform(0, 5, (50, 3)).astype(np.float32),
                     40)
    mem.save_poses(path, [[1.0, 2.0, 3.0, 0.0, 45.0]], traj=1)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_memory_cross_read(tmp_path, writer):
    """A memory written by one package is read by the other: the same
    files, frames, snapshots and poses, the same replay window and scone
    replay scene from the same random.Random."""
    import random

    path = str(tmp_path / "scene")
    W, R_ = (JMemory, TMemory) if writer == "jax" else (TMemory, JMemory)
    _write_memory(W([path], n_trajectories=2), path,
                  np.random.default_rng(0))
    wm = W([path], n_trajectories=2)
    rm = R_([path], n_trajectories=2)
    assert rm.n_frames(path, 1) == wm.n_frames(path, 1) == 6
    assert rm.n_depths(path, 1) == 6 and rm.has_occupancy(path, 1)
    np.testing.assert_array_equal(rm.load_surface(path, 1),
                                  wm.load_surface(path, 1))
    assert rm.load_poses(path, traj=1) == [[1.0, 2.0, 3.0, 0.0, 45.0]]
    fr = rm.random_replay_frames(path, 4, rng=random.Random(5))
    fw = wm.random_replay_frames(path, 4, rng=random.Random(5))
    for a, b in zip(fr, fw):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    intr_j = JIntr(image_height=32, image_width=56)
    intr_t = CameraIntrinsics(image_height=32, image_width=56)
    sj = JMemory([path], 2).get_random_scene_for_scone_model(
        path, intr_j, n_frames=5, points_per_frame=64,
        rng=random.Random(9), n_replay_poses=2)
    st = TMemory([path], 2).get_random_scene_for_scone_model(
        path, intr_t, n_frames=5, points_per_frame=64,
        rng=random.Random(9), n_replay_poses=2, device="cpu")
    assert sorted(sj) == sorted(st)
    for k in sj:
        if sj[k].dtype == bool:
            np.testing.assert_array_equal(st[k], sj[k], err_msg=k)
        else:
            np.testing.assert_allclose(st[k], sj[k], rtol=1e-5, atol=1e-4,
                                       err_msg=k)
    rm.begin_trajectory(path)  # the current slot 0: nothing of slot 1 goes
    assert rm.n_frames(path, 1) == 6


def test_curriculum_is_the_jax_one():
    for n in (2, 7, 100):
        np.testing.assert_array_equal(
            TCur.curriculum_sampling_distances(n, 1.5, 40.0),
            JCur.curriculum_sampling_distances(n, 1.5, 40.0))
        np.testing.assert_array_equal(
            TCur.curriculum_sampling_cell_number(n),
            JCur.curriculum_sampling_cell_number(n))


@pytest.mark.parametrize("name", sorted(JPS.COV_LOSSES))
def test_coverage_losses_match_jax(name):
    rng = np.random.default_rng(1)
    x = rng.random((3, 20)).astype(np.float32)
    y = rng.random((3, 20)).astype(np.float32)
    want = float(JPS.COV_LOSSES[name](jnp.asarray(x), jnp.asarray(y)))
    got = float(TPS.COV_LOSSES[name](_t(x), _t(y)))
    assert got == pytest.approx(want, rel=1e-5)


def test_optimizers_match_optax():
    """Adam (with and without the global-norm clip) and the frozen
    transform against optax, three steps."""
    rng = np.random.default_rng(2)
    params = {"a": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    for clip in (0.0, 0.5):
        tx = (optax.chain(optax.clip_by_global_norm(clip), optax.adam(1e-2))
              if clip else optax.adam(1e-2))
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        js = tx.init(jp)
        opt = Adam(1e-2, clip=clip)
        tp = {k: _t(v) for k, v in params.items()}
        ts = opt.init(tp)
        for step in range(3):
            g = {k: rng.normal(size=v.shape).astype(np.float32)
                 for k, v in params.items()}
            u, js = tx.update(jax.tree_util.tree_map(jnp.asarray, g), js)
            jp = optax.apply_updates(jp, u)
            tu, ts = opt.update({k: _t(v) for k, v in g.items()}, ts)
            tp = apply_updates(tp, tu)
            for k in params:
                np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                           rtol=1e-6, atol=1e-7)
    depth_tx, scone_tx = macarons_optimizer(freeze_depth=True)
    assert isinstance(depth_tx, Frozen) and isinstance(scone_tx, Adam)
    upd, _ = depth_tx.update({"a": torch.ones(2)}, depth_tx.init({}))
    assert float(upd["a"].abs().sum()) == 0.0


# -- the trainer -----------------------------------------------------------


def test_train_macarons_perfect_depth_matches_jax(scenes, models):
    """3 perfect-depth poses (the CLI's default): the same trajectory
    (coverage within 1e-3, the measured gains exact), the losses within
    the stated tolerance, the key groups in the JAX order, and the SCONE
    weights' three Adam updates within 2% (of each tensor's update norm)."""
    j_assets, t_assets = scenes
    m, jm = models
    js = _j_state(jm)
    want = j_train(j_assets, js, params=default_params(**TINY), n_poses=3,
                   **KW)
    ts = _t_state(m)
    draws = JaxTrainDraws(KW["seed"])
    got = train_macarons_online(t_assets, ts, params=TC.default_params(**TINY),
                                n_poses=3, draws=draws, **KW)
    np.testing.assert_allclose(got["coverage"], want["coverage"],
                               atol=COV_ATOL)
    assert got["gain"] == want["gain"]
    _losses_close(got, want, ("occ_loss", "cov_loss"))
    pose = ["cov", "frame", "proxy_tokens", "tokens", "move", "new_frame",
            "scone"]
    assert draws.groups == ["proxy", "init"] + pose * 3
    assert got["coverage"][-1] > got["coverage"][0] > 0.0
    # Adam's steps are near lr x sign(g): compare each tensor's whole
    # update (after - before) within 2% of its norm, not element by
    # element, with a floor of a tenth of an lr step a weight (rms): a
    # gradient that is zero in exact arithmetic (an attention key's bias)
    # leaves round-off under Adam's eps, whose steps are noise.
    for name, tree in (("occ", js.model.occ_vars["params"]),
                       ("vis", js.model.vis_vars["params"])):
        conv = scone_occ_to_flax if name == "occ" else scone_vis_to_flax
        before = jax.tree_util.tree_leaves(conv(getattr(m, f"{name}_vars")))
        after = jax.tree_util.tree_leaves(conv(getattr(ts.model,
                                                       f"{name}_vars")))
        for (path, a), b, b0 in zip(jax.tree_util.tree_leaves_with_path(tree),
                                    after, before):
            dj, dt = np.asarray(a) - b0, b - b0
            floor = 0.1 * 1e-4 * np.sqrt(dj.size)
            assert np.linalg.norm(dt - dj) <= (0.02 * np.linalg.norm(dj)
                                               + floor), path


def _prewritten_memory(cls, path):
    """Another trajectory (slot 1) already on disk, as the JAX package's
    own full-stack test writes it."""
    mem = cls([path], n_trajectories=2, current_epoch=0)
    rng = np.random.default_rng(7)
    for i in range(8):
        d = rng.uniform(2.0, 30.0, (32, 56)).astype(np.float32)
        mem.save_depth(path, 1, i, d, np.eye(3, dtype=np.float32),
                       np.zeros(3, np.float32))
    P = 128
    mem.save_occupancy(path, 1, rng.uniform(0, 40, size=(P, 3)),
                       rng.uniform(size=(P, 1)), rng.uniform(size=(P, 1)),
                       rng.uniform(size=(P, 98)), np.ones((P, 1)))
    return mem


def test_train_macarons_full_stack_matches_jax(scenes, models, tmp_path):
    """5 poses of the whole stack: learned and predicted depth, a memory
    with another trajectory, one replay loop a pose and the remap every 3
    poses. The same trajectory, losses within tolerance, the same memory
    files and poses, and the saved depths close."""
    j_assets, t_assets = scenes
    m, jm = models
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    kw = dict(KW, n_poses=5, use_perfect_depth=False, learn_depth=True,
              memory_replay_loops=1)
    jmem = _prewritten_memory(JMemory, jdir)
    want = j_train(j_assets, _j_state(jm),
                   params=default_params(**TINY, remap_every_n_poses=3),
                   memory=jmem, scene_memory_path=jdir, **kw)
    tmem = _prewritten_memory(TMemory, tdir)
    draws = JaxTrainDraws(KW["seed"])
    got = train_macarons_online(
        t_assets, _t_state(m),
        params=TC.default_params(**TINY, remap_every_n_poses=3),
        memory=tmem, scene_memory_path=tdir, draws=draws, **kw)
    np.testing.assert_allclose(got["coverage"], want["coverage"],
                               atol=COV_ATOL)
    assert got["gain"] == want["gain"]
    _losses_close(got, want, ("occ_loss", "cov_loss", "depth_loss",
                              "replay_occ_loss", "replay_cov_loss"))
    assert len(got["depth_loss"]) == 2 and len(got["replay_cov_loss"]) == 5
    assert draws.groups.count("remap") == 2 and draws.groups.count(
        "depth") == 2
    for sub in ("frames", "depths", "surface", "occupancy"):
        names = sorted(os.listdir(TMemory.trajectory_dir(tdir, 0, sub)))
        assert names == sorted(os.listdir(JMemory.trajectory_dir(jdir, 0,
                                                                 sub)))
    assert tmem.n_frames(tdir, 0) == 5 and tmem.n_depths(tdir, 0) == 5
    np.testing.assert_array_equal(tmem.load_poses(tdir),
                                  jmem.load_poses(jdir))
    # The saved depths: the predicted maps carry the error mask (-1), a
    # threshold test (regularity < mean + std) that may flip at a pixel on
    # its edge; at most 0.5% of a map's pixels, the others close.
    for i in range(5):
        d_t, d_j = (np.load(os.path.join(c.trajectory_dir(d, 0, "depths"),
                                         f"{i}.npz"))["depth"]
                    .astype(np.float32)
                    for c, d in ((TMemory, tdir), (JMemory, jdir)))
        flip = (d_t < 0) != (d_j < 0)
        assert flip.mean() <= 0.005, i
        np.testing.assert_allclose(d_t[~flip], d_j[~flip], rtol=2e-3,
                                   atol=1e-3)


def test_default_draws_repeat_and_guard(scenes, models):
    """The default provider: one seed gives one run. The staged-unfreeze
    guard at a tiny reject factor rolls every update after the first back
    to the snapshot, and log_depth_error logs both depth metrics."""
    _, t_assets = scenes
    m, _ = models
    p = TC.default_params(**TINY)
    runs = [train_macarons_online(t_assets, _t_state(m), params=p,
                                  n_poses=2, **KW)["coverage"]
            for _ in range(2)]
    assert runs[0] == runs[1]
    ts = _t_state(m)
    logs = train_macarons_online(t_assets, ts, params=p, n_poses=6,
                                 learn_depth=True, depth_reject_factor=1e-6,
                                 log_depth_error=True, **KW)
    assert len(logs["depth_loss"]) == 3
    assert logs["depth_rejected_poses"] == [4, 5]
    assert len(logs["depth_abs_err"]) == 4 and len(logs["store_coverage"]) == 6
    assert all(np.isfinite(logs["depth_abs_err"]))


def test_cli_tiny_writes_checkpoints_jax_reads(tmp_path, models):
    """train_macarons_torch.py's main on the CPU (--tiny --poses 2): the
    JAX loader reads both checkpoints into the flax layout, and the JAX
    SconeVis on the read variables computes what the port's does."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import train_macarons_torch

    out = str(tmp_path / "w")
    assert train_macarons_torch.main(["--device", "cpu", "--tiny", "--poses",
                                      "2", "--out", out]) == 0
    m, _ = models
    for name, conv in (("occ", scone_occ_to_flax), ("vis", scone_vis_to_flax)):
        template = {"params": jax.tree_util.tree_map(
            jnp.asarray, conv(getattr(m, f"{name}_vars")))}
        got, *_ = j_load_checkpoint(os.path.join(out, f"scone_{name}.ckpt"),
                                    template)
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(template)
        if name == "vis":
            vis_vars = got
    from nextbestpath_tpu_torch.models.convert import scone_vis_from_flax
    from nextbestpath_tpu_torch.models.scone import SconeVis
    pts = np.random.default_rng(0).random((1, 16, 4), dtype=np.float32)
    vh = np.random.default_rng(1).random((1, 16, 64), dtype=np.float32)
    want = JSconeVis().apply(vis_vars, jnp.asarray(pts),
                             view_harmonics=jnp.asarray(vh))
    tv = SconeVis()
    tv.load_state_dict(scone_vis_from_flax(
        jax.tree_util.tree_map(np.asarray, vis_vars)))
    with torch.no_grad():
        got = tv(_t(pts), view_harmonics=_t(vh))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_trainer_imports_nothing_of_jax():
    """The trainer's modules and the CLI import with jax, flax, msgpack and
    the JAX package blocked, and the trained depth_pre checkpoint loads
    into ManyDepth strict there."""
    import subprocess
    import sys

    code = r"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "msgpack",
                                  "nextbestpath_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import train_macarons_torch
from nextbestpath_tpu_torch.train import train_macarons, depth_losses, pretrain_scone
from nextbestpath_tpu_torch.sim import surface_store, memory, curriculum
from nextbestpath_tpu_torch.models import manydepth, resnet, macarons, convert
from nextbestpath_tpu_torch.geometry.cameras import CameraIntrinsics
from nextbestpath_tpu_torch.utils.checkpoint import load_checkpoint
v = load_checkpoint("weights/depth_pre/depth_pre_best.ckpt")[0]
m = manydepth.ManyDepth(CameraIntrinsics(32, 56))
m.load_state_dict(convert.manydepth_from_flax(v), strict=True)
bad = [k for k in sys.modules
       if k.split(".")[0] in ("jax", "flax", "msgpack", "nextbestpath_tpu")]
assert not bad, bad
"""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
