"""The depth pretrainer of the port against the JAX package, on the same
inputs (numpy seeds), weights and keys: flax's train-mode BatchNorm and
ManyDepth(train=True) with its running statistics after the double
application of ``stem`` and ``layer1``, the antialiased linear resize of
the supervision at the four disparity scales, the scene tables, the
sampled walks and batches with the JAX keys injected (``JaxDepthDraws``),
the supervised step in f64, and the driver and CLI with their checkpoints
read both ways.

Tolerances, and why: the tables and the walks exact (decisions); the
batch's frames within 1e-5 of their scale (the pinhole cast's f32 sums);
BatchNorm, the network's outputs and new statistics in f32 within 1e-5 of
their scale (sums in another order); the resize within 1e-6 (matmuls in
another order) and in f64 within 1e-12; the loss within 1e-6 relative;
the f64 step's loss within 1e-10 relative and its gradient within rtol
1e-4 of each tensor's largest magnitude, the JAX step run with jit
disabled as in ``test_torch_manydepth.py`` (its jitted f64 program
differs from its op-by-op one by about 1e-8 relative).
"""

import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nextbestpath_tpu.assets import generate_scene, pack_generated_scene
from nextbestpath_tpu.config import default_params
from nextbestpath_tpu.geometry.cameras import CameraIntrinsics as JIntr
from nextbestpath_tpu.geometry.cameras import get_camera_RT as j_RT
from nextbestpath_tpu.models import manydepth as JMD
from nextbestpath_tpu.models import resnet as JR
from nextbestpath_tpu.train import pretrain_depth as JPD
from nextbestpath_tpu.utils.checkpoint import \
    load_checkpoint as j_load_checkpoint
from nextbestpath_tpu_torch import assets as TA
from nextbestpath_tpu_torch import config as TC
from nextbestpath_tpu_torch.geometry.cameras import CameraIntrinsics
from nextbestpath_tpu_torch.models import manydepth as TMD
from nextbestpath_tpu_torch.models import resnet as TR
from nextbestpath_tpu_torch.models.convert import (manydepth_from_flax,
                                                   manydepth_to_flax)
from nextbestpath_tpu_torch.train import pretrain_depth as TPD

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "weights", "depth_pre", "depth_pre_best.ckpt")
TINY = dict(image_height=64, image_width=114, points_per_frame=256,
            full_pc_capacity=16384, n_gt_surface_points=1024)
H, W = 32, 56


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol=1e-5):
    """Within rtol of the reference's largest magnitude."""
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


class JaxDepthDraws:
    """The JAX depth pretrainer's keys: ``eval`` is PRNGKey(seed + 99991),
    the n-th ``batch`` fold_in(PRNGKey(seed), n); sample b's walk takes
    fold_in(that key, b) and splits it three ways for the start (``cell``,
    ``a0``) and again for each move (``dir``, ``da``)."""

    def __init__(self, seed):
        self.seed, self.n, self.key = seed, 0, None
        self.walk, self.second = {}, None

    def begin_group(self, role):
        if role == "eval":
            self.key = jax.random.PRNGKey(self.seed + 99991)
        else:
            self.n += 1
            self.key = jax.random.fold_in(jax.random.PRNGKey(self.seed),
                                          self.n)

    def _key(self, role, b):
        if role in ("cell", "dir"):
            if role == "cell":
                self.walk[b] = jax.random.fold_in(self.key, b)
            first, self.second, self.walk[b] = jax.random.split(
                self.walk[b], 3)
            return first
        return self.second

    def gumbel(self, role, shape, step=None):
        return _t(jax.random.gumbel(self._key(role, step), tuple(shape)))

    def randint(self, role, low, high, step=None, shape=()):
        return _t(jax.random.randint(self._key(role, step), tuple(shape),
                                     int(low), int(high))).long()


@pytest.fixture(scope="module")
def scenes():
    j = pack_generated_scene(generate_scene("simple", seed=3),
                             params=default_params(**TINY))
    t = TA.pack_generated_scene(TA.generate_scene("simple", seed=3),
                                params=TC.default_params(**TINY))
    return (JPD.depth_scene_from_assets(j),
            TPD.depth_scene_from_assets(t, "cpu"), t)


def _seeded_manydepth(seed, n_depth=8, learn_pose=False, rng=None):
    """The port's ManyDepth with flax's initialisers and random running
    statistics, and the same variables as a flax tree."""
    tm = TMD.flax_init_(TMD.ManyDepth(CameraIntrinsics(H, W), n_depth=n_depth,
                                      learn_pose=learn_pose), seed)
    rng = rng or np.random.default_rng(seed)
    with torch.no_grad():
        for _, b in tm.named_buffers():
            b.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, b.shape)
                                     .astype(np.float32)))
    return tm, manydepth_to_flax(tm.state_dict())


def _cams(n, rng):
    pos = np.asarray([7.0, 3.3, 7.0], np.float32) + rng.normal(
        0, 0.3, (n, 3)).astype(np.float32)
    ang = np.stack([np.zeros(n), 40.0 + rng.normal(0, 4.0, n)], -1
                   ).astype(np.float32)
    R, T = j_RT(jnp.asarray(pos), jnp.asarray(ang))
    return np.asarray(R), np.asarray(T)


def _inputs(B, rng, dtype=np.float32):
    x = rng.random((B, H, W, 3)).astype(dtype)
    xa = rng.random((B, 2, H, W, 3)).astype(dtype)
    R, T = _cams(3 * B, rng)
    return (x, R[:B].astype(dtype), T[:B].astype(dtype), xa,
            R[B:].reshape(B, 2, 3, 3).astype(dtype),
            T[B:].reshape(B, 2, 3).astype(dtype))


# -- train-mode BatchNorm and ManyDepth ------------------------------------


def test_batchnorm_train_mode_matches_flax():
    """Batch statistics over (N, H, W), the running ones moved with
    momentum 0.99 (biased variance), twice in a row; eval mode after."""
    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 2.0, (3, 5, 7, 16)).astype(np.float32)
    x2 = rng.normal(-0.5, 1.0, (2, 4, 6, 16)).astype(np.float32)
    v = {"params": {"scale": rng.uniform(0.5, 1.5, 16).astype(np.float32),
                    "bias": rng.normal(size=16).astype(np.float32)},
         "batch_stats": {"mean": rng.normal(size=16).astype(np.float32),
                         "var": rng.uniform(0.5, 2, 16).astype(np.float32)}}
    bn = fnn.BatchNorm(use_running_average=False)
    t = TR.BatchNorm(16)
    t.load_state_dict(manydepth_from_flax(v))
    for xi in (x, x2):
        want, mut = bn.apply(v, jnp.asarray(xi), mutable=["batch_stats"])
        got = t(_t(xi).permute(0, 3, 1, 2), train=True).permute(0, 2, 3, 1)
        _close(got, want)
        v = {"params": v["params"], "batch_stats": mut["batch_stats"]}
        _close(t.running_mean, v["batch_stats"]["mean"])
        _close(t.running_var, v["batch_stats"]["var"])
    want = fnn.BatchNorm(use_running_average=True).apply(v, jnp.asarray(x))
    with torch.no_grad():
        _close(t(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1), want)


@pytest.mark.parametrize("learn_pose", [False, True])
def test_manydepth_train_mode_matches_jax(learn_pose):
    """ManyDepth(train=True) at 32x56 with 8 planes, batch 2: the four
    disparities, and every running statistic after the forward (``stem``
    and ``layer1`` applied to the targets then to the contexts, the pose
    decoder once a context with ``learn_pose``) equal to flax's mutable
    ``batch_stats``."""
    rng = np.random.default_rng(1)
    tm, v = _seeded_manydepth(1, learn_pose=learn_pose, rng=rng)
    args = _inputs(2, rng)
    if learn_pose:
        args = args[:4]
    jm = JMD.ManyDepth(intr=JIntr(image_height=H, image_width=W), n_depth=8,
                       learn_pose=learn_pose)
    want, mut = jm.apply(jax.tree_util.tree_map(jnp.asarray, v),
                         *map(jnp.asarray, args), train=True,
                         mutable=["batch_stats"])
    got = tm(*map(_t, args), train=True)
    for g, w in zip(got, want):
        _close(g, w)
    new = manydepth_from_flax({"params": v["params"],
                               "batch_stats": jax.tree_util.tree_map(
                                   np.asarray, mut["batch_stats"])})
    n_stats = 0
    for k, s in tm.state_dict().items():
        if "running" in k:
            n_stats += 1
            _close(s, new[k].numpy())
            assert not torch.equal(s, _t(manydepth_from_flax(v)[k]))
    assert n_stats == (60 if learn_pose else 40)
    # The eval path reads the moved statistics: flax's eval apply agrees.
    with torch.no_grad():
        got = tm(*map(_t, args))
    want = jm.apply({"params": v["params"], "batch_stats": mut["batch_stats"]},
                    *map(jnp.asarray, args))
    _close(got[0], want[0])


# -- the supervision ---------------------------------------------------------


@pytest.mark.parametrize("hw", [(64, 114), (256, 456)])
def test_resize_and_loss_match_jax(hw):
    """resize_linear against jax.image.resize(..., "linear") at the four
    disparity scales (ceil-divided sizes, non-integer factors at 64x114),
    and the multi-scale loss with background rays."""
    Hh, Ww = hw
    rng = np.random.default_rng(2)
    x = rng.random((2, Hh, Ww, 1), dtype=np.float32)
    sizes = [(-(-Hh // d), -(-Ww // d)) for d in (1, 2, 4, 8)]
    for h, w in sizes:
        want = jax.image.resize(jnp.asarray(x), (2, h, w, 1), method="linear")
        _close(TPD.resize_linear(_t(x), (h, w)), want, 1e-6)
    zbuf = rng.uniform(1, 40, (2, Hh, Ww)).astype(np.float32)
    zbuf[:, :3] = -1.0
    disps = [rng.random((2, h, w, 1), dtype=np.float32) for h, w in sizes]
    want = float(JPD.supervised_disparity_loss(
        [jnp.asarray(d) for d in disps], jnp.asarray(zbuf)))
    got = float(TPD.supervised_disparity_loss([_t(d) for d in disps],
                                              _t(zbuf)))
    assert got == pytest.approx(want, rel=1e-6)
    with jax.enable_x64(True):
        x64 = rng.random((1, Hh, Ww, 1))
        want = jax.image.resize(jnp.asarray(x64), (1, *sizes[3], 1),
                                method="linear")
        _close(TPD.resize_linear(_t(x64), sizes[3]), want, 1e-12)


def test_background_supervises_to_dmax():
    disps = [torch.zeros((1, 4, 4, 1))] * 4
    assert float(TPD.supervised_disparity_loss(
        disps, -torch.ones((1, 4, 4)))) < 1e-6


# -- the scene, the walks, the batch -----------------------------------------


def test_depth_scene_matches_jax(scenes):
    j, t, _ = scenes
    for f in j._fields:
        a, b = np.asarray(getattr(j, f)), getattr(t, f).numpy()
        np.testing.assert_array_equal(a.reshape(b.shape), b, err_msg=f)


def test_sample_walk_matches_jax(scenes):
    """Six walklets of the held-out key, each pose exact."""
    j, t, assets = scenes
    draws = JaxDepthDraws(8)
    draws.begin_group("eval")
    for b in range(6):
        kb = jax.random.fold_in(jax.random.PRNGKey(8 + 99991), b)
        want = JPD._sample_walk(j, kb, assets.n_azim, 3)
        got = TPD._sample_walk(t, draws, assets.n_azim, 3, step=b)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_batch_matches_jax(scenes):
    """One training batch (the first step's key) at 64x114: the frames
    and cameras of ``make_batch_fn``, the JAX builder run without jit."""
    j, t, assets = scenes
    p = default_params(**TINY)
    kw = dict(image_height=64, image_width=114, fov_degrees=float(
        p.fov_degrees), znear=float(p.camera_znear), zfar=float(p.zfar))
    with jax.disable_jit():
        want = JPD.make_batch_fn(JIntr(**kw), assets.n_azim, 1)(
            j, jax.random.fold_in(jax.random.PRNGKey(8), 1))
    draws = JaxDepthDraws(8)
    draws.begin_group("batch")
    got = TPD.make_batch_fn(CameraIntrinsics(**kw), assets.n_azim, 1)(
        t, draws)
    assert len(got) == 7 and got[3].shape == (1, 2, 64, 114, 3)
    for g, w in zip(got, want):
        _close(g, w)
    assert float((got[6] > 0).float().mean()) > 0.3


# -- the step ----------------------------------------------------------------


class _F64Numpy:
    """jax.numpy with ``float32`` read as ``float64`` (flax's fixed f32
    BatchNorm in f64)."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


class _Negate:
    """Updates -grad (optax.sgd(1.0)): new minus old is the gradient."""

    def init(self, params):
        return ()

    def update(self, grads, state):
        return {k: -g for k, g in grads.items()}, state


def test_train_step_f64_matches_jax(monkeypatch):
    """``make_train_step`` in f64 at 32x56 with 8 planes, batch 1: the
    loss, the gradient of every parameter (through the batch statistics)
    and the moved running statistics, against the JAX step's."""
    rng = np.random.default_rng(3)
    tm, v = _seeded_manydepth(2, rng=rng)
    args = _inputs(1, rng, np.float64)
    zbuf = rng.uniform(1.0, 40.0, (1, H, W))
    zbuf[:, :5] = -1.0
    args = (*args, zbuf)
    with monkeypatch.context() as mp, jax.enable_x64(True):
        mp.setattr(JR, "jnp", _F64Numpy())
        jm = JMD.ManyDepth(intr=JIntr(image_height=H, image_width=W),
                           n_depth=8, dtype=jnp.float64)
        jv = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v)
        tx = optax.sgd(1.0)
        with jax.disable_jit():
            new_j, _, loss_j = JPD.make_train_step(jm, tx)(
                jv, tx.init(jv["params"]), *map(jnp.asarray, args))
        want = manydepth_from_flax(jax.tree_util.tree_map(np.asarray, new_j),
                                   np.float64)
    tm = tm.double()
    old = {k: v.clone() for k, v in tm.state_dict().items()}
    _, loss_t = TPD.make_train_step(tm, _Negate())((), *map(_t, args))
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-10)
    for k, s in tm.state_dict().items():
        d_t = (s - old[k]).numpy()
        d_j = want[k].numpy() - old[k].numpy()
        assert np.abs(d_j).max() > 0, k
        _close(d_t, d_j, 1e-4)


# -- the driver, the CLI, the checkpoints ------------------------------------


def test_driver_checkpoints_and_log(tmp_path):
    """``pretrain_depth`` for 3 steps at 32x56: finite losses, the held-out
    error at steps 2 and 3, both checkpoints in the JAX format, read by the
    JAX loader into flax's ManyDepth variable tree and back by the port
    strictly; a resume from the best one starts from its weights."""
    p = TC.default_params(image_height=H, image_width=W,
                          points_per_frame=256, full_pc_capacity=16384,
                          n_gt_surface_points=1024)
    sc = [TA.pack_generated_scene(TA.generate_scene("simple", seed=s),
                                  params=p) for s in (8, 9)]
    ev = TA.pack_generated_scene(TA.generate_scene("simple", seed=708),
                                 params=p)
    tm = TMD.flax_init_(TMD.ManyDepth(CameraIntrinsics(H, W), n_depth=8), 0)
    out, logs = str(tmp_path / "w"), str(tmp_path / "log")
    model, best = TPD.pretrain_depth(
        sc, ev, steps=3, batch=1, seed=8, out_dir=out, log_dir=logs,
        eval_every=2, image_height=H, image_width=W, params=p, model=tm,
        verbose=False, device="cpu")
    with open(os.path.join(logs, "depth_pre_loss.json")) as f:
        log = json.load(f)
    assert len(log["loss"]) == 3 and np.isfinite(log["loss"]).all()
    assert [e["step"] for e in log["eval_err"]] == [2, 3]
    assert best == min(e["err"] for e in log["eval_err"])
    jm = JMD.ManyDepth(intr=JIntr(image_height=H, image_width=W), n_depth=8)
    z = jnp.zeros
    template = jax.eval_shape(lambda k: jm.init(
        k, z((1, H, W, 3)), z((1, 3, 3)), z((1, 3)), z((1, 2, H, W, 3)),
        z((1, 2, 3, 3)), z((1, 2, 3))), jax.random.PRNGKey(0))
    latest = os.path.join(out, "depth_pre_latest.ckpt")
    jv, _, epoch, extra = j_load_checkpoint(latest, template)
    assert epoch == 3 and extra["eval_err"] == log["eval_err"][-1]["err"]
    sd = manydepth_from_flax(jax.tree_util.tree_map(np.asarray, jv))
    for k, s in model.state_dict().items():
        assert torch.equal(sd[k], s), k
    fresh = TMD.ManyDepth(CameraIntrinsics(H, W), n_depth=8)
    TPD.load_depth_checkpoint(latest, fresh)
    again, _ = TPD.pretrain_depth(
        sc, ev, steps=1, batch=1, seed=8, out_dir=out, log_dir=logs,
        eval_every=1, image_height=H, image_width=W, params=p, model=fresh,
        resume=latest, verbose=False, device="cpu")
    assert not torch.equal(again.state_dict()["stem.Conv_0.weight"],
                           sd["stem.Conv_0.weight"])


def test_resume_reads_the_jax_checkpoint():
    """The tracked JAX-written ``depth_pre_best.ckpt`` loads strictly, the
    same values as the JAX loader restores into flax's variable tree."""
    tm = TMD.ManyDepth(CameraIntrinsics(H, W))
    TPD.load_depth_checkpoint(CKPT, tm)
    jm = JMD.ManyDepth(intr=JIntr(image_height=H, image_width=W))
    z = jnp.zeros
    template = jax.eval_shape(lambda k: jm.init(
        k, z((1, H, W, 3)), z((1, 3, 3)), z((1, 3)), z((1, 2, H, W, 3)),
        z((1, 2, 3, 3)), z((1, 2, 3))), jax.random.PRNGKey(0))
    jv = j_load_checkpoint(CKPT, template)[0]
    want = manydepth_from_flax(jax.tree_util.tree_map(np.asarray, jv))
    got = tm.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_cli_tiny(tmp_path, capsys):
    """``pretrain_depth_torch.py --device cpu --tiny --steps 2`` writes both
    checkpoints and the loss log where it is told."""
    import pretrain_depth_torch

    out, logs = tmp_path / "w", tmp_path / "log"
    rc = pretrain_depth_torch.main(
        ["--device", "cpu", "--tiny", "--steps", "2", "--eval-every", "1",
         "--procgen", "simple", "--out", str(out), "--log-dir", str(logs)])
    assert rc == 0
    assert sorted(os.listdir(out)) == ["depth_pre_best.ckpt",
                                       "depth_pre_latest.ckpt"]
    assert "best held-out" in capsys.readouterr().out
    with open(logs / "depth_pre_loss.json") as f:
        assert len(json.load(f)["loss"]) == 2


@pytest.mark.slow
def test_driver_matches_jax_driver(tmp_path):
    """The whole depth pretrainer against the JAX one at 64x114 (96
    planes, batch 2, 2 steps evaluated at each): the same initial
    variables (flax's init from the seed), the JAX key stream, the same
    losses and held-out errors within 1e-4 relative (f32 through two Adam
    steps), and checkpoints with the same structure. (At 32x56 and batch
    1, layer4's BatchNorm normalises 1x2 maps, where E[x^2] - E[x]^2
    cancels: XLA's jitted step differs from its own op-by-op run by 1.2e-5
    of the loss there.) The JAX driver's compiles take minutes, so the
    test is ``slow``."""
    H, W = 64, 114
    jp = default_params(image_height=H, image_width=W, points_per_frame=256,
                        full_pc_capacity=16384, n_gt_surface_points=1024)
    tp = TC.default_params(image_height=H, image_width=W,
                           points_per_frame=256, full_pc_capacity=16384,
                           n_gt_surface_points=1024)
    j_sc = [pack_generated_scene(generate_scene("simple", seed=8), params=jp)]
    j_ev = pack_generated_scene(generate_scene("simple", seed=708), params=jp)
    t_sc = [TA.pack_generated_scene(TA.generate_scene("simple", seed=8),
                                    params=tp)]
    t_ev = TA.pack_generated_scene(TA.generate_scene("simple", seed=708),
                                   params=tp)
    kw = dict(steps=2, batch=2, seed=8, eval_every=1, image_height=H,
              image_width=W, verbose=False)
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jv, j_best = JPD.pretrain_depth(j_sc, j_ev, out_dir=str(jdir),
                                    log_dir=str(jdir), params=jp, **kw)
    jm = JMD.ManyDepth(intr=JIntr(image_height=H, image_width=W,
                                  fov_degrees=float(jp.fov_degrees),
                                  znear=float(jp.camera_znear),
                                  zfar=float(jp.zfar)))
    z = jnp.zeros
    init = jax.jit(lambda k: jm.init(
        k, z((2, H, W, 3)), z((2, 3, 3)), z((2, 3)), z((2, 2, H, W, 3)),
        z((2, 2, 3, 3)), z((2, 2, 3)), train=False))(jax.random.PRNGKey(8))
    tm = TMD.ManyDepth(CameraIntrinsics(H, W, float(tp.fov_degrees),
                                        float(tp.camera_znear),
                                        float(tp.zfar)))
    tm.load_state_dict(manydepth_from_flax(jax.tree_util.tree_map(
        np.asarray, init)))
    _, t_best = TPD.pretrain_depth(t_sc, t_ev, out_dir=str(tdir),
                                   log_dir=str(tdir), params=tp, model=tm,
                                   draws=JaxDepthDraws(8), device="cpu",
                                   **kw)
    logs = []
    for d in (jdir, tdir):
        with open(d / "depth_pre_loss.json") as f:
            logs.append(json.load(f))
    np.testing.assert_allclose(logs[1]["loss"], logs[0]["loss"], rtol=1e-4)
    np.testing.assert_allclose([e["err"] for e in logs[1]["eval_err"]],
                               [e["err"] for e in logs[0]["eval_err"]],
                               rtol=1e-4)
    assert t_best == pytest.approx(j_best, rel=1e-4)
    want = manydepth_from_flax(jax.tree_util.tree_map(np.asarray, jv))
    assert sorted(tm.state_dict()) == sorted(want)
