"""The port's NBP training step and its bookkeeping (``models/unet.py``
train mode and ``nbp_loss``, ``train/train_nbp.py``, ``train/replay.py``)
against the JAX package, on the same inputs (numpy seeds) and the same
converted flax variables of ``NBP(width=8)`` at a 64x64 input.

Tolerances, and why:

* the loss and the value gather: rtol 1e-6;
* the train-mode forward, the loss and the new batch_stats in f32: rtol
  1e-4 of each tensor's largest magnitude (``_close``);
* the gradients: rtol 1e-4, computed in f64 on both sides (the flax
  module's BatchNorm outputs and its two outputs, which it fixes to f32,
  kept in f64 by a patch of its module's ``jnp`` scoped to the test). In f32 the
  gradients of this network are ill-conditioned: with BatchNorm on
  batch statistics, a gradient leaf is a sum of many terms of both signs
  (the biases of the convolutions before a BatchNorm are exactly zero in
  exact arithmetic), and the JAX package's own f32 gradient is farther
  than rtol 1e-4 from its f64 one (the median leaf; the test checks this
  premise). So the f32 test holds the
  port to accuracy instead: the port's f32 gradient tree is no farther
  (in L2) from the f64 reference than ``F32_TREE`` times the JAX f32
  tree, and each leaf no farther than ``F32_LEAF`` times the JAX f32 leaf
  plus rtol 1e-4 of the leaf and 1e-6 of the largest leaf. The factors
  leave room for PyTorch's CPU convolutions, whose f32 sums, and so the
  port's error, change with the thread count;
* AdamW behind the accumulator against ``optax.MultiSteps(adamw)``, one
  cycle and a partial one across an epoch boundary: rtol 1e-4, in f64 for
  the same reason (Adam's first steps move each weight by about lr times
  the sign of its gradient, so a gradient near zero decides a whole
  step);
* host bookkeeping (schedulers, micro chunks, replay sampling) and the
  replay files: equal.
"""

import contextlib
import importlib
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextbestpath_tpu.models import NBP as FlaxNBP
from nextbestpath_tpu.models import unet as JU
from nextbestpath_tpu.models.unet import nbp_loss as j_loss
from nextbestpath_tpu.train.replay import Experience as JExperience
from nextbestpath_tpu.train.replay import ReplayDB as JReplayDB
from nextbestpath_tpu_torch.models import unet as U
from nextbestpath_tpu_torch.models.convert import (flax_to_state_dict,
                                                   state_dict_to_flax)
from nextbestpath_tpu_torch.train import train_nbp as TT
from nextbestpath_tpu_torch.train.replay import Experience, ReplayDB

JT = importlib.import_module("nextbestpath_tpu.train.train_nbp")

S = 64          # model input side
F32_TREE = 3.0
F32_LEAF = 10.0


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the tier-1 run puts several test processes on
    the machine's cores, where PyTorch's default (one thread a core) makes
    each small operation wait on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def flax_vars():
    fm = FlaxNBP(width=8)
    v = fm.init(jax.random.PRNGKey(1), jnp.zeros((1, S, S, 5)), train=True)
    return jax.tree_util.tree_map(np.asarray, v)


def _torch_model(v, f64=False):
    m = U.NBP(width=8)
    m.load_state_dict(flax_to_state_dict(v["params"], v["batch_stats"]))
    return U.as_float64(m) if f64 else m


class _F64Numpy:
    """jax.numpy with ``float32`` read as ``float64``."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@contextlib.contextmanager
def _jax_f64(monkeypatch):
    """x64 on, and the flax NBP's fixed f32 (its BatchNorms' dtype and the
    cast of its two outputs) read as f64 through its module's ``jnp``; its
    convolutions follow NBP(dtype=float64)."""
    with monkeypatch.context() as mp, jax.enable_x64(True):
        mp.setattr(JU, "jnp", _F64Numpy())
        yield


def _to64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _batch(seed, B=4):
    rng = np.random.default_rng(seed)
    K = 5
    return dict(
        x=rng.standard_normal((B, S, S, 5)).astype(np.float32),
        layout=(rng.random((B, S, S, 1)) > 0.7).astype(np.float32),
        pixels=np.stack([rng.integers(0, 8, (B, K)),
                         rng.integers(0, S // 4, (B, K)),
                         rng.integers(0, S // 4, (B, K))], -1).astype(np.int32),
        gains=(rng.random((B, K)) * 5).astype(np.float32),
        w=(rng.random((B, K)) > 0.3).astype(np.float32),
        sw=np.array([1.0] * (B - 1) + [0.0], np.float32))


# -- the loss and the gather -------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_nbp_loss_and_gather_match(weighted):
    rng = np.random.default_rng(3)
    B, K = 3, 7
    vm = rng.standard_normal((B, 16, 16, 8)).astype(np.float32)
    pix = np.stack([rng.integers(0, 8, (B, K)), rng.integers(0, 16, (B, K)),
                    rng.integers(0, 16, (B, K))], -1).astype(np.int32)
    gains = rng.random((B, K)).astype(np.float32) * 4
    lay_p = rng.random((B, 32, 32, 1)).astype(np.float32)
    lay_p[0, :2, :2, 0] = [[0.0, 1.0], [1e-9, 1 - 1e-9]]  # at the clip
    lay_t = (rng.random((B, 32, 32, 1)) > 0.5).astype(np.float32)
    lv = np.array([0.3, -0.2], np.float32)
    kw_j, kw_t = {}, {}
    if weighted:
        w = (rng.random((B, K)) > 0.4).astype(np.float32)
        sw = np.array([1, 0, 1], np.float32)
        kw_j = dict(value_weight=w, sample_weight=sw)
        kw_t = {k: torch.from_numpy(v) for k, v in kw_j.items()}
    pv_j = JT._gather_pred_values(jnp.asarray(vm), jnp.asarray(pix))
    pv_t = TT._gather_pred_values(torch.from_numpy(vm), torch.from_numpy(pix))
    np.testing.assert_array_equal(pv_t.numpy(), np.asarray(pv_j))
    want = j_loss(jnp.asarray(lv), pv_j, gains, lay_p, lay_t, **kw_j)
    got = U.nbp_loss(torch.from_numpy(lv), pv_t, torch.from_numpy(gains),
                     torch.from_numpy(lay_p), torch.from_numpy(lay_t), **kw_t)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# -- train mode: forward, batch_stats, gradients ----------------------------

def _j_loss_fn(fm, v, b):
    def lf(params):
        (vm, om), mut = fm.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, b["x"],
            train=True, mutable=["batch_stats"])
        pv = JT._gather_pred_values(vm, b["pixels"])
        loss = j_loss(params["log_vars"], pv, b["gains"], om, b["layout"],
                      value_weight=b["w"], sample_weight=b["sw"])
        return loss, (mut["batch_stats"], vm, om)
    return lf


def _t_step(m, b, dtype):
    """The port's micro step on batch b: (loss, value map, obstacle map,
    gradients and new batch_stats as flax-named f64 leaves)."""
    m.train()
    t = {k: torch.from_numpy(v) for k, v in b.items()}
    vm, om = m(t["x"].to(dtype))
    pv = TT._gather_pred_values(vm, t["pixels"])
    loss = U.nbp_loss(m.log_vars, pv, t["gains"], om, t["layout"],
                      value_weight=t["w"], sample_weight=t["sw"])
    grads = torch.autograd.grad(loss, list(m.parameters()))
    sd = dict(m.state_dict())
    sd.update({n: g for (n, _), g in zip(m.named_parameters(), grads)})
    gp, _ = state_dict_to_flax(sd, dtype=np.float64)
    _, stats = state_dict_to_flax(m.state_dict(), dtype=np.float64)
    return loss.detach(), vm.detach(), om.detach(), gp, stats


def _variables(sd):
    p, s = state_dict_to_flax(sd, dtype=np.float64)
    return _leaves({"params": p, "batch_stats": s})


def test_train_mode_forward_and_batch_stats_match(flax_vars):
    """f32, one micro step of 4 with a zero-weighted tail row: the loss,
    both maps and the updated batch_stats (flax's biased-variance update at
    momentum 0.9) within rtol 1e-4; eval mode leaves the stats alone."""
    b = _batch(0)
    fm = FlaxNBP(width=8)
    (loss_j, (stats_j, vm_j, om_j)), _ = jax.value_and_grad(
        _j_loss_fn(fm, flax_vars, b), has_aux=True)(flax_vars["params"])
    m = _torch_model(flax_vars)
    loss_t, vm_t, om_t, _, stats_t = _t_step(m, b, torch.float32)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4)
    _close(vm_t.numpy(), vm_j)
    _close(om_t.numpy(), om_j)
    want, got = _leaves(stats_j), _leaves(stats_t)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])
    before = {k: v.clone() for k, v in m.state_dict().items()}
    m.eval()
    with torch.no_grad():
        m(torch.from_numpy(b["x"]))
    assert all(torch.equal(v, m.state_dict()[k]) for k, v in before.items())


def test_train_mode_gradients_match(flax_vars, monkeypatch):
    """Gradients of the loss: in f64 on both sides within rtol 1e-4 (every
    leaf); in f32 the port as close to the f64 reference as the JAX f32
    gradient, within F32_TREE and F32_LEAF (module docstring)."""
    b = _batch(1)
    g_j32 = _leaves(jax.grad(lambda p: _j_loss_fn(FlaxNBP(width=8), flax_vars,
                                                  b)(p)[0])(
        flax_vars["params"]))
    with _jax_f64(monkeypatch):
        v64 = _to64(flax_vars)
        b64 = {k: (v.astype(np.float64) if v.dtype == np.float32 else v)
               for k, v in b.items()}
        (loss_64, _), g = jax.value_and_grad(
            _j_loss_fn(FlaxNBP(width=8, dtype=jnp.float64), v64, b64),
            has_aux=True)(v64["params"])
        g_64 = _leaves(g)
        loss_64 = float(loss_64)
    loss_t64, _, _, g_t64, _ = _t_step(_torch_model(flax_vars, f64=True),
                                       b, torch.float64)
    np.testing.assert_allclose(float(loss_t64), loss_64, rtol=1e-10)
    g_t64 = _leaves(g_t64)
    assert set(g_t64) == set(g_64)
    top = max(np.linalg.norm(v) for v in g_64.values())
    for k, want in g_64.items():
        np.testing.assert_allclose(g_t64[k], want, rtol=1e-4,
                                   atol=1e-10 * top, err_msg=k)
    g_t32 = _leaves(_t_step(_torch_model(flax_vars), b, torch.float32)[3])
    err_t = {k: np.linalg.norm(g_t32[k] - ref) for k, ref in g_64.items()}
    err_j = {k: np.linalg.norm(g_j32[k] - ref) for k, ref in g_64.items()}
    # The premise of this accuracy check: the JAX package's own f32
    # gradient is farther than rtol 1e-4 from the f64 one (the median leaf).
    assert np.median([err_j[k] / np.linalg.norm(ref)
                      for k, ref in g_64.items()]) > 1e-4
    tree_t = np.sqrt(sum(e * e for e in err_t.values()))
    tree_j = np.sqrt(sum(e * e for e in err_j.values()))
    assert tree_t <= F32_TREE * tree_j, (tree_t, tree_j)
    worse = [(k, err_t[k], err_j[k]) for k, ref in g_64.items()
             if err_t[k] > F32_LEAF * err_j[k] + 1e-4 * np.linalg.norm(ref)
             + 1e-6 * top]
    assert not worse, worse


# -- AdamW behind the accumulator against optax.MultiSteps(adamw) ----------

def _experiences(n, seed, cls):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(1, 6))
        out.append(cls(
            model_input=(rng.random((5, S, S)) * 3).astype(np.float16),
            gt_layout=(rng.random((S, S)) > 0.7).astype(np.uint8),
            pixels=np.stack([rng.integers(0, 8, k), rng.integers(0, S // 4, k),
                             rng.integers(0, S // 4, k)], 1).astype(np.int32),
            gains=(rng.random(k) * 5).astype(np.float32),
            pose_i=5 + 3 * i))
    return out


def test_accumulated_adamw_matches_optax_multisteps(flax_vars, monkeypatch):
    """7 entries in micro batches of 2 (a padded tail each epoch), 3 micro
    steps an optimizer step: epoch 1 emits once and leaves one micro step
    pending, epoch 2 emits on its second micro step and leaves two. After
    each epoch: losses, the mini-step count, the emitted steps, the
    pending gradient mean, the parameters and the batch_stats, in f64."""
    data_j = _experiences(7, 4, JExperience)
    data_t = [Experience(**vars(e)) for e in data_j]
    pool = list(range(7))
    m = _torch_model(flax_vars, f64=True)
    st = TT.init_train_state(m, accumulation_steps=3)
    ds_t, _ = TT.build_device_dataset(data_t, torch.device("cpu"))
    rng_t = random.Random(11)
    results_t = []
    for _ in range(2):
        st, loss = TT.train_epoch_ds(st, ds_t, pool, rng_t, micro_batch=2)
        n_steps = int(st.optimizer.state[st.params[0]]["step"])
        acc = dict(st.model.state_dict())
        acc.update({n: a for (n, _), a in zip(st.model.named_parameters(),
                                               st.acc)})
        results_t.append((loss, st.mini_step, n_steps,
                          _variables(st.model.state_dict()),
                          _leaves(state_dict_to_flax(acc, np.float64)[0])))
    with _jax_f64(monkeypatch):
        fm = FlaxNBP(width=8, dtype=jnp.float64)
        v64 = _to64(flax_vars)
        opt = JT.make_optimizer(accumulation_steps=3)
        js = JT.TrainState(variables=v64, opt_state=opt.init(v64["params"]),
                           optimizer=opt, lr=1e-3)
        ds_j, _ = JT.build_device_dataset(data_j)
        rng_j = random.Random(11)
        results_j = []
        for _ in range(2):
            js, loss = JT.train_epoch_ds(fm, js, ds_j, pool, rng_j,
                                         micro_batch=2)
            results_j.append((loss, int(js.opt_state.mini_step),
                              int(js.opt_state.gradient_step),
                              _leaves(jax.tree_util.tree_map(
                                  np.asarray, js.variables)),
                              _leaves(jax.tree_util.tree_map(
                                  np.asarray, js.opt_state.acc_grads))))
    assert [r[1:3] for r in results_t] == [(1, 1), (2, 2)]
    for (l_t, mini_t, n_t, vars_t, acc_t), (l_j, mini_j, n_j, vars_j, acc_j) \
            in zip(results_t, results_j):
        np.testing.assert_allclose(l_t, l_j, rtol=1e-6)
        assert (mini_t, n_t) == (mini_j, n_j)
        assert set(vars_t) == set(vars_j) and set(acc_t) == set(acc_j)
        for k, want in vars_j.items():
            np.testing.assert_allclose(vars_t[k], want, rtol=1e-4,
                                       atol=1e-10, err_msg=k)
        top = max(np.abs(v).max() for v in acc_j.values())
        for k, want in acc_j.items():
            np.testing.assert_allclose(acc_t[k], want, rtol=1e-4,
                                       atol=1e-10 * top, err_msg=k)


# -- host bookkeeping --------------------------------------------------------

def _scheduler_trace(mod, metrics):
    sched = mod.PlateauScheduler()
    lr, lrs = 1e-3, []
    for m in metrics:
        lr = sched.step(m, lr)
        lrs.append(lr)
    stop = mod.EarlyStopping(patience=3, min_delta=0.2)
    return lrs, [stop(m) for m in metrics]


def _chunks(mod, pool, micro, seed):
    rng = None if seed is None else random.Random(seed)
    return [(np.asarray(i).tolist(), np.asarray(s).tolist())
            for i, s in mod._micro_chunks(pool, micro, rng=rng)]


@pytest.mark.parametrize("case", ["schedulers", "micro_chunks",
                                  "read_combined", "extract_validation",
                                  "epoch_pool"])
def test_host_bookkeeping_matches(case):
    if case == "schedulers":
        metrics = [5.0, 4.0, 4.1, 4.2, 4.3, 3.9, 4.0, 4.0, 4.0, 4.0, 3.0,
                   3.5, 3.5, 3.5, 3.5, 3.5]
        assert _scheduler_trace(TT, metrics) == _scheduler_trace(JT, metrics)
        assert min(_scheduler_trace(TT, metrics)[0]) == 1e-4
        return
    if case == "micro_chunks":
        for pool, micro, seed in (([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5], 4, 7),
                                  ([3, 1, 4, 1, 5], 8, 2),
                                  (list(range(6)), 3, None),
                                  ([], 2, None), ([7], 4, None)):
            assert _chunks(TT, pool, micro, seed) == _chunks(JT, pool, micro,
                                                             seed)
        return
    exps = _experiences(23, 9, JExperience)
    if case == "epoch_pool":
        for epoch in (1, 2, 5):
            assert TT._epoch_pool(exps, epoch) == JT._epoch_pool(exps, epoch)
        return
    tdb, jdb = ReplayDB(), JReplayDB()
    for e in exps:
        tdb.append(e.model_input, e.gt_layout, e.pixels, e.gains, e.pose_i)
        jdb.append(e.model_input, e.gt_layout, e.pixels, e.gains, e.pose_i)
    ident = {id(e.model_input): i for i, e in enumerate(tdb.entries)}
    jident = {id(e.model_input): i for i, e in enumerate(jdb.entries)}
    if case == "read_combined":
        for last_n, k, seed in ((5, 4, 0), (10, 100, 3), (30, 4, 1)):
            got = tdb.read_combined(last_n, k, random.Random(seed))
            want = jdb.read_combined(last_n, k, random.Random(seed))
            assert ([ident[id(e.model_input)] for e in got]
                    == [jident[id(e.model_input)] for e in want])
        return
    for num in (5, 1200):
        t2, j2 = ReplayDB(), JReplayDB()
        t2.entries, j2.entries = list(tdb.entries), list(jdb.entries)
        got, want = t2.extract_validation(num), j2.extract_validation(num)
        assert ([ident[id(e.model_input)] for e in got]
                == [jident[id(e.model_input)] for e in want])
        assert ([ident[id(e.model_input)] for e in t2.entries]
                == [jident[id(e.model_input)] for e in j2.entries])


def test_build_device_dataset_matches():
    exps = _experiences(5, 2, JExperience)
    exps[1].pixels = np.zeros((140, 3), np.int32)  # past MAX_PIXELS
    exps[1].gains = np.ones(140, np.float32)
    ds_j, n_j = JT.build_device_dataset(exps)
    ds_t, n_t = TT.build_device_dataset(
        [Experience(**vars(e)) for e in exps], torch.device("cpu"))
    assert n_t == n_j == 5
    for k, v in ds_t.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(ds_j[k])[:n_j],
                                      err_msg=k)


# -- replay files, both ways ------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "jax"])
def test_replay_npz_reads_across(tmp_path, writer):
    exps = _experiences(4, 5, JExperience)
    w_cls, r_cls = (ReplayDB, JReplayDB) if writer == "port" else (JReplayDB,
                                                                   ReplayDB)
    db = w_cls(str(tmp_path / "replay.npz"))
    for e in exps:
        db.append(e.model_input, e.gt_layout, e.pixels, e.gains, e.pose_i)
    db.save()
    db.save_epoch(str(tmp_path / "db"), 3, start=1)
    back = r_cls(str(tmp_path / "replay.npz"))
    shards = r_cls()
    assert shards.load_dir(str(tmp_path / "db")) == 3
    assert shards.load_dir(str(tmp_path / "db"), max_epoch=2) == 0
    for got, want in ((back.entries, exps), (shards.entries, exps[1:])):
        assert len(got) == len(want)
        for g, e in zip(got, want):
            assert g.model_input.dtype == np.float16
            assert g.gt_layout.dtype == np.uint8 and g.pose_i == e.pose_i
            np.testing.assert_array_equal(g.model_input, e.model_input)
            np.testing.assert_array_equal(g.gt_layout, e.gt_layout)
            np.testing.assert_array_equal(g.pixels, e.pixels)
            np.testing.assert_array_equal(g.gains, e.gains)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_replay_native_reads_across(tmp_path, writer):
    """A native record store written by either package reads back equal in
    the other, at a model input other than 256x256; a second save appends
    only the new entries; nothing under native/ is written."""
    from nextbestpath_tpu_torch.train import replay_native as RN

    assert RN.native_available()
    native = os.path.dirname(RN.TRACKED_LIB)
    before = {n: os.path.getmtime(os.path.join(native, n))
              for n in os.listdir(native)}
    exps = _experiences(5, 6, JExperience)
    w_cls, r_cls = (ReplayDB, JReplayDB) if writer == "port" else (JReplayDB,
                                                                   ReplayDB)
    path = str(tmp_path / "store" / "replay.bin")
    db = w_cls()
    for e in exps[:3]:
        db.append(e.model_input, e.gt_layout, e.pixels, e.gains, e.pose_i)
    db.save_native(path)
    for e in exps[3:]:
        db.append(e.model_input, e.gt_layout, e.pixels, e.gains, e.pose_i)
    db.save_native(path)
    back = r_cls()
    assert back.load_native(path) == len(exps)
    for g, e in zip(back.entries, exps):
        assert g.model_input.dtype == np.float16 and g.pose_i == e.pose_i
        np.testing.assert_array_equal(g.model_input, e.model_input)
        np.testing.assert_array_equal(g.gt_layout, e.gt_layout)
        np.testing.assert_array_equal(g.pixels, e.pixels)
        np.testing.assert_array_equal(g.gains, e.gains)
    assert before == {n: os.path.getmtime(os.path.join(native, n))
                      for n in os.listdir(native)}


# -- the step's numerics guard ------------------------------------------------

def test_train_step_runs_in_f32_and_restores_flags(flax_vars):
    """The forward, the backward and the optimizer step run with cuDNN's
    TF32 off; the caller's flag is back after the step; the parameters move
    only on the k-th micro step, the running statistics on every one."""
    m = _torch_model(flax_vars)
    st = TT.init_train_state(m, accumulation_steps=2)
    ds, _ = TT.build_device_dataset(_experiences(4, 1, Experience),
                                    torch.device("cpu"))
    seen = []
    m.final2.register_forward_hook(
        lambda *a: seen.append(("fwd", torch.backends.cudnn.allow_tf32)))
    m.conv_blocks[0].conv0.weight.register_hook(
        lambda g: seen.append(("bwd", torch.backends.cudnn.allow_tf32)))
    st.optimizer.register_step_pre_hook(
        lambda *a: seen.append(("opt", torch.backends.cudnn.allow_tf32)))
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        w0 = m.final1.weight.detach().clone()
        rm0 = m.conv_blocks[0].bn0.running_mean.clone()
        idx, sw = torch.tensor([0, 1]), torch.ones(2)
        TT._train_step_ds(st, ds, idx, sw)
        assert torch.backends.cudnn.allow_tf32 is True
        assert torch.equal(m.final1.weight, w0) and st.mini_step == 1
        assert not torch.equal(m.conv_blocks[0].bn0.running_mean, rm0)
        TT._train_step_ds(st, ds, idx + 2, sw)
        assert torch.backends.cudnn.allow_tf32 is True
        assert not torch.equal(m.final1.weight, w0) and st.mini_step == 0
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert [s for s, _ in seen] == ["fwd", "bwd", "fwd", "bwd", "opt"]
    assert not any(flag for _, flag in seen)
