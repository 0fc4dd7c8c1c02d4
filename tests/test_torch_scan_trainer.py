"""The port's scan trainer and what it brought, against the JAX package:
``BatchedScanRollout`` (held-out evaluation), the optimizer state in the
JAX checkpoint layout, the bf16 training step and
``train/driver.py::run_training_nbp_scan`` with ``train_nbp_torch.py
--scan``.

Tolerances, and why:

* ``BatchedScanRollout`` on two padded scenes (``TINY``, 6 poses) with the
  JAX key schedule: coverage within 1e-3 and the same trajectories as the
  JAX batched rollout; equal to single-scene port rollouts on the padded
  arrays: coverage and cam positions bit for bit (they follow from the
  decisions; the U-Net at batch 2 may differ from batch 1 in the last bit);
* the optimizer state, JAX -> port after 3 micro steps, then 4 more on each
  side: rtol 1e-4 in f64 (``test_torch_train.py``'s AdamW test, for its
  reason); port -> JAX through a checkpoint file: leaf for leaf equal;
* the bf16 micro step: the loss within 1e-2 relative of JAX's bf16 loss
  (both round every convolution's input and output to bf16), and the bf16
  gradient no farther (L2 over the tree) from the f64 gradient than
  ``BF16_TREE`` times JAX's bf16 gradient is;
* the driver: files, log keys, resume bookkeeping exactly; its ``slow``
  twin against the JAX driver (f32 on both sides, so that the Boltzmann
  picks agree): the loss log within 1e-3.
"""

import importlib
import json
import os
import random
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from nextbestpath_tpu.assets import generate_scene, pack_generated_scene
from nextbestpath_tpu.assets.scene_assets import \
    pad_assets_to_common as j_pad_common
from nextbestpath_tpu.config import default_params
from nextbestpath_tpu.eval.scan_rollout import \
    BatchedScanRollout as JBatched
from nextbestpath_tpu.models import NBP as FlaxNBP
from nextbestpath_tpu.train.replay import Experience as JExperience
from nextbestpath_tpu.utils.checkpoint import load_checkpoint as j_load
from nextbestpath_tpu.utils.checkpoint import save_checkpoint as j_save
from nextbestpath_tpu_torch import assets as TA
from nextbestpath_tpu_torch import config as TC
from nextbestpath_tpu_torch.eval.scan_rollout import (BatchedScanRollout,
                                                      ScanRollout)
from nextbestpath_tpu_torch.models import unet as U
from nextbestpath_tpu_torch.models.fold import fold_bn
from nextbestpath_tpu_torch.models.convert import (flax_to_state_dict,
                                                   state_dict_to_flax)
from nextbestpath_tpu_torch.train import train_nbp as TT
from nextbestpath_tpu_torch.train.driver import (run_training_nbp_scan,
                                                 seeded_train_model)
from nextbestpath_tpu_torch.train.replay import Experience
from nextbestpath_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                     save_checkpoint,
                                                     save_nbp)

from test_torch_rollout import JaxDraws, _flax_model
from test_torch_scan_collection import PAIR_NORMAL_GT, TINY, JaxCollectDraws
from test_torch_train import (S, _batch, _experiences, _j_loss_fn, _jax_f64,
                              _leaves, _t_step, _to64)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import train_nbp_torch as cli  # noqa: E402

JD = importlib.import_module("nextbestpath_tpu.train.driver")
JT = importlib.import_module("nextbestpath_tpu.train.train_nbp")

COV_ATOL = 1e-3
BF16_TREE = 2.0


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the tier-1 run puts several test processes on
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flax_model():
    return _flax_model()


@pytest.fixture(scope="module")
def flax_vars():
    fm = FlaxNBP(width=8)
    v = fm.init(jax.random.PRNGKey(1), jnp.zeros((1, S, S, 5)), train=True)
    return jax.tree_util.tree_map(np.asarray, v)


def _port_nbp(variables, **kw):
    m = U.NBP(**kw)
    m.load_state_dict(flax_to_state_dict(variables["params"],
                                         variables["batch_stats"]))
    return m


def _eval_pair(pkg, cfg):
    """simple/5 and normal/3 (PAIR_NORMAL_GT GT points), lattice-padded."""
    simple = pkg.pack_generated_scene(pkg.generate_scene("simple", seed=5),
                                      params=cfg.default_params(**TINY))
    normal = pkg.pack_generated_scene(
        pkg.generate_scene("normal", seed=3),
        params=cfg.default_params(**dict(TINY,
                                         n_gt_surface_points=PAIR_NORMAL_GT)))
    return [simple, normal]


# -- BatchedScanRollout ------------------------------------------------------

def test_batched_rollout_matches_jax_and_single_scenes(flax_model):
    model, variables = flax_model
    j_assets = j_pad_common(_eval_pair(
        __import__("nextbestpath_tpu.assets", fromlist=["x"]),
        __import__("nextbestpath_tpu.config", fromlist=["x"])))
    want = JBatched(j_assets, model, variables,
                    params=default_params(**TINY)).run(n_poses=6, seed=8)
    t_assets = TA.pad_assets_to_common(_eval_pair(TA, TC))
    assert len(t_assets[0].gt_surface) != len(t_assets[1].gt_surface)
    params = TC.default_params(**TINY)
    batched = BatchedScanRollout(t_assets, _port_nbp(variables),
                                 params=params, make_draws=JaxDraws,
                                 device="cpu")
    got = batched.run(n_poses=6, seed=8)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.coverage_evolution,
                                   w.coverage_evolution, atol=COV_ATOL)
        assert g.n_points == w.n_points
        np.testing.assert_allclose(g.cam_positions, w.cam_positions,
                                   atol=1e-4)
        assert g.auc == pytest.approx(w.auc, abs=COV_ATOL)
    assert max(got[1].coverage_evolution[1:]) > got[1].coverage_evolution[0]
    assert not batched.scene.gt_valid.all()  # scene 1 is padded
    for i, (a, scene) in enumerate(zip(t_assets, batched.scenes)):
        solo = ScanRollout(a, _port_nbp(variables), params=params,
                           scene=scene, draws=JaxDraws(8 + i),
                           device="cpu").run(n_poses=6)
        assert solo.coverage_evolution == got[i].coverage_evolution
        np.testing.assert_array_equal(solo.cam_positions,
                                      got[i].cam_positions)


def test_batched_rollout_takes_new_weights(flax_model):
    """run(variables=new) after a run with the old weights equals a fresh
    rollout built with the new ones; the weights are copied into the same
    tensors (a captured graph reads them), and the caller's model is not
    touched."""
    _, variables = flax_model
    t_assets = TA.pad_assets_to_common(_eval_pair(TA, TC))
    params = TC.default_params(**TINY)
    old = _port_nbp(variables)
    torch.manual_seed(3)
    new = U.NBP()
    with torch.no_grad():
        new.final2.bias.fill_(-4.0)
    before = {k: v.clone() for k, v in new.state_dict().items()}
    batched = BatchedScanRollout(t_assets, old, params=params,
                                 make_draws=JaxDraws, device="cpu")
    first = batched.run(n_poses=4, seed=8)
    ptrs = [t.data_ptr() for t in batched.model.parameters()]
    got = batched.run(n_poses=4, seed=8, variables=new)
    assert ptrs == [t.data_ptr() for t in batched.model.parameters()]
    fresh = BatchedScanRollout(t_assets, new, params=params,
                               make_draws=JaxDraws, device="cpu").run(
                                   n_poses=4, seed=8)
    for g, f in zip(got, fresh):
        assert g.coverage_evolution == f.coverage_evolution
        np.testing.assert_array_equal(g.cam_positions, f.cam_positions)
    assert len(first) == 2
    held = dict(batched.model.named_parameters())
    for k, v in fold_bn(new).named_parameters():
        assert torch.equal(held[k], v), k
    assert not torch.equal(held["final1.weight"],
                           fold_bn(old).final1.weight)
    assert all(torch.equal(v, new.state_dict()[k]) for k, v in before.items())


# -- the optimizer state in the JAX layout ------------------------------------

def _ds_j(data):
    return JT.build_device_dataset(data)[0]


def _chunks(n_steps, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 7, 2), np.array([1.0, 1.0 if k % 3 else 0.0],
                                             np.float32))
            for k in range(n_steps)]


def test_opt_state_from_jax_continues_as_jax(flax_vars, monkeypatch,
                                             tmp_path):
    """optax.MultiSteps(adamw) every 2 micro steps, in f64: 3 JAX micro
    steps (one emitted step, one pending gradient), saved by the JAX
    package's save_checkpoint and resumed in the port; then 4 more micro
    steps on each side: parameters, batch_stats, the pending mean and the
    Adam moments within rtol 1e-4, the counts equal."""
    data_j = _experiences(7, 4, JExperience)
    chunks = _chunks(7, 0)
    with _jax_f64(monkeypatch):
        fm = FlaxNBP(width=8, dtype=jnp.float64)
        opt = JT.make_optimizer(accumulation_steps=2)
        v, o = _to64(flax_vars), None
        o = opt.init(v["params"])
        ds = _ds_j(data_j)
        for k, (idx, sw) in enumerate(chunks):
            if k == 3:
                path = str(tmp_path / "jax_latest.ckpt")
                j_save(path, v, opt_state=o, epoch=4, extra={"lr": 1e-3})
            v, o, _ = JT._train_step_ds(fm, opt, v, o, ds, jnp.asarray(idx),
                                        jnp.asarray(sw))
        want_vars = _leaves(jax.tree_util.tree_map(np.asarray, v))
        want_opt = serialization.to_state_dict(o)
    assert int(want_opt["gradient_step"]) == 3
    variables, opt_tree, epoch, _ = load_checkpoint(path)
    assert epoch == 4 and int(opt_tree["mini_step"]) == 1
    m = U.as_float64(U.NBP(width=8))
    m.load_state_dict(flax_to_state_dict(variables["params"],
                                         variables["batch_stats"],
                                         dtype=np.float64))
    state = TT.init_train_state(m, accumulation_steps=2)
    TT.opt_state_from_flax(opt_tree, state)
    assert state.mini_step == 1 and state.lr == pytest.approx(1e-3)
    ds_t, _ = TT.build_device_dataset([Experience(**vars(e)) for e in data_j],
                                      torch.device("cpu"))
    for idx, sw in chunks[3:]:
        TT._train_step_ds(state, ds_t, torch.from_numpy(idx).long(),
                          torch.from_numpy(sw))
    got_opt = TT.opt_state_to_flax(state, dtype=np.float64)
    got_vars = _leaves(dict(zip(("params", "batch_stats"),
                                state_dict_to_flax(m.state_dict(),
                                                   np.float64))))
    for k, w in want_vars.items():
        np.testing.assert_allclose(got_vars[k], w, rtol=1e-4, atol=1e-10,
                                   err_msg=k)
    for name in ("mini_step", "gradient_step"):
        assert int(got_opt[name]) == int(want_opt[name])
    g_in, w_in = got_opt["inner_opt_state"], want_opt["inner_opt_state"]
    assert int(g_in["count"]) == int(w_in["count"]) == 3
    for part in ("mu", "nu"):
        g = _leaves(g_in["inner_state"]["0"][part])
        w = _leaves(w_in["inner_state"]["0"][part])
        top = max(np.abs(x).max() for x in w.values())
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4,
                                       atol=1e-10 * top, err_msg=part + k)
    g, w = _leaves(got_opt["acc_grads"]), _leaves(want_opt["acc_grads"])
    top = max(np.abs(x).max() for x in w.values())
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-10 * top)


def test_port_latest_checkpoint_loads_in_jax(flax_vars, tmp_path):
    """A port state after 3 micro steps (k = 2) saved as a resume
    checkpoint: JAX's load_checkpoint with its templates restores every
    leaf equal to the port's, and the JAX optimizer takes a step from it."""
    m = _port_nbp(flax_vars, width=8)
    state = TT.init_train_state(m, accumulation_steps=2)
    TT.set_lr(state, 3e-4)
    data = [Experience(**vars(e)) for e in _experiences(7, 4, Experience)]
    ds, _ = TT.build_device_dataset(data, torch.device("cpu"))
    for idx, sw in _chunks(3, 1):
        TT._train_step_ds(state, ds, torch.from_numpy(idx).long(),
                          torch.from_numpy(sw))
    p, s = state_dict_to_flax(m.state_dict())
    path = str(tmp_path / "nbp_latest.ckpt")
    save_checkpoint(path, {"params": p, "batch_stats": s},
                    opt_state=TT.opt_state_to_flax(state), epoch=2,
                    extra={"lr": state.lr})
    opt = JT.make_optimizer(lr=1e-3, accumulation_steps=2)
    tmpl = opt.init(flax_vars["params"])
    variables, o, epoch, extra = j_load(path, flax_vars, tmpl)
    assert epoch == 2 and extra["lr"] == 3e-4
    want = TT.opt_state_to_flax(state)
    got = serialization.to_state_dict(o)
    gl, wl = _leaves(got), _leaves(want)
    assert set(gl) == set(wl)
    for k, w in wl.items():
        assert gl[k].dtype == np.asarray(w).dtype, k
        np.testing.assert_array_equal(gl[k], w, err_msg=k)
    assert int(o.gradient_step) == 1 and int(o.mini_step) == 1
    assert float(o.inner_opt_state.hyperparams["learning_rate"]) == \
        np.float32(3e-4)
    hyper = serialization.to_state_dict(tmpl)["inner_opt_state"]["hyperparams"]
    for k in ("b1", "b2", "eps", "eps_root", "weight_decay"):
        assert float(got["inner_opt_state"]["hyperparams"][k]) == \
            float(hyper[k]), k
    _, o2 = opt.update(jax.tree_util.tree_map(jnp.ones_like, variables[
        "params"]), o, variables["params"])
    assert int(o2.gradient_step) == 2


def test_bf16_step_matches_jax_bf16(flax_vars, monkeypatch):
    """One micro step of 4 of NBP(width=8, bf16) against the flax bf16 one
    (module docstring for the tolerances)."""
    b = _batch(1)
    fm16 = FlaxNBP(width=8, dtype=jnp.bfloat16)
    (loss_j, _), g_j = jax.jit(jax.value_and_grad(
        _j_loss_fn(fm16, flax_vars, b), has_aux=True))(flax_vars["params"])
    g_j = _leaves(g_j)
    with _jax_f64(monkeypatch):
        v64 = _to64(flax_vars)
        b64 = {k: (v.astype(np.float64) if v.dtype == np.float32 else v)
               for k, v in b.items()}
        g = jax.jit(jax.grad(lambda p: _j_loss_fn(
            FlaxNBP(width=8, dtype=jnp.float64), v64, b64)(p)[0]))(
                v64["params"])
        g_64 = _leaves(g)
    m = _port_nbp(flax_vars, width=8, dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in m.parameters())
    loss_t, _, _, g_t, _ = _t_step(m, b, torch.float32)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-2)
    g_t = _leaves(g_t)
    err_t = np.sqrt(sum(np.linalg.norm(g_t[k] - r) ** 2
                        for k, r in g_64.items()))
    err_j = np.sqrt(sum(np.linalg.norm(g_j[k] - r) ** 2
                        for k, r in g_64.items()))
    assert err_t <= BF16_TREE * err_j, (err_t, err_j)
    # The bf16 step through the trainer: f32 parameters, accumulator and
    # Adam moments, a finite loss, one emitted step.
    state = TT.init_train_state(m, accumulation_steps=2)
    data = [Experience(**vars(e)) for e in _experiences(4, 2, Experience)]
    ds, _ = TT.build_device_dataset(data, torch.device("cpu"))
    _, loss = TT.train_epoch_ds(state, ds, [0, 1, 2, 3], random.Random(0),
                                micro_batch=2)
    assert np.isfinite(loss) and state.optimizer.state
    assert all(a.dtype == torch.float32 for a in state.acc)
    assert all(s["exp_avg"].dtype == torch.float32
               for s in state.optimizer.state.values())
    assert np.isfinite(TT.validate(state, data, 2))


# -- the driver and the CLI ------------------------------------------------------

def _driver_scenes():
    params = TC.default_params(**TINY)
    scenes = TA.pad_assets_to_common([
        TA.pack_generated_scene(TA.generate_scene(d, seed=s), params=params)
        for d, s in (("simple", 2), ("normal", 3))])
    evals = [TA.pack_generated_scene(TA.generate_scene("simple", seed=508),
                                     params=params)]
    return params, scenes, evals


def _drive(tmp, scenes, evals, params, epochs, **kw):
    return run_training_nbp_scan(
        scenes, eval_scenes=evals, params=params, epochs=epochs, n_poses=6,
        db_dir=str(tmp / "db"), weights_dir=str(tmp / "w"),
        log_dir=str(tmp / "log"), seed=3, verbose=False, eval_every=2,
        eval_poses=4, device="cpu",
        model=seeded_train_model(3, width=8, dtype=torch.bfloat16), **kw)


def test_scan_driver_runs_and_resumes(tmp_path):
    params, scenes, evals = _driver_scenes()
    state = _drive(tmp_path, scenes, evals, params, 3)
    assert sorted(os.listdir(tmp_path / "w")) == [
        "nbp_best_auc.ckpt", "nbp_best_val.ckpt", "nbp_latest.ckpt"]
    assert sorted(os.listdir(tmp_path / "db")) == [
        "epoch_0000.npz", "epoch_0001.npz", "epoch_0002.npz",
        "validation.npz"]
    log = json.loads((tmp_path / "log" / "nbp_loss.json").read_text())
    assert set(log) == {"train", "val", "coverage_after_trajectory",
                        "eval_auc", "gain_stats"}
    assert len(log["coverage_after_trajectory"]) == 6
    assert len(log["train"]) == 2 and [e["epoch"] for e in log["eval_auc"]] \
        == [2]
    assert set(log["eval_auc"][0]["auc"]) == {evals[0].name}
    steps = int(state.optimizer.state[state.params[0]]["step"])
    assert steps >= 1
    variables, opt_tree, epoch, extra = load_checkpoint(
        str(tmp_path / "w" / "nbp_latest.ckpt"))
    assert epoch == 2 and int(opt_tree["gradient_step"]) == steps
    assert set(extra) == {"lr", "best_val", "best_auc"}

    # The LR clamp: a checkpoint LR of 1e-6 resumes at 1e-4 (epochs=3:
    # nothing more to run), with the optimizer's step count.
    latest = tmp_path / "w" / "nbp_latest.ckpt"
    saved = latest.read_bytes()
    save_checkpoint(str(latest), variables, opt_state=opt_tree, epoch=2,
                    extra=dict(extra, lr=1e-6))
    st = _drive(tmp_path, scenes, evals, params, 3, resume=True)
    assert st.lr == 1e-4 and st.optimizer.param_groups[0]["lr"] == 1e-4
    assert int(st.optimizer.state[st.params[0]]["step"]) == steps
    latest.write_bytes(saved)

    # Resume to epoch 4: a stale shard of epoch 3 is deleted first, the
    # step count carries on, the log is merged.
    shutil.copy(tmp_path / "db" / "epoch_0002.npz",
                tmp_path / "db" / "epoch_0007.npz")
    st = _drive(tmp_path, scenes, evals, params, 4, resume=True)
    assert not (tmp_path / "db" / "epoch_0007.npz").exists()
    assert (tmp_path / "db" / "epoch_0003.npz").exists()
    assert int(st.optimizer.state[st.params[0]]["step"]) > steps
    log = json.loads((tmp_path / "log" / "nbp_loss.json").read_text())
    assert len(log["coverage_after_trajectory"]) == 8 and len(log["train"]) \
        == 3
    assert load_checkpoint(str(latest))[2] == 3


def test_scan_driver_refuses_a_bad_resume(tmp_path):
    params, scenes, evals = _driver_scenes()
    _drive(tmp_path, scenes, evals[:0], params, 1)
    with pytest.raises(ValueError, match="needs db_dir"):
        run_training_nbp_scan(
            scenes, params=params, epochs=2, n_poses=6, db_dir=None,
            weights_dir=str(tmp_path / "w"), log_dir=str(tmp_path / "log"),
            verbose=False, resume=True, device="cpu",
            model=seeded_train_model(3, width=8))
    (tmp_path / "db" / "validation.npz").unlink()
    with pytest.raises(ValueError, match="validation split"):
        _drive(tmp_path, scenes, evals[:0], params, 2, resume=True)
    latest = tmp_path / "w" / "nbp_latest.ckpt"
    variables, _, _, _ = load_checkpoint(str(latest))
    save_checkpoint(str(latest), variables, epoch=0)  # variables only
    with pytest.raises(ValueError, match="no optimizer state"):
        _drive(tmp_path, scenes, evals[:0], params, 2, resume=True)


def test_scan_driver_warm_start(tmp_path):
    """init_from seeds a fresh run's variables (not its optimizer) from a
    checkpoint the test writes; a missing path is ignored."""
    params, scenes, _ = _driver_scenes()
    src = seeded_train_model(11, width=8)
    path = str(tmp_path / "warm.ckpt")
    save_nbp(path, src, epoch=5)
    kw = dict(params=params, epochs=0, n_poses=6, verbose=False,
              device="cpu", weights_dir=str(tmp_path / "w"),
              log_dir=str(tmp_path / "log"))
    st = run_training_nbp_scan(scenes, init_from=path,
                               model=seeded_train_model(3, width=8), **kw)
    assert all(torch.equal(v, src.state_dict()[k])
               for k, v in st.model.state_dict().items())
    assert not st.optimizer.state
    st = run_training_nbp_scan(scenes, init_from=str(tmp_path / "none"),
                               model=seeded_train_model(3, width=8), **kw)
    assert not torch.equal(st.model.final1.weight, src.final1.weight)


def test_cli_scan_on_cpu(tmp_path, capsys):
    args = ["--scan", "--device", "cpu", "--quick", "--procgen", "simple:2",
            "--eval-procgen", "simple", "--epochs", "2", "--poses", "6",
            "--eval-every", "1", "--eval-poses", "3", "--tag", "t",
            "--db-dir", str(tmp_path / "db"), "--weights-dir",
            str(tmp_path / "w"), "--log-dir", str(tmp_path / "log")]
    assert cli.main(args) == 0
    out = capsys.readouterr().out
    assert "=== epoch 1 ===" in out and "eval AUC" in out
    assert (tmp_path / "w" / "t_latest.ckpt").exists()
    assert (tmp_path / "log" / "t_loss.json").exists()
    assert cli.main(args + ["--resume", "--epochs", "3"]) == 0
    assert "resumed from" in capsys.readouterr().out


@pytest.mark.slow
def test_scan_driver_matches_jax_driver(tmp_path, monkeypatch):
    """Two epochs of the JAX driver and the port's at TINY (two padded
    scenes, one eval scene evaluated at epoch 1) from the same initial
    weights, both f32, with the JAX key schedules injected: the loss log
    within 1e-3."""
    params_j = default_params(**TINY)
    j_scenes = j_pad_common([
        pack_generated_scene(generate_scene(d, seed=s), params=params_j)
        for d, s in (("simple", 2), ("normal", 3))])
    j_evals = [pack_generated_scene(generate_scene("simple", seed=508),
                                    params=params_j)]
    monkeypatch.setattr(JD, "NBP", lambda dtype=None: FlaxNBP())
    kw = dict(epochs=2, n_poses=6, seed=3, verbose=False, eval_every=1,
              eval_poses=4)
    JD.run_training_nbp_scan(j_scenes, eval_scenes=j_evals, params=params_j,
                             db_dir=str(tmp_path / "jdb"),
                             weights_dir=str(tmp_path / "jw"),
                             log_dir=str(tmp_path / "jlog"), **kw)
    want = json.loads((tmp_path / "jlog" / "nbp_loss.json").read_text())
    init = JT.init_train_state(FlaxNBP(), jax.random.PRNGKey(3))
    v0 = jax.tree_util.tree_map(np.asarray, init.variables)
    params, scenes, evals = _driver_scenes()
    run_training_nbp_scan(scenes, eval_scenes=evals, params=params,
                          db_dir=str(tmp_path / "db"),
                          weights_dir=str(tmp_path / "w"),
                          log_dir=str(tmp_path / "log"), device="cpu",
                          model=_port_nbp(v0), make_draws=JaxCollectDraws,
                          make_eval_draws=JaxDraws, **kw)
    got = json.loads((tmp_path / "log" / "nbp_loss.json").read_text())
    assert set(got) == set(want)
    for k in ("train", "val", "coverage_after_trajectory"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-3,
                                   err_msg=k)
    assert got["gain_stats"] == want["gain_stats"]
    assert [e["epoch"] for e in got["eval_auc"]] == [1]
    np.testing.assert_allclose(got["eval_auc"][0]["mean"],
                               want["eval_auc"][0]["mean"], atol=1e-3)
