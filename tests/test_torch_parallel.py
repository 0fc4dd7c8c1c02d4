"""The port's data-parallel layer (``nextbestpath_tpu_torch/parallel/``,
``assets/dataset.py``, the grouped ``BatchNorm`` and
``train/driver.py::run_training_nbp_dp``) against one process and against
the JAX package's mesh programs.

The port's ranks are gloo processes on the CPU, started by
``parallel/launch.py::spawn`` with one intra-op thread each and a deadline,
so that a hang fails its test rather than the suite; their bodies are
package functions (``parallel/dryrun.py``), since spawn imports them by
module path. The JAX side runs in this process on ``make_mesh(n)`` over the
8 virtual CPU devices of ``tests/conftest.py``. Inputs come from numpy
seeds.

Tolerances, and why:

* host helpers (SLURM names, dataset shards, the block split): equal;
* BatchNorm over 2 and 4 ranks' blocks of an f64 batch against one
  process's BatchNorm and flax's on the whole batch: 1e-10 (f64; the two
  variance formulas differ in rounding only), flax's running statistics
  within rtol 2e-7 (flax keeps them in f32);
* W ranks against one process in f64 (``dp_grad_parity``, a ragged tail
  whose last rank holds only zero-weighted rows; ``train_nbp_dp`` against
  ``train_nbp``): rtol 1e-8; the parameters are the same bits on every
  rank;
* ``train_nbp_dp`` against the JAX ``train_nbp_dp`` on ``make_mesh(2)`` and
  ``make_mesh(3)``, in f64 on both sides as ``tests/test_torch_train.py``
  holds the optimizer (the f32 gradient is ill-conditioned): the losses
  within rtol 1e-6 and the parameters within rtol 1e-4, that file's
  tolerances;
* the sharded rollout and collection against single runs of the same
  padded scenes: bit for bit (the same code on each rank);
* ``run_training_nbp_dp`` on 2 ranks against 1 rank, f32: the replay store
  equal entry for entry (both epochs collect with the initial weights),
  the loss log within rtol 1e-4 (one epoch's training, its micro steps at
  the initial weights until the first AdamW step).

The JAX sharded classes against the port's, at ``TINY`` with the JAX key
schedules, are ``slow``, as their JAX twins in ``tests/test_multichip.py``
are.
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextbestpath_tpu.assets.dataset import SceneDataset as JSceneDataset
from nextbestpath_tpu.models import NBP as FlaxNBP
from nextbestpath_tpu.parallel import multihost as JMH
from nextbestpath_tpu.parallel.dp import train_nbp_dp as j_train_nbp_dp
from nextbestpath_tpu.parallel.mesh import batch_sharding, make_mesh
from nextbestpath_tpu.train.replay import Experience as JExperience
from nextbestpath_tpu.train.replay import ReplayDB as JReplayDB
from nextbestpath_tpu_torch.assets.dataset import SceneDataset
from nextbestpath_tpu_torch.models.convert import (flax_to_state_dict,
                                                   state_dict_to_flax)
from nextbestpath_tpu_torch.models.unet import NBP, BatchNorm, as_float64
from nextbestpath_tpu_torch.parallel import dryrun as DR
from nextbestpath_tpu_torch.parallel import multihost as TMH
from nextbestpath_tpu_torch.parallel.dp import dp_grad_parity
from nextbestpath_tpu_torch.parallel.launch import spawn
from nextbestpath_tpu_torch.parallel.mesh import Mesh, local_block
from nextbestpath_tpu_torch.train.replay import Experience
from nextbestpath_tpu_torch.utils.checkpoint import load_nbp

from test_torch_multi_scene import nbp8  # noqa: F401  (a fixture)
from test_torch_train import _jax_f64, _to64

JT = importlib.import_module("nextbestpath_tpu.train.train_nbp")

DEADLINE_S = 120.0
TINY = dict(image_height=32, image_width=56, points_per_frame=256,
            full_pc_capacity=32768, n_gt_surface_points=1024,
            max_path_len=32, pc2img_size=[64, 64], value_map_size=[16, 16])
S = 32  # the training checks' model input side


def _run(fn, n, *args, timeout_s=DEADLINE_S):
    return spawn(fn, n, device="cpu", args=args, timeout_s=timeout_s)


# -- host helpers ------------------------------------------------------------

@pytest.mark.parametrize("nodelist", ["nid[001234-001237]", "gpu7",
                                      "a[09,11-12]", "node[3]",
                                      "x01,x02"])
def test_first_slurm_host_matches(nodelist):
    assert TMH._first_slurm_host(nodelist) == JMH._first_slurm_host(nodelist)


@pytest.mark.parametrize("count", [1, 2, 3])
def test_shard_for_process_matches(count):
    from nextbestpath_tpu.config import default_params as j_params
    from nextbestpath_tpu_torch.config import default_params as t_params

    names = [f"procgen_simple_{s}" for s in range(7)]
    port = SceneDataset(names, params=t_params(**TINY))
    ref = JSceneDataset(names, params=j_params(**TINY))
    for r in range(count):
        got, want = (d.shard_for_process(r, count) for d in (port, ref))
        assert got.scene_names == want.scene_names
        a, b = got[0], want[0]
        assert a.name == b.name and a.tris.tobytes() == b.tris.tobytes()
        assert a.gt_surface.tobytes() == b.gt_surface.tobytes()


_DIST_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
             "LOCAL_RANK", "SLURM_JOB_NODELIST", "SLURM_NTASKS",
             "SLURM_PROCID", "SLURM_JOB_ID", "SLURM_LOCALID",
             "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
             "JAX_PROCESS_ID")


@pytest.mark.parametrize("case", ["nothing", "address_only",
                                  "rank_out_of_range", "explicit_no_count"])
def test_maybe_initialize_distributed_refuses(monkeypatch, case):
    """No process group starts: without a coordinator both return False;
    an address without a count or rank and a rank out of range raise
    ValueError in both packages (the JAX function on the same case through
    its own variables)."""
    for k in _DIST_ENV:
        monkeypatch.delenv(k, raising=False)
    if case == "nothing":
        assert TMH.maybe_initialize_distributed(device="cpu") is False
        assert JMH.maybe_initialize_distributed() is False
        return
    if case == "address_only":
        monkeypatch.setenv("MASTER_ADDR", "localhost")
        monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:1")
        calls = [lambda: TMH.maybe_initialize_distributed(device="cpu"),
                 JMH.maybe_initialize_distributed]
    elif case == "rank_out_of_range":
        calls = [lambda: TMH.maybe_initialize_distributed(
            "localhost:1", num_processes=2, process_id=2, device="cpu"),
                 lambda: JMH.maybe_initialize_distributed(
            "localhost:1", num_processes=2, process_id=2)]
    else:
        calls = [lambda: TMH.maybe_initialize_distributed(
            "localhost:1", device="cpu"),
                 lambda: JMH.maybe_initialize_distributed("localhost:1")]
    for call in calls:
        with pytest.raises(ValueError):
            call()
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("n", [2, 4])
def test_local_block_is_the_jax_shard(n):
    """Rank r's block is device r's shard of ``P("data")``."""
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    mesh = make_mesh(n)
    shards = jax.device_put(jnp.asarray(x), batch_sharding(mesh))
    by_dev = {s.device: np.asarray(s.data) for s in shards.addressable_shards}
    for r, d in enumerate(mesh.devices.flat):
        m = Mesh(rank=r, size=n, device=torch.device("cpu"), backend="gloo")
        np.testing.assert_array_equal(
            local_block(torch.from_numpy(x), m).numpy(), by_dev[d])


# -- the launcher ------------------------------------------------------------

def test_launcher_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match=r"(?s)failed on rank 1 of 2 first"
                                           r".*rank 1 fails on purpose"):
        _run(DR.failing_rank, 2, timeout_s=60)


def test_launcher_kills_ranks_at_the_deadline():
    import time

    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="sleeping_rank"):
        _run(DR.sleeping_rank, 2, 120.0, timeout_s=5)
    assert time.monotonic() - t0 < 30


# -- BatchNorm over the global batch -------------------------------------------

def _flax_bn(x, weight, bias, dy):
    """flax BatchNorm (the JAX U-Net's: momentum 0.9, eps 1e-5) in train
    mode on the whole NCHW batch, f64: y, dx, dw, db, running stats."""
    import flax.linen as fnn

    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5, dtype=jnp.float64,
                       param_dtype=jnp.float64)
    xh = jnp.asarray(x.transpose(0, 2, 3, 1))
    dyh = jnp.asarray(dy.transpose(0, 2, 3, 1))
    variables = bn.init(jax.random.PRNGKey(0), xh)
    params = {"scale": jnp.asarray(weight), "bias": jnp.asarray(bias)}
    stats = variables["batch_stats"]

    def loss(p, xx):
        y, mut = bn.apply({"params": p, "batch_stats": stats}, xx,
                          mutable=["batch_stats"])
        return jnp.sum(y * dyh), (y, mut)

    (_, (y, mut)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                                 has_aux=True)(params, xh)
    return dict(y=np.asarray(y).transpose(0, 3, 1, 2),
                dx=np.asarray(gx).transpose(0, 3, 1, 2),
                dw=np.asarray(gp["scale"]), db=np.asarray(gp["bias"]),
                mean=np.asarray(mut["batch_stats"]["mean"]),
                var=np.asarray(mut["batch_stats"]["var"]))


@pytest.mark.parametrize("n", [2, 4])
def test_batch_norm_over_ranks_matches_whole_batch(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((8, 6, 5, 7)) * 2.0 + 0.5
    weight, bias = rng.standard_normal(6), rng.standard_normal(6)
    dy = rng.standard_normal(x.shape)
    ranks = _run(DR.bn_block_rank, n, x, weight, bias, dy)
    assert all(r["rank_mean"] == (n - 1) / 2 for r in ranks)  # reduce_mean
    got = dict(y=np.concatenate([r["y"] for r in ranks]),
               dx=np.concatenate([r["dx"] for r in ranks]))
    for k in ("dw", "db", "mean", "var"):
        for r in ranks:
            np.testing.assert_array_equal(r[k], ranks[0][k])
        got[k] = ranks[0][k]

    bn = BatchNorm(6).double().train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bn(xt)
    dx, dw, db = torch.autograd.grad((y * torch.from_numpy(dy)).sum(),
                                     [xt, bn.weight, bn.bias])
    one = dict(y=y.detach().numpy(), dx=dx.numpy(), dw=dw.numpy(),
               db=db.numpy(), mean=bn.running_mean.numpy(),
               var=bn.running_var.numpy())
    with jax.enable_x64(True):
        flax = _flax_bn(x, weight, bias, dy)
    for want in (one, flax):
        for k, v in want.items():
            # flax keeps its running statistics in f32 whatever the dtype.
            f32 = want is flax and k in ("mean", "var")
            np.testing.assert_allclose(got[k], v, rtol=2e-7 if f32 else 0,
                                       atol=0 if f32 else 1e-10, err_msg=k)


# -- the DP step and train_nbp_dp -------------------------------------------------

@pytest.mark.parametrize("n,n_padded", [(2, 2), (4, 3)])
def test_dp_grad_parity_with_a_padded_rank(n, n_padded):
    """Two rows a rank, the last ``n_padded`` zero-weighted: the last rank
    holds only padded rows (and, at 4 ranks, the third one of each)."""
    ranks = _run(dp_grad_parity, n, S, 8, n_padded, True)
    for par in ranks:
        np.testing.assert_allclose(par["loss_n"], par["loss_1"], rtol=1e-8)
        top = np.abs(par["grad_1"]).max()
        np.testing.assert_allclose(par["grad_n"], par["grad_1"], rtol=1e-8,
                                   atol=1e-8 * top)
        np.testing.assert_array_equal(par["grad_n"], ranks[0]["grad_n"])


def _entries(n, seed, cls):
    return DR.seeded_entries(n, seed, S, cls)


@pytest.fixture(scope="module")
def flax8():
    """NBP(width=8) from seed 1 as a flax variable tree of numpy arrays
    (``models/convert.py``; no JAX compilation)."""
    params, stats = state_dict_to_flax(
        DR.seeded_train_model(1, width=8).state_dict())
    return {"params": params, "batch_stats": stats}


N_TRAIN, N_VAL, ACC = 13, 4, 2


def test_train_nbp_dp_matches_one_process(flax8):
    """2 ranks, f64, 13 entries in micro batches of 8 (a ragged tail each
    inner epoch), 2 micro steps an optimizer step, 3 inner epochs."""
    ranks = _run(DR.train_dp_rank, 2, flax8, _entries(N_TRAIN, 0, Experience),
                 _entries(N_VAL, 1, Experience), 2, 3, 5, True, 8, TINY, ACC,
                 True)
    single = ranks[0]["single"]
    for r in ranks:
        assert r["same_bits"]
        np.testing.assert_array_equal(r["flat"], ranks[0]["flat"])
        np.testing.assert_allclose(r["tl"], single["tl"], rtol=1e-8)
        np.testing.assert_allclose(r["vl"], single["vl"], rtol=1e-8)
    top = np.abs(single["flat"]).max()
    np.testing.assert_allclose(ranks[0]["flat"], single["flat"], rtol=1e-8,
                               atol=1e-8 * top)


@pytest.mark.parametrize("n", [2, 3])
def test_train_nbp_dp_matches_jax_mesh(flax8, monkeypatch, n):
    """The JAX ``train_nbp_dp`` on ``make_mesh(n)`` against n port ranks on
    the same converted weights and replay store, f64 on both sides; at 3
    ranks the micro batch is 9."""
    from nextbestpath_tpu.config import default_params as j_params

    train_j, val_j = _entries(N_TRAIN, 0, JExperience), _entries(N_VAL, 1,
                                                                 JExperience)
    ranks = _run(DR.train_dp_rank, n, flax8,
                 [Experience(**vars(e)) for e in train_j],
                 [Experience(**vars(e)) for e in val_j], 2, 3, 5, True, 8,
                 TINY, ACC)
    with _jax_f64(monkeypatch):
        fm = FlaxNBP(width=8, dtype=jnp.float64)
        v64 = _to64(flax8)
        opt = JT.make_optimizer(accumulation_steps=ACC)
        js = JT.TrainState(variables=v64, opt_state=opt.init(v64["params"]),
                           optimizer=opt, lr=1e-3)
        db = JReplayDB()
        db.entries = list(train_j)
        js, tl, vl = j_train_nbp_dp(fm, js, db, val_j, current_epoch=2,
                                    mesh=make_mesh(n), params=j_params(**TINY),
                                    num_epochs=3, seed=5, verbose=False)
        want = jax.tree_util.tree_map(np.asarray, js.variables)
    for r in ranks:
        assert r["same_bits"]
        np.testing.assert_allclose(r["tl"], tl, rtol=1e-6)
        np.testing.assert_allclose(r["vl"], vl, rtol=1e-6)
    back = as_float64(NBP(width=8))
    back.load_state_dict(flax_to_state_dict(want["params"],
                                            want["batch_stats"], np.float64))
    np.testing.assert_allclose(ranks[0]["flat"], DR.flat_state(back),
                               rtol=1e-4, atol=1e-10)


# -- one scene a rank --------------------------------------------------------------

def test_sharded_rollout_and_collection_equal_single_runs():
    """2 ranks, ``simple`` 2 and 3 at TINY, NBP(width=8): the sharded
    rollout's curves, trajectories and point counts and the sharded
    collection's coverages and replay store (the same on both ranks) equal
    the scenes' single runs bit for bit."""
    ranks = _run(DR.sharded_parity_rank, 2, [("simple", 2), ("simple", 3)],
                 TINY, 8, 4, 8, 5)
    r0 = ranks[0]
    assert all(r.coverage_evolution[0] > 0 for r in r0["rollout"])
    assert len(r0["db"]) > 0
    for r in ranks:
        assert DR.same_rollouts(r["rollout"], r0["single_rollout"])
        assert DR.same_rollouts(r["single_rollout"], r0["single_rollout"])
        assert r["coverages"] == r["single_coverages"] == r0["coverages"]
        assert r["db"] == r["single_db"] == r0["db"] and r["db_same"]


def test_run_training_nbp_dp_matches_one_rank(tmp_path):
    """2 epochs of 14 poses over ``simple`` 2 and 3, NBP(width=8): 2 ranks
    against 1 (epoch 1 trains on the poses past 10). Rank 0 alone writes
    the checkpoint and the loss log."""
    import json

    runs = {}
    for n in (1, 2):
        w, log = tmp_path / f"w{n}", tmp_path / f"log{n}"
        ranks = _run(DR.driver_rank, n, [("simple", 2), ("simple", 3)], TINY,
                     8, 2, 14, str(w), str(log), 8, timeout_s=180)
        assert all(r["same_bits"] for r in ranks)
        assert all(r["db"] == ranks[0]["db"] for r in ranks)
        assert sorted(os.listdir(w)) == ["dp_best_val.ckpt"]
        assert sorted(os.listdir(log)) == ["dp_loss.json"]
        with open(log / "dp_loss.json") as f:
            runs[n] = (ranks[0]["db"], json.load(f))
        epoch, _ = load_nbp(str(w / "dp_best_val.ckpt"), NBP(width=8))
        assert epoch == 1
    (db1, log1), (db2, log2) = runs[1], runs[2]
    assert db2 == db1 and len(db1) > 0
    assert log2["coverage_after_trajectory"] == log1[
        "coverage_after_trajectory"]
    for k in ("train", "val"):
        assert len(log2[k]) == 1 and log1[k][0] > 0
        np.testing.assert_allclose(log2[k], log1[k], rtol=1e-4)


def test_dryrun_multichip_four_cpu_ranks():
    line = DR.dryrun_multichip(4, device="cpu", timeout_s=DEADLINE_S)
    assert line.startswith("dryrun_multichip(4) on cpu (gloo): ok")


# -- the JAX sharded classes (slow, as in tests/test_multichip.py) ------------

@pytest.mark.slow
def test_jax_sharded_classes_match_the_port(nbp8):
    """JAX ``ShardedScanRollout`` and ``ShardedScanCollection`` on
    ``make_mesh(2)`` against the port's single-scene runs of the same
    padded scenes with the JAX key schedules (which the port's sharded
    classes equal bit for bit, above): coverage and gains within 1e-3, the
    same trajectories, labels and layouts."""
    from nextbestpath_tpu import assets as JA
    from nextbestpath_tpu import config as JC
    from nextbestpath_tpu.parallel.spmd import (
        ShardedScanCollection as JShardedCollection,
        ShardedScanRollout as JShardedRollout)
    from nextbestpath_tpu_torch import assets as TA
    from nextbestpath_tpu_torch import config as TC
    from nextbestpath_tpu_torch.eval.scan_rollout import (
        ScanRollout, common_sizes, pad_scene_arrays, scene_arrays_from_assets)
    from nextbestpath_tpu_torch.train import scan_collection as TSC
    from nextbestpath_tpu_torch.train.replay import ReplayDB

    from test_torch_multi_scene import _port, _same, _scenes
    from test_torch_rollout import JaxDraws
    from test_torch_scan_collection import JaxCollectDraws

    model, variables = nbp8
    seeds = (5, 6)
    mesh = make_mesh(2)
    want = JShardedRollout(_scenes(JA, JC, seeds, ("simple",) * 2), model,
                           variables, mesh, params=JC.default_params(**TINY)
                           ).run(n_poses=4, seed=8)
    scenes = _scenes(TA, TC, seeds, ("simple",) * 2)
    params = TC.default_params(**TINY)
    got = []
    f_max, g_max = common_sizes(scenes)
    for i, a in enumerate(scenes):
        scene = pad_scene_arrays(scene_arrays_from_assets(
            a, n_pieces=int(params.n_pieces), device="cpu"), f_max, g_max)
        got.append(ScanRollout(a, _port(variables), params=params,
                               scene=scene, draws=JaxDraws(8 + i),
                               device="cpu").run(n_poses=4))
    _same(got, want)

    jdb = JReplayDB()
    want_cov = JShardedCollection(
        _scenes(JA, JC, seeds, ("simple",) * 2), model, mesh,
        params=JC.default_params(**TINY)).collect_all(variables, jdb, seed=5,
                                                      n_poses=4)
    tm = _port(variables).train()
    tc = TSC.ScanCollection(scenes, tm, params=params,
                            make_draws=JaxCollectDraws, device="cpu")
    tdb = ReplayDB()
    got_cov = [TSC.collect_trajectory_scan(tc, i, tm, tdb, seed=5 + i,
                                           n_poses=4) for i in range(2)]
    for g, w in zip(got_cov, want_cov):
        np.testing.assert_allclose(g, w, atol=1e-3)
    assert len(tdb) == len(jdb) > 0
    for e_t, e_j in zip(tdb.entries, jdb.entries):
        assert e_t.pose_i == e_j.pose_i
        np.testing.assert_array_equal(e_t.gt_layout, e_j.gt_layout)
        np.testing.assert_array_equal(e_t.pixels, e_j.pixels)
        np.testing.assert_allclose(e_t.gains, e_j.gains, atol=1e-3)
