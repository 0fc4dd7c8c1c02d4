"""The port's research probes and last tools (``tools/*_torch.py``) against
the JAX tools, and the two repairs they rest on, on the CPU.

As in ``test_torch_tools.py``, each JAX tool's ``main()`` runs in-process
with ``sys.argv`` set and the names it imports inside ``main`` patched to
small sizes; the port tool's ``main(argv)`` runs on the same arguments with
``--device cpu`` and the JAX key schedules injected. Tolerances, and why:

* tools 1-3 (the oracle NBV, the value-decoder ablation, the suffix-label
  reliability) at the JAX tests' small configs: the decisions exact (the
  trajectories, the labelled pixels and their pose rows), every float of
  the returned dicts within 1e-3 (coverage within 1e-3, as every rollout
  test holds it);
* tools 4-6 (the ManyDepth probes) at 64x114 with the port's seeded
  weights on both sides (at 32x56 layer4's BatchNorm cancels in
  E[x^2] - E[x]^2): frames within 1e-5 of their scale, the losses and
  errors at the same weights within 1e-5 relative, as
  ``test_torch_pretrain_depth.py`` holds ManyDepth's outputs; after
  optimizer steps, the trainer's tolerance of
  ``test_torch_train_macarons.py`` (rtol 1e-4, atol 1e-5), and coverage
  within 1e-3;
* tool 7 byte for byte; tool 8 the same series.

The repairs: ``value_flat`` (``ScanRollout`` and ``BatchedScanRollout``
against JAX's ``ablate=("value_flat",)``, and what it changes), and the
collection's ``begin`` / ``advance`` / ``snapshot`` / ``restore`` /
``force_replan`` against ``run`` and against the JAX probe's mid-state.
"""

import contextlib
import copy
import functools
import importlib
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextbestpath_tpu import assets as JA
from nextbestpath_tpu import config as JC
from nextbestpath_tpu import models as JM
from nextbestpath_tpu.eval import macarons_nbv as JN
from nextbestpath_tpu.eval import scan_rollout as JSR
from nextbestpath_tpu.geometry import cameras as JCam
from nextbestpath_tpu.models import manydepth as JMD
from nextbestpath_tpu.models.macarons import Macarons as JMacarons
from nextbestpath_tpu.models.manydepth import ManyDepth as JManyDepth
from nextbestpath_tpu.models.scone import SconeOcc as JSconeOcc
from nextbestpath_tpu.models.scone import SconeVis as JSconeVis
from nextbestpath_tpu.train import scan_collection as JSC
from nextbestpath_tpu_torch import assets as TA
from nextbestpath_tpu_torch import config as TC
from nextbestpath_tpu_torch.eval import macarons_nbv as TN
from nextbestpath_tpu_torch.eval import scan_rollout as TSR
from nextbestpath_tpu_torch.eval.heldout import held_out_assets
from nextbestpath_tpu_torch.eval.nbp_planning import seeded_nbp
from nextbestpath_tpu_torch.geometry.cameras import CameraIntrinsics
from nextbestpath_tpu_torch.models import unet as TU
from nextbestpath_tpu_torch.models.convert import (manydepth_to_flax,
                                                   scone_occ_to_flax,
                                                   scone_vis_to_flax)
from nextbestpath_tpu_torch.models.macarons import Macarons
from nextbestpath_tpu_torch.models.manydepth import ManyDepth
from nextbestpath_tpu_torch.train import scan_collection as TSC
from nextbestpath_tpu_torch.train import train_macarons as TTM
from nextbestpath_tpu_torch.train import pretrain_depth as TPD
from nextbestpath_tpu_torch.train.driver import (run_training_nbp_scan,
                                                 seeded_train_model)

from test_torch_multi_scene import JaxWalkDraws
from test_torch_macarons_nbv import JaxNBVDraws
from test_torch_pretrain_depth import JaxDepthDraws
from test_torch_rollout import JaxDraws
from test_torch_scan_collection import TINY, JaxCollectDraws
from test_torch_tools import (_same_rollouts, _tool, _width8_variables,
                              ckpts, runs, small)  # noqa: F401
from test_torch_train_macarons import JaxTrainDraws

JTM = importlib.import_module("nextbestpath_tpu.train.train_macarons")
JPD = importlib.import_module("nextbestpath_tpu.train.pretrain_depth")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-3
POSES = 3
# ManyDepth's probes at 64x114 (layer4 sees 2x4 pixels; at 32x56 its
# train-mode BatchNorm cancels), with small buffers.
DEPTH_SIZE = dict(image_height=64, image_width=114, points_per_frame=256,
                  full_pc_capacity=16384, n_gt_surface_points=1024,
                  n_proxy_points=512)
OUT_RTOL = 1e-5                  # ManyDepth's outputs at the same weights
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5  # photometric losses on textured frames
# After Adam steps: the first steps move each weight by about lr sign(g),
# so a gradient entry whose f32 sign differs moves its weight by 2 lr
# (measured: depth maps 1.8e-4 of their scale, errors 1.5e-4 relative).
STEP_RTOL = 1e-3
# The procgen scenes' faces are one grey: on such textureless frames the
# plane-sweep costs are nearly equal across the 96 planes and SSIM takes
# the variances of nearly constant windows as E[x^2] - E[x]^2, so f32
# summation order moves the depth and the photometric loss (measured at
# the same weights: depth 3.5e-3 of its scale, the loss 1.8e-4 relative;
# the object's shaded frames 5e-7 and 4e-6).
FLAT_RTOL = 1e-2
STORE_CAPACITY = 32768


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the tier-1 run puts several test processes on
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _run_jax(name, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name] + argv)
    return _tool(name).main()


def _close_floats(got, want, atol=ATOL, rtol=0.0, path=""):
    """Two JSON trees alike: the same keys and list lengths, bools and
    strings equal, numbers within atol + rtol |want|."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close_floats(got[k], want[k], atol, rtol, f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close_floats(g, w, atol, rtol, f"{path}[{i}]")
    elif isinstance(want, bool) or want is None or isinstance(want, str):
        assert got == want, path
    else:
        assert abs(got - want) <= atol + rtol * abs(want) or (
            np.isnan(got) and np.isnan(want)), (path, got, want)


# -- repair 1: value_flat ------------------------------------------------------

def _tiny_scene(pkg, cfg, seed=8):
    return pkg.pack_generated_scene(pkg.generate_scene("simple", seed=seed),
                                    params=cfg.default_params(**TINY))


def test_value_flat_scores_as_ones_and_keeps_the_unet():
    """The ablation changes the scores and the orientations' value map
    alone: the U-Net's output, the layout's blocked edges and the
    projections are those of the plain rollout on the same state, and the
    scores are what ones score."""
    from nextbestpath_tpu_torch.eval.nbp_planning import \
        fuse_layout_from_projections
    from nextbestpath_tpu_torch.planning.candidates import \
        score_candidates_test

    t = _tiny_scene(TA, TC)
    model = seeded_nbp(width=8, seed=0)
    plain = TSR.ScanRollout(t, model, params=TC.default_params(**TINY),
                            device="cpu")
    flat = TSR.ScanRollout(t, model, params=TC.default_params(**TINY),
                           value_flat=True, device="cpu")
    assert flat.value_flat and not plain.value_flat
    for r in (plain, flat):
        r.run(n_poses=2, seed=3)
    # The ablated rollout takes the plain one's state.
    for f, g in ((flat.state, plain.state), (flat.state.pc, plain.state.pc),
                 (flat.state.traj, plain.state.traj)):
        for k, v in vars(g).items():
            if isinstance(v, torch.Tensor):
                vars(f)[k].copy_(v)
    flat.pre.cur_pose5.copy_(plain.pre.cur_pose5)
    outs = {}
    with torch.no_grad():
        for name, r in (("plain", plain), ("flat", flat)):
            x, *proj = r._plan_input()
            vm, om = r.model(x)
            outs[name] = (x, vm, om, proj) + r._plan_maps(vm, om, *proj)
        (xp, vp, op, proj, sp, lp, mp), (xf, vf, of, _, sf, lf, mf) = (
            outs["plain"], outs["flat"])
        assert torch.equal(xp, xf) and float(xp.sum()) > 50
        assert torch.equal(vp, vf) and torch.equal(op, of)
        assert torch.equal(lp, lf)
        ones = torch.ones_like(vp[0])
        assert torch.equal(mp, vp[0]) and torch.equal(mf, ones)
        traj_img, proj_img, filt = proj
        _, proj256 = fuse_layout_from_projections(op[0, :, :, 0], proj_img,
                                                  filt, traj_img)
        p = TC.default_params(**TINY)
        want = score_candidates_test(
            flat.scene.positions, flat.pre.cur_pose5[:3], ones, proj256,
            flat.state.banned, value_map_size=int(p.value_map_size[0]),
            layout_size=int(p.pc2img_size[0]))
    assert torch.equal(sf, want) and not torch.equal(sf, sp)


@pytest.mark.parametrize("batched", [False, True])
def test_value_flat_rollouts_match_jax(batched):
    """6 poses of the ablated rollout, single-scene and on two padded
    scenes, against JAX's ``ablate=("value_flat",)`` with its key
    schedule: the same trajectories, coverage within 1e-3; and the ablation
    changes the plain rollout's decisions on one of them at least."""
    jp, tp = JC.default_params(**TINY), TC.default_params(**TINY)
    variables = _width8_variables(0)
    if batched:
        j_assets = JA.scene_assets.pad_assets_to_common(
            [_tiny_scene(JA, JC, s) for s in (8, 4)])
        t_assets = TA.pad_assets_to_common([_tiny_scene(TA, TC, s)
                                            for s in (8, 4)])
        jb = JSR.BatchedScanRollout(j_assets, JM.NBP(width=8), variables,
                                    params=jp)
        # The JAX batched step runs its first rollout's plan core, which
        # reads that rollout's switch.
        for r in jb.rollouts:
            r.ablate = ("value_flat",)
        want = jb.run(n_poses=6, seed=5)
        got, plain = (TSR.BatchedScanRollout(
            t_assets, seeded_nbp(width=8, seed=0), params=tp,
            make_draws=JaxDraws, value_flat=flat, device="cpu").run(
                n_poses=6, seed=5) for flat in (True, False))
    else:
        want = [JSR.ScanRollout(
            _tiny_scene(JA, JC), JM.NBP(width=8), variables, params=jp,
            ablate=("value_flat",)).run(n_poses=6, seed=5)]
        got, plain = ([TSR.ScanRollout(
            _tiny_scene(TA, TC), seeded_nbp(width=8, seed=0), params=tp,
            make_draws=JaxDraws, value_flat=flat, device="cpu").run(
                n_poses=6, seed=5)] for flat in (True, False))
    _same_rollouts(got, want)
    assert any(g.cam_positions.shape != p.cam_positions.shape
               or not np.array_equal(g.cam_positions, p.cam_positions)
               for g, p in zip(got, plain))


def test_set_scene_leaves_the_first_scene_as_it_was():
    """On the CPU a scene's arrays share its assets' numpy memory: moving
    a rollout to another scene leaves the first scene's assets, and a
    rollout built on them afterwards, as they were."""
    params = TC.default_params(**TINY)
    a, b = held_out_assets(params, scenes_per_diff=2,
                           difficulties=("simple",))
    gt, azims = a.gt_surface.copy(), np.array(a.azimuths_deg, copy=True)
    model = seeded_nbp(width=8, seed=0)
    want = TSR.ScanRollout(a, model, params=params, device="cpu").run(
        n_poses=2, seed=4)
    moved = TSR.ScanRollout(a, model, params=params, device="cpu")
    moved.set_scene(b)
    np.testing.assert_array_equal(a.gt_surface, gt)
    np.testing.assert_array_equal(a.azimuths_deg, azims)
    got = TSR.ScanRollout(a, model, params=params, device="cpu").run(
        n_poses=2, seed=4)
    assert got.coverage_evolution == want.coverage_evolution


# -- repair 2: a collection that branches ----------------------------------------

def _collection(make_draws=JaxCollectDraws):
    torch.manual_seed(0)
    model = TU.NBP(width=8).train()
    return TSC.ScanCollection([_tiny_scene(TA, TC, 2)], model,
                              params=TC.default_params(**TINY),
                              make_draws=make_draws, device="cpu"), model


def _same_out(a, b):
    for name, x, y in zip(a._fields, a, b):
        np.testing.assert_array_equal(x, y, err_msg=name)


def test_begin_advance_is_run_and_restore_replays():
    """``begin`` + ``advance`` in two parts gives ``run``'s records bit for
    bit (the second part from row 0); ``restore`` of a snapshot taken
    after the first part replays the second part bit for bit, and a
    forced replan plans at its row 0."""
    col, model = _collection()
    whole = col.run(0, model, seed=5, n_poses=8)
    draws = col.begin(0, seed=5, n_poses=8, variables=model)
    first = col.advance(3, draws)
    mid = col.snapshot()
    after = copy.deepcopy(draws)
    second = col.advance(5, draws)
    for k in TSC.CollectOut._fields:
        np.testing.assert_array_equal(
            np.concatenate([getattr(first, k)[:3], getattr(second, k)[:5]]),
            getattr(whole, k), err_msg=k)
    col.restore(mid)
    _same_out(col.advance(5, after), second)
    col.restore(mid)
    col.force_replan()
    again = col.advance(5, copy.deepcopy(after))
    assert again.planned[0] and again.valid[0]
    np.testing.assert_array_equal(again.pose5[0], second.pose5[0])
    with pytest.raises(ValueError, match="advance"):
        col.advance(500, draws)


def test_advance_runs_frozen_poses_on_request(monkeypatch):
    """Once the rollout is done, ``advance`` leaves the remaining poses out
    unless ``run_frozen``: then they run as the JAX scan's frozen poses do,
    the camera in place, invalid, no plan, their frames still captured."""
    monkeypatch.setattr(TSC, "COVERAGE_STOP", -1.0)
    col, model = _collection()
    counts = {}
    for frozen in (False, True):
        draws = col.begin(0, seed=5, n_poses=3, variables=model)
        out = col.advance(3, draws, run_frozen=frozen)
        counts[frozen] = int(col.state.pc.count)
        assert not out.valid.any() and not out.planned.any()
        assert col.plan_poses == [False] * (3 if frozen else 1)
    np.testing.assert_array_equal(out.pose5, np.repeat(out.pose5[:1], 3, 0))
    assert counts[True] > counts[False] > 0


class JaxBranchDraws(JaxCollectDraws):
    """A continuation's key: ``PRNGKey(seed)`` itself is the state's key
    (the JAX probe replaces ``state.key``), split 8 ways a pose."""

    def __init__(self, seed):
        self.key, self.roles = jax.random.PRNGKey(seed), {}


def test_branch_from_mid_state_matches_jax():
    """The JAX probe's branch: 5 poses from seed 777, the mid-state made
    to replan, then two continuations of 5 poses from PRNGKey(10000 + 97
    k): each continuation's records (row 0 the branch pose) as JAX's."""
    model_j, variables = JM.NBP(width=8), _width8_variables(1)
    jc = JSC.ScanCollection([_tiny_scene(JA, JC, 2)], model_j,
                            params=JC.default_params(**TINY))
    folded = importlib.import_module(
        "nextbestpath_tpu.models.fold").fold_bn_variables(variables)
    seg = jc._rollout_fn(5)
    mid, _ = seg(jc.scenes[0], folded, jc.initial_state(0, seed=777,
                                                        n_poses=10))
    mid = mid._replace(path_len=jnp.int32(0), path_record=jnp.int32(0),
                       done=jnp.bool_(False))
    col = TSC.ScanCollection([_tiny_scene(TA, TC, 2)],
                             seeded_nbp(width=8, seed=1),
                             params=TC.default_params(**TINY),
                             make_draws=JaxCollectDraws, device="cpu")
    draws = col.begin(0, seed=777, n_poses=10)
    col.advance(5, draws, run_frozen=True)
    col.force_replan()
    snap = col.snapshot()
    outs = []
    for k in range(2):
        _, want = seg(jc.scenes[0], folded,
                      mid._replace(key=jax.random.PRNGKey(10_000 + 97 * k)))
        col.restore(snap)
        got = col.advance(5, JaxBranchDraws(10_000 + 97 * k))
        for name in ("pose5", "rot", "valid", "planned"):
            np.testing.assert_array_equal(getattr(got, name),
                                          np.asarray(getattr(want, name)),
                                          err_msg=name)
        np.testing.assert_allclose(got.coverage, np.asarray(want.coverage),
                                   atol=ATOL)
        assert got.planned[0]
        outs.append(got)
    # The two continuations start at one pose and part where their draws
    # do.
    np.testing.assert_array_equal(outs[0].pose5[0], outs[1].pose5[0])
    assert not np.array_equal(outs[0].pose5, outs[1].pose5)


# -- tool 1: the oracle NBV ------------------------------------------------------

@pytest.fixture
def nbv_small(monkeypatch):
    j_params, t_params = JC.default_params, TC.default_params
    monkeypatch.setattr(JC, "default_params",
                        lambda **kw: j_params(**{**TN.NBV_SMALL, **kw}))
    monkeypatch.setattr(TC, "default_params",
                        lambda **kw: t_params(**{**TN.NBV_SMALL, **kw}))


def _record(monkeypatch, module, name, into):
    fn = getattr(module, name)

    def wrapped(*a, **kw):
        res = fn(*a, **kw)
        into.append(res)
        return res
    monkeypatch.setattr(module, name, wrapped)


def test_probe_nbv_oracle_matches_jax(nbv_small, runs, tmp_path, monkeypatch):
    nbv = {"jax": [], "port": []}
    _record(monkeypatch, JN, "macarons_nbv_rollout", nbv["jax"])
    _record(monkeypatch, TN, "macarons_nbv_rollout", nbv["port"])
    argv = ["--eval-poses", str(POSES), "--eval-scenes-per-diff", "1",
            "--eval-seeds", "1"]
    _run_jax("probe_nbv_oracle", argv + ["--out", str(tmp_path / "j.json")],
             monkeypatch)
    want = json.load(open(tmp_path / "j.json"))
    got = _tool("probe_nbv_oracle_torch").main(
        argv + ["--device", "cpu", "--out", str(tmp_path / "p.json")],
        make_draws=JaxNBVDraws, make_walk_draws=JaxWalkDraws)
    assert json.load(open(tmp_path / "p.json")) == got
    assert len(nbv["port"]) == len(nbv["jax"]) == 1
    _same_rollouts(nbv["port"], nbv["jax"])
    _same_rollouts(runs["port"], runs["jax"])
    _close_floats(got, want)
    assert list(got["per_difficulty"]) == ["simple"]
    assert got["per_difficulty"]["simple"]["oracle_auc"] > 0


# -- tool 2: the value decoder's share -------------------------------------------

def test_probe_value_contribution_matches_jax(small, runs, ckpts, tmp_path,
                                              monkeypatch):
    """The held-out scenes of two difficulties (``simple`` and ``normal``,
    padded to ``normal``'s lattice), each rolled out as it is and with the
    uniform value map."""
    for mod in (importlib.import_module("nextbestpath_tpu.eval.heldout"),
                importlib.import_module(
                    "nextbestpath_tpu_torch.eval.heldout")):
        monkeypatch.setattr(mod, "held_out_assets", functools.partial(
            mod.held_out_assets, difficulties=("simple", "normal")))
    argv = ["--ckpt", ckpts["a"], "--poses", str(POSES),
            "--scenes-per-diff", "1", "--seeds", "1"]
    _run_jax("probe_value_contribution",
             argv + ["--out", str(tmp_path / "j.json")], monkeypatch)
    want = json.load(open(tmp_path / "j.json"))
    got = _tool("probe_value_contribution_torch").main(
        argv + ["--device", "cpu", "--dtype", "float32",
                "--out", str(tmp_path / "p.json")], make_draws=JaxDraws)
    assert json.load(open(tmp_path / "p.json")) == got
    assert len(runs["port"]) == 4
    _same_rollouts(runs["port"], runs["jax"])
    assert got["ckpt"] == want["ckpt"] and got["poses"] == POSES
    _close_floats(got["per_scene"], want["per_scene"])
    assert list(got["per_difficulty"]) == ["simple", "normal"]
    for diff, w in want["per_difficulty"].items():
        g = got["per_difficulty"][diff]
        assert abs(g["normal"] - w["normal"]) <= ATOL
        assert abs(g["value_flat"] - w["value_flat"]) <= ATOL
        # The percentage of two AUCs rounded to 1e-4 is only as close as
        # they are.
        assert abs(g["value_gain_pct"] - w["value_gain_pct"]) <= (
            100 * 2 * ATOL / max(w["value_flat"], 1e-9) + 0.1)


# -- tool 3: the suffix labels' reliability --------------------------------------

def test_probe_label_quality_matches_jax(small, ckpts, tmp_path, monkeypatch):
    """One branch at pose 5, four continuations of 5 poses: every
    continuation's branch-pose labels (pixels exact, gains within 1e-3)
    and the report (counts exact, statistics within 1e-3)."""
    labels = {"jax": [], "port": []}
    _record(monkeypatch, JSC, "suffix_labels_from_out", labels["jax"])
    _record(monkeypatch, TSC, "suffix_labels_from_out", labels["port"])
    argv = ["--ckpt", ckpts["a"], "--branch-poses", "5",
            "--continuations", "4", "--cont-poses", "5"]
    _run_jax("probe_label_quality", argv + ["--out", str(tmp_path / "j.json")],
             monkeypatch)
    want = json.load(open(tmp_path / "j.json"))
    got = _tool("probe_label_quality_torch").main(
        argv + ["--device", "cpu", "--dtype", "float32",
                "--out", str(tmp_path / "p.json")],
        make_draws=JaxCollectDraws, make_branch_draws=JaxBranchDraws)
    _close_floats(json.load(open(tmp_path / "p.json")), got, atol=0)
    assert len(labels["port"]) == len(labels["jax"]) == 4
    for g_list, w_list in zip(labels["port"], labels["jax"]):
        assert [x[0] for x in g_list] == [x[0] for x in w_list]
        for (_, gp, gg), (_, wp, wg) in zip(g_list, w_list):
            np.testing.assert_array_equal(gp, wp)
            np.testing.assert_allclose(gg, wg, atol=ATOL)
    # The branch pose is row 0 of each continuation.
    assert all(g_list and g_list[0][0] == 0 for g_list in labels["port"])
    entry, w = got["branches"][0], want["branches"][0]
    for k in ("branch_pose", "labels_per_continuation", "n_pixels_total",
              "n_pixels_multi", "n_split_half_pixels"):
        assert entry[k] == w[k], k
    _close_floats(got, want)
    assert entry["labels_per_continuation"] == [
        len({tuple(x) for i, px, _ in g if i == 0 for x in px})
        for g in labels["port"]]
    assert min(entry["labels_per_continuation"]) > 0


# -- tools 4-6: ManyDepth --------------------------------------------------------

@pytest.fixture
def depth_size(monkeypatch):
    """Both packages' default_params at DEPTH_SIZE, whatever frame size the
    tool asks for."""
    j_params, t_params = JC.default_params, TC.default_params
    monkeypatch.setattr(JC, "default_params",
                        lambda **kw: j_params(**{**kw, **DEPTH_SIZE}))
    monkeypatch.setattr(TC, "default_params",
                        lambda **kw: t_params(**{**kw, **DEPTH_SIZE}))


@pytest.fixture(scope="module")
def depth_models():
    """The port's seeded bundle at 64x114 and the same weights as the JAX
    package's Macarons (through the converters: flax's init of the bundle
    compiles for a minute)."""
    m = Macarons.create(0, image_height=64, image_width=114)
    jm = JMacarons(
        depth=JManyDepth(intr=JCam.CameraIntrinsics(image_height=64,
                                                    image_width=114)),
        scone_occ=JSconeOcc(seq_len=2048), scone_vis=JSconeVis(),
        depth_vars=jax.tree_util.tree_map(jnp.asarray,
                                          manydepth_to_flax(m.depth_vars)),
        occ_vars={"params": jax.tree_util.tree_map(
            jnp.asarray, scone_occ_to_flax(m.occ_vars))},
        vis_vars={"params": jax.tree_util.tree_map(
            jnp.asarray, scone_vis_to_flax(m.vis_vars))})
    return m, jm


def _jax_bundle(monkeypatch, jm):
    """The JAX trainer's ``Macarons.create`` hands out ``jm``'s weights."""
    class Preset:
        @staticmethod
        def create(key, **kw):
            return copy.copy(jm)
    monkeypatch.setattr(JTM, "Macarons", Preset)


def _small_store(monkeypatch):
    """Both trainers' surface store at STORE_CAPACITY points, which the
    probe's few poses (at most 256 points a frame) do not fill: the JAX
    store's distance pass over 262,144 points takes seconds a pose."""
    real = JTM.SurfaceStore

    class Capped:
        @staticmethod
        def create(capacity, *a, **kw):
            return real.create(min(capacity, STORE_CAPACITY), *a, **kw)
    monkeypatch.setattr(JTM, "SurfaceStore", Capped)
    monkeypatch.setattr(TTM, "STORE_CAPACITY", STORE_CAPACITY)


def _record_depth_steps(monkeypatch, module, into):
    """Every photometric loss and inferred depth map of the depth steps
    that ``module.make_depth_steps`` makes, unrounded."""
    make = module.make_depth_steps

    def wrapped(*a, **kw):
        step, infer = make(*a, **kw)

        def step_(*sa, **skw):
            res = step(*sa, **skw)
            into["photo"].append(float(res[2]))
            return res

        def infer_(*ia, **ikw):
            res = infer(*ia, **ikw)
            into["depth"].append(np.asarray(res))
            return res
        return step_, infer_
    monkeypatch.setattr(module, "make_depth_steps", wrapped)


@pytest.mark.parametrize("mode", [[], ["--object"]])
def test_depth_convergence_probe_matches_jax(mode, depth_size, depth_models,
                                             tmp_path, monkeypatch):
    """A 6-frame window, 2 depth steps, the held-out frame inferred at
    steps 0 and 2: the walk's cells exact, the frames within 1e-5 of their
    scale; on the object's shaded frames ManyDepth at the same weights
    within 1e-5 of its scale, the losses within rtol 1e-4, the depth after
    the steps within 1e-3 (``STEP_RTOL``); on the scene's grey frames
    within ``FLAT_RTOL``."""
    m, jm = depth_models
    _jax_bundle(monkeypatch, jm)
    rec = {"jax": {"photo": [], "depth": [], "frames": []},
           "port": {"photo": [], "depth": [], "frames": []}}
    _record_depth_steps(monkeypatch, JTM, rec["jax"])
    _record_depth_steps(monkeypatch, TTM, rec["port"])
    for side, mod in (("jax", "nextbestpath_tpu.sim.sensor"),
                      ("port", "nextbestpath_tpu_torch.sim.sensor")):
        _record(monkeypatch, importlib.import_module(mod), "capture_rgbd",
                rec[side]["frames"])
    argv = ["--steps", "2", "--eval-every", "2", "--frames", "6"] + mode
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        _run_jax("depth_convergence_probe",
                 argv + ["--out", str(tmp_path / "j.json")], monkeypatch)
    want = json.load(open(tmp_path / "j.json"))
    state = TTM.MacaronsTrainState.create(params=TC.default_params(),
                                          model=m, device="cpu")
    with contextlib.redirect_stderr(err):
        got = _tool("depth_convergence_probe_torch").main(
            argv + ["--device", "cpu", "--out", str(tmp_path / "p.json")],
            make_draws=JaxTrainDraws, state=state)
    walks = [line for line in err.getvalue().splitlines()
             if line.startswith("# walk")]
    assert len(walks) == (0 if mode else 2) and len(set(walks)) <= 1
    assert json.load(open(tmp_path / "p.json")) == got
    assert got["summary"]["mode"] == want["summary"]["mode"]
    assert len(got["photometric_curve"]) == len(want["photometric_curve"]) == 2
    j, t = rec["jax"], rec["port"]
    assert len(t["frames"]) == len(j["frames"]) == 6
    for tf, jf in zip(t["frames"], j["frames"]):
        for a, b in zip(tf[:2], jf[:2]):  # rgb, zbuf
            _within_scale(a.numpy(), np.asarray(b), OUT_RTOL, mask=False)
    assert len(t["photo"]) == len(j["photo"]) == 2
    assert len(t["depth"]) == len(j["depth"]) == 2
    same, loss, stepped = ((OUT_RTOL, LOSS_RTOL, STEP_RTOL) if mode
                           else (FLAT_RTOL,) * 3)
    _within_scale(t["depth"][0], j["depth"][0], same)
    np.testing.assert_allclose(t["photo"], j["photo"], rtol=loss,
                               atol=LOSS_ATOL)
    _within_scale(t["depth"][1], j["depth"][1], stepped)
    _close_floats(got["summary"], want["summary"], atol=1e-4, rtol=stepped)


def _within_scale(got, want, rtol, mask=True):
    """Within rtol of the reference's largest magnitude; with ``mask``, on
    the pixels that both inferred maps keep (-1 elsewhere), which are
    all but 0.1% of either's."""
    if mask:
        both = (got > 0) & (want > 0)
        assert both.mean() > 0.5
        assert ((got > 0) != (want > 0)).mean() <= 1e-3
        got, want = got[both], want[both]
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def test_depth_quality_probe_matches_jax(depth_size, depth_models, tmp_path,
                                         monkeypatch):
    """Both runs of 4 poses on the grey scene with online depth learning:
    the photometric losses and depth errors a pose (``FLAT_RTOL``), the
    coverage curves (1e-3) and the summary alike."""
    m, jm = depth_models
    _jax_bundle(monkeypatch, jm)
    _small_store(monkeypatch)
    logs = {"jax": [], "port": []}
    _record(monkeypatch, JTM, "train_macarons_online", logs["jax"])
    _record(monkeypatch, TTM, "train_macarons_online", logs["port"])
    argv = ["--poses", "4"]
    with contextlib.redirect_stdout(io.StringIO()):
        _run_jax("depth_quality_probe",
                 argv + ["--out", str(tmp_path / "j.json")], monkeypatch)
        want = json.load(open(tmp_path / "j.json"))
        state = TTM.MacaronsTrainState.create(params=TC.default_params(),
                                              model=m, device="cpu")
        got = _tool("depth_quality_probe_torch").main(
            argv + ["--device", "cpu", "--out", str(tmp_path / "p.json")],
            make_draws=JaxTrainDraws, state=state)
    assert json.load(open(tmp_path / "p.json")) == got
    assert len(logs["port"]) == len(logs["jax"]) == 2
    for g, w in zip(logs["port"], logs["jax"]):
        for k in ("depth_loss", "depth_abs_err"):
            assert len(g[k]) == len(w[k]) > 0, k
            np.testing.assert_allclose(g[k], w[k], rtol=FLAT_RTOL,
                                       atol=LOSS_ATOL, err_msg=k)
        for k in ("coverage", "store_coverage"):
            np.testing.assert_allclose(g[k], w[k], atol=ATOL, err_msg=k)
    assert max(logs["port"][0]["depth_loss"]) > 0
    assert max(logs["port"][0]["store_coverage"]) > 0
    _close_floats(got, want, rtol=FLAT_RTOL)


def test_probe_depth_eval_gap_matches_jax(depth_size, tmp_path, monkeypatch,
                                          capsys):
    """Two trials of the eval-gap probe on a seeded checkpoint at 64x114:
    the walklets, the errors of both renders (1e-5 relative), and plain
    equal to textured (procgen faces are one grey)."""
    torch.manual_seed(0)
    intr = CameraIntrinsics(image_height=64, image_width=114)
    model = ManyDepth(intr=intr)
    ckpt = str(tmp_path / "depth.ckpt")
    TPD.save_depth_checkpoint(ckpt, model, 7, 2.5)
    preset = jax.tree_util.tree_map(
        jnp.asarray, manydepth_to_flax(model.state_dict()))
    j_intr = JCam.CameraIntrinsics

    class Preset(JManyDepth):
        """The JAX ManyDepth, its init the checkpoint's structure (flax's
        init traces the model at 256x456)."""

        def init(self, *a, **kw):
            return preset
    monkeypatch.setattr(JMD, "ManyDepth", Preset)
    monkeypatch.setattr(JCam, "CameraIntrinsics", lambda **kw: j_intr(
        **{**kw, "image_height": 64, "image_width": 114}))
    errs = {"jax": [], "port": []}
    for side, mod in (("jax", JPD), ("port", TPD)):
        make = mod.make_eval_fn

        def wrapped(*a, _make=make, _into=errs[side], **kw):
            ev = _make(*a, **kw)

            def ev_(*ea, **ekw):
                res = ev(*ea, **ekw)
                _into.append(float(res))
                return res
            return ev_
        monkeypatch.setattr(mod, "make_eval_fn", wrapped)
    argv = ["--ckpt", ckpt, "--trials", "2"]
    _run_jax("probe_depth_eval_gap", argv, monkeypatch)
    got = _tool("probe_depth_eval_gap_torch").main(
        argv + ["--device", "cpu", "--out", str(tmp_path / "p.json")],
        make_draws=JaxGapDraws)
    out = capsys.readouterr().out
    assert out.count("# loaded") == 2 and out.count("trial 1:") == 2
    assert json.load(open(tmp_path / "p.json")) == got
    assert (got["step"], got["extra"]) == (7, {"eval_err": 2.5})
    assert len(errs["port"]) == len(errs["jax"]) == 4
    np.testing.assert_allclose(errs["port"], errs["jax"], rtol=OUT_RTOL)
    for t in got["trials"]:
        assert t["plain_err"] == t["textured_err"] > 0


class JaxGapDraws(JaxDepthDraws):
    """A trial's walklets: sample b's walk from fold_in(PRNGKey(1234 + t),
    b), split as the depth pretrainer's (``JaxDepthDraws``)."""

    def __init__(self, seed):
        super().__init__(seed)
        self.key = jax.random.PRNGKey(seed)


# -- tools 7 and 8 ---------------------------------------------------------------

def test_gen_configs_is_the_jax_tree_byte_for_byte(tmp_path, monkeypatch):
    jax_tool = _tool("gen_configs")
    monkeypatch.setattr(jax_tool, "ROOT", str(tmp_path / "jax"))
    with contextlib.redirect_stdout(io.StringIO()):
        jax_tool.main()
        got = _tool("gen_configs_torch").main(
            ["--device", "cpu", "--out", str(tmp_path / "port")])
    written = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                     for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert written == sorted(got) and len(written) == 13
    for rel in written:
        port = open(tmp_path / "port" / rel, "rb").read()
        assert port == open(tmp_path / "jax" / rel, "rb").read(), rel
        assert port == open(os.path.join(REPO, "configs", rel), "rb").read()
        assert json.loads(port) == got[rel]


def _figure_lines(monkeypatch, into):
    """Each saved figure's axes as (title, [(label, x, y)])."""
    from matplotlib.figure import Figure

    def savefig(fig, *a, **kw):
        into.append([(ax.get_title(), ax.get_yscale(),
                      [(ln.get_label(), [float(v) for v in ln.get_xdata()],
                        [float(v) for v in ln.get_ydata()])
                       for ln in ax.get_lines()]) for ax in fig.axes])
    monkeypatch.setattr(Figure, "savefig", savefig)


def test_plot_training_draws_the_jax_series(tmp_path, monkeypatch):
    """A log of the port's scan trainer (3 scenes, 3 epochs, evaluated
    every epoch): the port tool draws the JAX tool's lines, and returns
    them."""
    pytest.importorskip("matplotlib")
    params = TC.default_params(**TINY)
    scenes = TA.pad_assets_to_common([
        TA.pack_generated_scene(TA.generate_scene(d, seed=s), params=params)
        for d, s in (("simple", 2), ("normal", 3), ("simple", 4))])
    evals = [TA.pack_generated_scene(TA.generate_scene(d, seed=s),
                                     params=params)
             for d, s in (("simple", 508), ("normal", 545))]
    evals = TA.pad_assets_to_common(evals)
    run_training_nbp_scan(
        scenes, eval_scenes=evals, params=params, epochs=3, n_poses=4,
        db_dir=str(tmp_path / "db"), weights_dir=str(tmp_path / "w"),
        log_dir=str(tmp_path / "log"), seed=3, verbose=False, eval_every=1,
        eval_poses=2, device="cpu",
        model=seeded_train_model(3, width=8, dtype=torch.bfloat16))
    log = str(tmp_path / "log" / "nbp_loss.json")
    assert len(json.load(open(log))["coverage_after_trajectory"]) == 9
    figs = []
    _figure_lines(monkeypatch, figs)
    with contextlib.redirect_stdout(io.StringIO()):
        _tool("plot_training").main(log, str(tmp_path / "j.png"))
        got = _tool("plot_training_torch").main(
            [log, str(tmp_path / "p.png"), "--device", "cpu"])
    want_fig, got_fig = figs
    assert got_fig == want_fig
    assert [len(ax[2]) for ax in got_fig] == [2, 2, 2]
    for (title, scale, lines), panel in zip(got_fig, got["panels"]):
        assert panel["title"] == title and panel["yscale"] == scale
        assert [(s["label"], [float(x) for x in s["x"]], s["y"])
                for s in panel["series"]] == lines
    assert got["out"] == str(tmp_path / "p.png")


def test_plot_training_says_when_matplotlib_is_missing(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = tmp_path / "p.png"
    with pytest.raises(SystemExit, match="matplotlib"):
        _tool("plot_training_torch").main(
            [os.path.join(REPO, "training_log", "nbp_loss.json"), str(out),
             "--device", "cpu"])
    assert not out.exists()
