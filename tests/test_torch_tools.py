"""The port's policy-quality tools (``tools/*_torch.py``) against the JAX
tools, on the CPU.

Each JAX tool's ``main()`` runs in-process with ``sys.argv`` set, its
``default_params`` and ``NBP`` (the module attributes it imports inside
``main``) monkeypatched to the JAX tests' ``TINY`` config and a width-8
f32 NBP, reading a small checkpoint that the JAX ``save_checkpoint``
wrote. The port tool's ``main(argv)`` runs on the same arguments with
``--device cpu --dtype float32``, the port's ``default_params`` and
``NBP`` patched alike and the JAX key schedules injected (``JaxDraws``,
``JaxWalkDraws``). Every rollout either side runs is recorded: the same
trajectories and point counts (the decisions), coverage within 1e-3, and
the tools' JSON (AUCs and final coverages within 1e-3, ``nbp_wins``, the
verdict) alike.

The scan rollout past the point buffer's capacity, also against JAX.
Port-only cases: ``eval101_all``'s merge, ``{level}`` fallback and FAILED
level (its processes run in-process here), the promotion gate's A against
A through a per-level candidate with no files, ``compare_nbp_vs_random``'s
plot only on request, ``macarons_e2e`` at ``--tiny`` with warm starts,
``ScanRollout.set_scene`` against a fresh rollout, and every tool
refusing ``--device cuda`` without a card.
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from nextbestpath_tpu import config as JC
from nextbestpath_tpu import models as JM
from nextbestpath_tpu.eval import random_walk as JRW
from nextbestpath_tpu.eval import scan_rollout as JSR
from nextbestpath_tpu.utils.checkpoint import save_checkpoint as j_save
from nextbestpath_tpu_torch import config as TC
from nextbestpath_tpu_torch.eval import random_walk as TRW
from nextbestpath_tpu_torch.eval import scan_rollout as TSR
from nextbestpath_tpu_torch.eval.heldout import held_out_assets
from nextbestpath_tpu_torch.eval.nbp_planning import seeded_nbp
from nextbestpath_tpu_torch.models.convert import state_dict_to_flax
from nextbestpath_tpu_torch.models import unet as TU

from test_torch_multi_scene import JaxWalkDraws
from test_torch_rollout import JaxDraws
from test_torch_scan_collection import TINY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-3
POSES = 3
TOOLS = ("eval_vs_random_r2", "eval101_all", "compare_ckpts",
         "compare_nbp_vs_random", "finetune_per_level", "macarons_e2e",
         "probe_nbv_oracle", "probe_value_contribution",
         "probe_label_quality", "depth_convergence_probe",
         "depth_quality_probe", "probe_depth_eval_gap", "gen_configs",
         "plot_training")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the tier-1 run puts several test processes on
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _tool(name):
    """A tool's module, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        f"tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _width8_variables(seed):
    """A width-8 NBP's flax variables (numpy trees) with its obstacle
    decoder opened (final2 bias -4): the port's seeded model in the flax
    layout, which the JAX loader reads as it reads its own."""
    params, stats = state_dict_to_flax(
        seeded_nbp(width=8, seed=seed).state_dict())
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Two width-8 checkpoints (A seed 0 at epoch 3, B seed 1 at epoch 5),
    written by the JAX package."""
    d = tmp_path_factory.mktemp("ckpts")
    paths = {}
    for key, seed, epoch in (("a", 0, 3), ("b", 1, 5)):
        paths[key] = str(d / f"nbp_{key}.ckpt")
        j_save(paths[key], _width8_variables(seed), epoch=epoch)
    return paths


@pytest.fixture
def small(monkeypatch):
    """Both packages' default_params at TINY, their NBP at width 8 in f32."""
    j_params, t_params = JC.default_params, TC.default_params
    monkeypatch.setattr(JC, "default_params",
                        lambda **kw: j_params(**{**TINY, **kw}))
    monkeypatch.setattr(TC, "default_params",
                        lambda **kw: t_params(**{**TINY, **kw}))
    j_nbp, t_nbp = JM.NBP, TU.NBP
    monkeypatch.setattr(JM, "NBP", lambda dtype=None: j_nbp(width=8))
    monkeypatch.setattr(TU, "NBP", lambda dtype=torch.float32:
                        t_nbp(width=8, dtype=dtype))


@pytest.fixture
def runs(monkeypatch):
    """Every rollout result of the JAX and port rollout classes the tools
    use, in the order they ran: {"jax": [...], "port": [...]}."""
    got = {"jax": [], "port": []}
    for side, classes in (("jax", (JSR.BatchedScanRollout, JSR.ScanRollout,
                                   JRW.ScanRandomWalk)),
                          ("port", (TSR.BatchedScanRollout, TSR.ScanRollout,
                                    TRW.ScanRandomWalk))):
        for cls in classes:
            def wrapped(self, *a, _run=cls.run, _side=side, **kw):
                res = _run(self, *a, **kw)
                got[_side].extend(res if isinstance(res, list) else [res])
                return res
            monkeypatch.setattr(cls, "run", wrapped)
    return got


def _same_rollouts(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.coverage_evolution,
                                   w.coverage_evolution, atol=ATOL)
        assert g.n_points == w.n_points
        assert g.cam_positions.shape == w.cam_positions.shape
        np.testing.assert_allclose(g.cam_positions, w.cam_positions,
                                   atol=1e-4)


def _leaves(tree, prefix=""):
    """A nested dict's leaves by their path."""
    if isinstance(tree, dict):
        return {k2: v for k, sub in tree.items()
                for k2, v in _leaves(sub, f"{prefix}/{k}").items()}
    return {prefix: np.asarray(tree)}


def _run_jax(name, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name] + argv)
    _tool(name).main()


def _port_args(argv):
    return argv + ["--device", "cpu", "--dtype", "float32"]


def test_eval_vs_random_r2_matches_jax(small, runs, ckpts, tmp_path,
                                       monkeypatch):
    argv = ["--difficulties", "simple,normal", "--scenes-per-diff", "1",
            "--seeds", "1", "--poses", str(POSES), "--weights", ckpts["a"]]
    _run_jax("eval_vs_random_r2",
             argv + ["--out", str(tmp_path / "jax.json")], monkeypatch)
    want = json.load(open(tmp_path / "jax.json"))
    got = _tool("eval_vs_random_r2_torch").main(
        _port_args(argv + ["--out", str(tmp_path / "port.json")]),
        make_draws=JaxDraws, make_walk_draws=JaxWalkDraws)
    assert json.load(open(tmp_path / "port.json")) == got
    _same_rollouts(runs["port"], runs["jax"])
    assert len(runs["port"]) == 4  # 2 scenes, NBP then the walk
    assert set(got) == set(want)
    assert got["poses"] == want["poses"] == POSES
    assert got["weights_epoch"] == want["weights_epoch"] == 3
    assert set(got["per_scene"]) == set(want["per_scene"])
    for name, w in want["per_scene"].items():
        for key, values in w.items():
            np.testing.assert_allclose(got["per_scene"][name][key], values,
                                       atol=ATOL)
    assert list(got["per_difficulty"]) == ["simple", "normal"]
    for diff, w in want["per_difficulty"].items():
        g = got["per_difficulty"][diff]
        assert set(g) == set(w)
        assert g["nbp_wins"] == w["nbp_wins"]
        for key in ("nbp_auc", "rw_auc", "nbp_final", "rw_final"):
            assert abs(g[key] - w[key]) <= ATOL


def test_compare_ckpts_sequential_matches_jax(small, runs, ckpts, tmp_path,
                                              monkeypatch):
    argv = ["--ckpt-a", ckpts["a"], "--ckpt-b", ckpts["b"],
            "--scenes-per-diff", "1", "--seeds", "1", "--poses", str(POSES),
            "--mode", "sequential"]
    _run_jax("compare_ckpts", argv + ["--out", str(tmp_path / "jax.json")],
             monkeypatch)
    want = json.load(open(tmp_path / "jax.json"))
    got = _tool("compare_ckpts_torch").main(
        _port_args(argv + ["--out", str(tmp_path / "port.json")]),
        make_draws=JaxDraws)
    assert json.load(open(tmp_path / "port.json")) == got
    # 4 difficulties x 2 checkpoints, one ScanRollout run each.
    assert len(runs["port"]) == 8
    _same_rollouts(runs["port"], runs["jax"])
    assert set(got) == set(want)
    assert got["verdict"] == want["verdict"]
    assert (got["epoch_a"], got["epoch_b"]) == (want["epoch_a"],
                                                want["epoch_b"]) == (3, 5)
    for k in ("mean_auc_a", "mean_auc_b"):
        assert abs(got[k] - want[k]) <= ATOL
    assert set(got["per_difficulty"]) == set(want["per_difficulty"])
    for diff, w in want["per_difficulty"].items():
        for k in ("a", "b"):
            assert abs(got["per_difficulty"][diff][k] - w[k]) <= ATOL


def test_compare_ckpts_a_against_a_keeps(small, ckpts, tmp_path, capsys):
    """The gate keeps a checkpoint against itself, the means equal: here a
    per-level candidate whose every level file is missing, so that each
    level scores --ckpt-a (the batched mode's A against A runs on the
    card, chip_smoke.py phase 15)."""
    pattern = str(tmp_path / "nbp_{level}_best_auc.ckpt")
    got = _tool("compare_ckpts_torch").main(_port_args(
        ["--ckpt-a", ckpts["a"], "--ckpt-b-per-level", pattern,
         "--scenes-per-diff", "1", "--seeds", "1", "--poses", "1",
         "--mode", "batched", "--out", str(tmp_path / "cc.json")]))
    assert got["ckpt_b"] == {
        d: f"MISSING {pattern.format(level=d)} -> ckpt_a"
        for d in ("simple", "normal", "hard", "insane")}
    assert got["epoch_b"] == -1
    assert "per-level candidate forces sequential mode" in (
        capsys.readouterr().err)
    assert got["verdict"] == "KEEP"
    assert got["mean_auc_a"] == got["mean_auc_b"] > 0
    for row in got["per_difficulty"].values():
        assert row["a"] == row["b"]


def test_eval101_merges_levels_with_fallback_and_failure(small, ckpts,
                                                         tmp_path,
                                                         monkeypatch):
    """Each level's process runs in-process here (TINY needs the patches):
    a level with its own file, one that falls back to the
    nbp_best_val.ckpt beside the pattern, and, in a directory without
    one, a level that fails and reads FAILED."""
    tool1 = _tool("eval_vs_random_r2_torch")
    eval101 = _tool("eval101_all_torch")
    calls = []

    def run_in_process(cmd, cwd=None):
        calls.append(cmd)
        assert cmd[1].endswith("eval_vs_random_r2_torch.py")
        try:
            tool1.main(cmd[2:])
        except Exception:  # the process would exit non-zero
            return subprocess.CompletedProcess(cmd, 1)
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(eval101.subprocess, "run", run_in_process)
    shutil.copy(ckpts["b"], tmp_path / "nbp_simple_best_auc.ckpt")
    shutil.copy(ckpts["a"], tmp_path / "nbp_best_val.ckpt")
    argv = ["--poses", "2", "--scenes-per-diff", "1", "--seeds", "1",
            "--difficulties", "simple,normal", "--device", "cpu",
            "--dtype", "float32"]
    out = tmp_path / "merged.json"
    merged = eval101.main(argv + ["--weights",
                                  str(tmp_path / "nbp_{level}_best_auc.ckpt"),
                                  "--out", str(out)])
    weights = [c[c.index("--weights") + 1] for c in calls]
    assert weights == [str(tmp_path / "nbp_simple_best_auc.ckpt"),
                       str(tmp_path / "nbp_best_val.ckpt")]
    for c in calls:
        assert c[c.index("--device") + 1] == "cpu"
        assert c[c.index("--dtype") + 1] == "float32"
    assert list(merged["per_difficulty"]) == ["simple", "normal"]
    assert len(merged["per_scene"]) == 2
    assert (merged["poses"], merged["scenes_per_diff"], merged["seeds"]) == (
        2, 1, 1)
    assert merged["weights_epoch"] == 3  # the last level's: the fallback
    assert json.load(open(out)) == merged

    lone = tmp_path / "lone"
    lone.mkdir()
    shutil.copy(ckpts["a"], lone / "nbp_simple.ckpt")
    merged = eval101.main(argv + ["--weights", str(lone / "nbp_{level}.ckpt"),
                                  "--out", str(tmp_path / "m2.json")])
    assert list(merged["per_difficulty"]) == ["simple"]


def test_compare_nbp_vs_random_plots_only_on_request(small, ckpts, tmp_path):
    tool = _tool("compare_nbp_vs_random_torch")
    argv = ["--weights", ckpts["a"], "--poses", "2", "--device", "cpu",
            "--out", str(tmp_path / "nr.json")]
    got = tool.main(argv)
    assert got["weights"] == "trained(e3)"
    assert len(got["nbp"]["coverage_evolution"]) == 2
    assert len(got["random_walk"]["coverage_evolution"]) == 2
    assert os.listdir(tmp_path) == ["nr.json"]
    plot = tmp_path / "curves.png"
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            tool.main(argv + ["--plot", str(plot)])
    else:
        tool.main(argv + ["--plot", str(plot)])
        assert plot.exists()


def test_macarons_e2e_tiny_warm_starts_trains_and_scores(tmp_path, capsys):
    """At --tiny on the CPU: SCONE weights warm-started from checkpoints in
    the flax layout, one training scene, the held-out NBV-vs-random table
    and the trained weights saved where --save says."""
    from nextbestpath_tpu_torch.models.convert import (scone_occ_to_flax,
                                                       scone_vis_to_flax)
    from nextbestpath_tpu_torch.models.macarons import Macarons
    from nextbestpath_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                         save_checkpoint)

    warm = Macarons.create(3, image_height=32, image_width=56)
    for name, to_flax, v in (("occ", scone_occ_to_flax, warm.occ_vars),
                             ("vis", scone_vis_to_flax, warm.vis_vars)):
        save_checkpoint(str(tmp_path / f"warm_{name}.ckpt"),
                        {"params": to_flax(v)})
    got = _tool("macarons_e2e_torch").main(
        ["--device", "cpu", "--tiny", "--train-scenes", "1",
         "--train-poses", "2", "--eval-poses", "1",
         "--eval-scenes-per-diff", "1", "--eval-seeds", "1",
         "--occ-ckpt", str(tmp_path / "warm_occ.ckpt"),
         "--vis-ckpt", str(tmp_path / "warm_vis.ckpt"),
         "--save", str(tmp_path / "trained"),
         "--out", str(tmp_path / "mac.json")])
    err = capsys.readouterr().err
    assert "warm-started occ" in err and "warm-started vis" in err
    assert json.load(open(tmp_path / "mac.json")) == got
    assert list(got["train"]) == ["procgen_simple_8"]
    assert list(got["per_difficulty"]) == ["simple"]
    row = got["per_difficulty"]["simple"]
    assert set(row) == {"nbv_auc", "rw_auc", "nbv_final", "rw_final",
                        "nbv_wins"}
    assert row["nbv_wins"] == (row["nbv_auc"] > row["rw_auc"])
    for scene in got["per_scene"].values():
        assert all(len(v) == 1 and 0 <= v[0] <= 1 for v in scene.values())
    trained = load_checkpoint(str(tmp_path / "trained" / "scone_occ.ckpt"))
    start = load_checkpoint(str(tmp_path / "warm_occ.ckpt"))
    assert _leaves(trained[0]).keys() == _leaves(start[0]).keys()
    assert any(not np.array_equal(v, _leaves(start[0])[k])
               for k, v in _leaves(trained[0]).items())


def test_scan_rollout_past_buffer_capacity_matches_jax():
    """The reference protocol's 101 poses run past the point buffer's
    capacity (pose 66 at full width). At TINY with a 6,000-point buffer,
    20 poses of the port's ScanRollout against the JAX one: both end at
    capacity (the rows past it dropped), with the same trajectory and
    coverage within 1e-3 (the metric's stride sample may fall from one
    pose to the next, on both sides alike)."""
    from nextbestpath_tpu import assets as JA

    from nextbestpath_tpu_torch import assets as TA

    small = dict(TINY, full_pc_capacity=6000)
    jp, tp = JC.default_params(**small), TC.default_params(**small)
    want = JSR.ScanRollout(
        JA.pack_generated_scene(JA.generate_scene("simple", seed=8),
                                params=jp),
        JM.NBP(width=8), _width8_variables(0), params=jp).run(n_poses=20,
                                                              seed=8)
    got = TSR.ScanRollout(
        TA.pack_generated_scene(TA.generate_scene("simple", seed=8),
                                params=tp),
        seeded_nbp(width=8, seed=0), params=tp, make_draws=JaxDraws,
        device="cpu").run(n_poses=20, seed=8)
    _same_rollouts([got], [want])
    assert got.n_points == want.n_points == 6000


def test_scan_rollout_set_scene_matches_a_fresh_rollout():
    """One rollout moved to another same-shape scene runs it as a rollout
    built on that scene does, bit for bit."""
    params = TC.default_params(**TINY)
    a, b = held_out_assets(params, scenes_per_diff=2,
                           difficulties=("simple",))
    torch.manual_seed(0)
    model = TU.NBP(width=8)
    reused = TSR.ScanRollout(a, model, params=params, device="cpu")
    reused.run(n_poses=2, seed=4)
    reused.set_scene(b)
    got = reused.run(n_poses=POSES, seed=4)
    want = TSR.ScanRollout(b, model, params=params, device="cpu").run(
        n_poses=POSES, seed=4)
    assert got.coverage_evolution == want.coverage_evolution
    np.testing.assert_array_equal(got.cam_positions, want.cam_positions)
    assert got.n_points == want.n_points
    hard = held_out_assets(params, scenes_per_diff=1,
                           difficulties=("hard",))[0]
    with pytest.raises(ValueError, match="shapes"):
        reused.set_scene(hard)


@pytest.mark.parametrize("name", TOOLS)
def test_tools_refuse_the_card_without_one(name, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as err:
        _tool(f"{name}_torch").main(["--device", "cuda"])
    assert err.value.code == 2
    assert "cuda" in capsys.readouterr().err
