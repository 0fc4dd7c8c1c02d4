"""The port's evaluation CLI, ``test_nbp_planning_torch.py``, run in-process
on the CPU through ``main(argv)``: the legacy host path and ``--scan``
write the JAX CLI's results JSON (a scene name each, with its coverage
evolution, AUC, camera positions, wall time and poses a second); a config
tree resolves its ``test_scenes`` spec and its weights; a missing weights
file warns and falls back to random weights; the card is refused when
absent."""

import json
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import test_nbp_planning_torch as cli  # noqa: E402

KEYS = {"coverage_evolution", "auc", "cam_positions", "wall_time_s",
        "steps_per_sec"}


def _run(argv, tmp_path, capsys, name="out.json"):
    out = tmp_path / name
    assert cli.main(argv + ["--device", "cpu", "--out", str(out)]) == 0
    return json.loads(out.read_text()), capsys.readouterr().out


@pytest.mark.parametrize("scan", [False, True], ids=["host", "scan"])
def test_cli_quick_procgen(tmp_path, capsys, monkeypatch, scan):
    monkeypatch.chdir(REPO)
    res, out = _run(["--quick", "--poses", "2", "--procgen", "simple"]
                    + (["--scan"] if scan else []), tmp_path, capsys)
    assert list(res) == ["procgen_simple_8"]
    r = res["procgen_simple_8"]
    assert set(r) == KEYS
    assert len(r["coverage_evolution"]) == 2
    assert all(0.0 <= c <= 1.0 for c in r["coverage_evolution"])
    assert len(r["cam_positions"]) == 4 * 3 and r["steps_per_sec"] > 0
    assert "# loaded weights/nbp/nbp_best_val.ckpt (epoch 4)" in out
    assert "procgen_simple_8: final coverage" in out


def test_cli_config_tree(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(REPO)
    res, out = _run(["-c", "configs/test/test_via_nbp_model_simple.json",
                     "--quick", "--poses", "1"], tmp_path, capsys)
    # test_scenes ["procgen:simple:1"]: held-out seed 8 + 900.
    assert list(res) == ["procgen_simple_908"]
    assert set(res["procgen_simple_908"]) == KEYS
    assert "# loaded weights/nbp/nbp_best_val.ckpt (epoch 4)" in out


def test_cli_missing_weights_and_two_scenes(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    res, out = _run(["--quick", "--poses", "1", "--procgen", "simple,normal",
                     "--weights", "nope.ckpt"], tmp_path, capsys)
    assert "# WARNING: weights nope.ckpt not found, using random init" in out
    assert list(res) == ["procgen_simple_8", "procgen_normal_9"]


def test_cli_refuses_cuda_without_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert cli.main(["--quick", "--poses", "1"]) == 2
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err
