"""Whole runs of each cell at CPU sizes (``tiny.py``), past the harness's
look for a card: a sound run is correct; the control (the reference one
precision lower in the program's place) fails a number; and with the
timed path broken underneath (a step that leaves its state unchanged,
half of the batch left out, an answer altered where it is made) the run
is not correct."""

import json

import pytest
import torch

from nbp_bench import run
from nbp_bench.tests.tiny import tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(str(tmp_path_factory.mktemp("bench")))


def _run(root, capsys, cell, seed, control=0):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.5", "--trace", "0", "--control", str(control)],
                  device="cpu", root=root)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["walk_simple_b4", "train_b56"])
def test_sound_run_is_correct_and_the_control_is_not(root, capsys, cell):
    line = _run(root, capsys, cell, 2 ** 31 + 11, control=1)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    # The harness's own verdict with the control (and, in training, the
    # half-batch fault) in the program's place.
    verdicts = line["control_correct"]
    assert verdicts["control"] is False, line
    if cell == "train_b56":
        assert verdicts == {"control": False, "half_batch": False}, line


def _broken_rollouts(monkeypatch, fault):
    from nextbestpath_tpu_torch.eval import random_walk as W
    from nextbestpath_tpu_torch.eval import scan_rollout as S

    if fault == "state_unchanged":
        monkeypatch.setattr(W.ScanRandomWalk, "_pose_step",
                            lambda self: None)
    elif fault == "half_batch":
        real = S.capture_depth_scenes

        def half(tri_soas, n_tris, poses5, intr):
            zb, R, T = real(tri_soas, n_tris, poses5, intr)
            zb = zb.clone()
            zb[zb.shape[0] // 2:] = -1.0
            return zb, R, T
        monkeypatch.setattr(S, "capture_depth_scenes", half)
    else:
        real = W.coverage_percentage_scenes
        monkeypatch.setattr(W, "coverage_percentage_scenes",
                            lambda *a, **k: real(*a, **k) + 0.01)


def _broken_training(monkeypatch, fault):
    from nextbestpath_tpu_torch.train import train_nbp as T

    if fault == "state_unchanged":
        monkeypatch.setattr(torch.optim.AdamW, "step",
                            lambda self, closure=None: None)
    elif fault == "half_batch":
        real = T._loss_and_grads

        def half(model, ds, idx, sw):
            sw = sw.clone()
            sw[sw.shape[0] // 2:] = 0.0
            return real(model, ds, idx, sw)
        monkeypatch.setattr(T, "_loss_and_grads", half)
    else:
        real = T.nbp_loss
        monkeypatch.setattr(T, "nbp_loss",
                            lambda *a, **k: real(*a, **k) * 1.5)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
@pytest.mark.parametrize("cell", ["walk_simple_b4", "train_b56"])
def test_broken_timed_path_is_not_correct(root, capsys, monkeypatch, cell,
                                          fault):
    if cell == "train_b56":
        _broken_training(monkeypatch, fault)
    else:
        _broken_rollouts(monkeypatch, fault)
    line = _run(root, capsys, cell, 97)
    assert not line["correct"], line["checks"]
