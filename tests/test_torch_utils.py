"""The port's utilities against the JAX package's: the learning-rate
schedules, the phase timers and the profiler hook, the debug aids
(anomaly mode, gradient checks, the loss-spike guard), the array loader
and the plotting and export helpers.

Tolerances, and why: the schedules within 1e-6 relative (f32 powers in
another library); counts, batches, rollback decisions and exported files
exact.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextbestpath_tpu.utils import debugging as JD
from nextbestpath_tpu.utils import fastloader as JF
from nextbestpath_tpu.utils import plotting as JP
from nextbestpath_tpu.utils import schedules as JS
from nextbestpath_tpu.utils import timing as JT
from nextbestpath_tpu_torch.utils import debugging as TD
from nextbestpath_tpu_torch.utils import fastloader as TF
from nextbestpath_tpu_torch.utils import plotting as TP
from nextbestpath_tpu_torch.utils import schedules as TS
from nextbestpath_tpu_torch.utils import timing as TT

STEPS = [0, 1, 2, 10, 99, 100, 101, 4000, 123456]


@pytest.mark.parametrize("name,args", [
    ("noam_schedule", (512, 4000, 2.0)),
    ("warmup_constant_schedule", (1e-3, 100)),
    ("warmup_exponential_schedule", (1e-3, 100, 0.999))])
def test_schedules_match_jax(name, args):
    """A host step gives a float, a tensor of steps a tensor."""
    j, t = getattr(JS, name)(*args), getattr(TS, name)(*args)
    for s in STEPS:
        got = t(s)
        assert isinstance(got, float)
        assert got == pytest.approx(float(j(s)), rel=1e-6)
    got = t(torch.tensor(STEPS))
    want = np.asarray(j(jnp.asarray(STEPS)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_phase_timers_and_time_check():
    """The report's layout is the JAX timers'; ``block`` waits for the
    device where there is one."""
    t = TT.PhaseTimers()
    for _ in range(3):
        with t.phase("a", block=True):
            torch.ones(10).sum()
    with t.phase("b"):
        pass
    j = JT.PhaseTimers()
    for _ in range(3):
        with j.phase("a"):
            pass
    with j.phase("b"):
        pass
    rep = t.report()
    assert sorted(rep) == sorted(j.report()) == ["a", "b"]
    assert sorted(rep["a"]) == sorted(j.report()["a"])
    assert t.counts["a"] == 3 and rep["a"]["mean_s"] >= 0.0
    tc = TT.TimeCheck()
    assert abs(tc.current_time()) < 1e-3
    tc.start()
    assert tc.current_time() >= 0.0


def test_profiler_trace_writes_a_trace(tmp_path):
    with TT.profiler_trace(None):
        torch.ones(3).sum()
    with TT.profiler_trace(str(tmp_path)):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = os.listdir(tmp_path)
    assert files and all(f.endswith(".json") for f in files)


def test_anomaly_detection_raises_on_nan_backward():
    x = torch.tensor([-1.0], requires_grad=True)
    with TD.anomaly_detection(False):
        torch.sqrt(x).sum().backward()
    assert torch.isnan(x.grad).all()
    x.grad = None
    with pytest.raises(RuntimeError, match="nan"):
        with TD.anomaly_detection(True):
            torch.sqrt(x).sum().backward()


def test_check_gradients_matches_jax(capsys):
    rng = np.random.default_rng(0)
    grads = {"a": rng.normal(size=(3, 4)).astype(np.float32),
             "b": np.zeros(5, np.float32),
             "c": np.asarray([1.0, np.nan, -7.5], np.float32)}
    want = JD.check_gradients({k: jnp.asarray(v) for k, v in grads.items()},
                              verbose=False)
    got = TD.check_gradients({k: torch.from_numpy(v)
                              for k, v in grads.items()})
    assert "NaN gradient at c" in capsys.readouterr().out
    assert {k: got[k] for k in ("n_leaves", "n_nan", "n_zero")} == {
        k: want[k] for k in ("n_leaves", "n_nan", "n_zero")}
    assert np.isnan(got["max_abs"]) == np.isnan(want["max_abs"])
    # Named pairs, a missing gradient skipped.
    m = torch.nn.Linear(3, 2)
    m(torch.ones(1, 3)).sum().backward()
    m.bias.grad = None
    rep = TD.check_gradients(((n, p.grad) for n, p in m.named_parameters()),
                             verbose=False)
    assert rep["n_leaves"] == 1 and rep["max_abs"] == 1.0


def test_bad_loss_guard_matches_jax_and_keeps_a_clone():
    """The same rollback decisions over a loss sequence with a spike; the
    kept state is a copy, so a later in-place step does not reach it."""
    losses = [1.0, 1.1, 0.9, 1.0, 50.0, 1.0, 0.95, 30.0]
    j, t = JD.BadLossGuard(10.0, 3), TD.BadLossGuard(10.0, 3)
    model = torch.nn.Linear(2, 2)
    for i, loss in enumerate(losses):
        state = model.state_dict()
        kept, rolled = t.update(loss, state)
        assert rolled == j.update(loss, {"i": i})[1]
        if rolled:
            assert kept is t.last_good and not torch.equal(
                kept["weight"], model.weight.detach())
            model.load_state_dict(kept)
        else:
            assert kept is state
            good = t.last_good["weight"].clone()
            with torch.no_grad():
                model.weight.add_(1.0)
            assert torch.equal(t.last_good["weight"], good)
    assert t.history == j.history


@pytest.mark.parametrize("shuffle,drop_last", [(True, False), (False, True),
                                               (True, True)])
def test_fast_array_loader_matches_jax(shuffle, drop_last):
    a = np.arange(23)
    b = np.arange(46).reshape(23, 2)
    kw = dict(batch_size=5, shuffle=shuffle, seed=3, drop_last=drop_last)
    j, t = JF.FastArrayLoader(a, b, **kw), TF.FastArrayLoader(a, b, **kw)
    assert len(t) == len(j)
    for _ in range(2):
        for (ta, tb), (ja, jb) in zip(t, j, strict=True):
            np.testing.assert_array_equal(ta, ja)
            np.testing.assert_array_equal(tb, jb)


def test_plotting_and_blender_export_match_jax(tmp_path):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(1)
    pts = rng.random((50, 3)).astype(np.float32)
    traj = rng.random((4, 3)).astype(np.float32)
    for mod, d in ((TP, tmp_path / "t"), (JP, tmp_path / "j")):
        mod.export_blender_json(str(d), pts, traj, scene_name="s",
                                start_index=2)
    for f in ("point_cloud.json", "trajectory.json"):
        with open(tmp_path / "t" / f) as a, open(tmp_path / "j" / f) as b:
            assert json.load(a) == json.load(b)
    TP.plot_point_cloud(pts, str(tmp_path / "p" / "pc.png"), title="pc")
    TP.plot_value_map(rng.random((8, 8, 8)), str(tmp_path / "p" / "vm.png"))
    TP.plot_coverage_curves({"a": [0.1, 0.4]}, str(tmp_path / "p" / "c.png"))
    assert sorted(os.listdir(tmp_path / "p")) == ["c.png", "pc.png",
                                                  "vm.png"]
