"""The evaluation entry point's default path: the port's host rollout in
its legacy mode (``shared_rng=False``: sequential draws, the argsort
sampler of the coverage metric), the multi-scene evaluation
``test_nbp_planning`` and the random-walk baseline, against the JAX
package's, with the JAX package's sequential key stream injected
(``JaxSequentialDraws``), on the small config of tests/test_torch_rollout.py.

Planning decisions (the camera trajectory, the point count) must be
identical and the coverage curves within 1e-3.
"""

import json

import jax
import numpy as np
import pytest
import torch

from nextbestpath_tpu.assets import generate_scene, pack_generated_scene
from nextbestpath_tpu.config import default_params
from nextbestpath_tpu.eval import nbp_planning as JE
from nextbestpath_tpu.eval.random_walk import random_walk_rollout as j_walk
from nextbestpath_tpu_torch import assets as TA
from nextbestpath_tpu_torch import config as TC
from nextbestpath_tpu_torch.eval import nbp_planning as TE
from nextbestpath_tpu_torch.eval.random_walk import random_walk_rollout
from nextbestpath_tpu_torch.models.convert import flax_to_state_dict
from nextbestpath_tpu_torch.models.unet import NBP as TorchNBP

from test_torch_rollout import SMALL, _flax_model

COV_ATOL = 1e-3


class JaxSequentialDraws:
    """The JAX legacy rollout's key stream: ``begin_group`` takes the next
    key as ``_next_key()`` does; a substep folds its index in, and
    ``uniforms`` splits the key as the stratified frame draw does."""

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
        return torch.from_numpy(np.array(
            jax.random.uniform(self._key(step), tuple(shape))))

    def uniforms(self, role, shapes, step=None):
        keys = jax.random.split(self._key(step), len(shapes))
        return [torch.from_numpy(np.array(jax.random.uniform(k, tuple(s))))
                for k, s in zip(keys, shapes)]

    def randint(self, role, low, high, step=None):
        return torch.tensor(int(jax.random.randint(
            self._key(step), (), int(low), int(high))))


def _same(got, want):
    assert len(got.coverage_evolution) == len(want.coverage_evolution)
    np.testing.assert_allclose(got.coverage_evolution,
                               want.coverage_evolution, atol=COV_ATOL)
    assert got.n_points == want.n_points
    assert got.cam_positions.shape == want.cam_positions.shape
    np.testing.assert_allclose(got.cam_positions, want.cam_positions,
                               atol=1e-5)
    assert got.auc == pytest.approx(want.auc, abs=COV_ATOL)


def _scenes(difficulty, seed):
    j = pack_generated_scene(generate_scene(difficulty, seed=seed),
                             params=default_params(**SMALL))
    t = TA.pack_generated_scene(TA.generate_scene(difficulty, seed=seed),
                                params=TC.default_params(**SMALL))
    return j, t


def _torch_model(variables):
    m = TorchNBP()
    m.load_state_dict(flax_to_state_dict(variables["params"],
                                         variables["batch_stats"]))
    return m


@pytest.fixture(scope="module")
def flax_model():
    return _flax_model()


# ("normal", 3) over 8 poses regenerates the plan and memoises
# first-segment collisions, so each retry's fresh key is held too.
@pytest.mark.parametrize("difficulty,scene_seed,n_poses",
                         [("simple", 4, 4), ("normal", 3, 8)])
def test_legacy_rollout_matches_jax(flax_model, difficulty, scene_seed,
                                    n_poses):
    model, variables = flax_model
    j_assets, t_assets = _scenes(difficulty, scene_seed)
    want = JE.NBPPlanningRollout(j_assets, model, variables,
                                 params=default_params(**SMALL),
                                 seed=8).run(n_poses=n_poses)
    draws = JaxSequentialDraws(8)
    roll = TE.NBPPlanningRollout(t_assets, _torch_model(variables),
                                 params=TC.default_params(**SMALL),
                                 draws=draws, device="cpu")
    assert not roll.shared_rng and roll.max_plan_retries == 8
    _same(roll.run(n_poses=n_poses), want)
    # The groups: the initial capture, then cov, obs, a plan group an
    # attempt, rot or rot2 when taken, and move, in that order.
    assert draws.groups[:3] == ["init", "cov", "obs"]
    assert draws.groups.count("cov") == n_poses
    assert draws.groups.count("move") == n_poses
    assert "plan" in draws.groups


def test_random_walk_matches_jax():
    j_assets, t_assets = _scenes("simple", 4)
    want = j_walk(j_assets, params=default_params(**SMALL), n_poses=6,
                  seed=5)
    got = random_walk_rollout(t_assets, params=TC.default_params(**SMALL),
                              n_poses=6, seed=5,
                              draws=JaxSequentialDraws(5), device="cpu")
    _same(got, want)
    assert max(got.coverage_evolution[1:]) > got.coverage_evolution[0]


def test_random_walk_default_draws_repeat():
    _, t_assets = _scenes("simple", 4)
    runs = [random_walk_rollout(t_assets, params=TC.default_params(**SMALL),
                                n_poses=3, seed=2, device="cpu")
            for _ in range(2)]
    assert runs[0].coverage_evolution == runs[1].coverage_evolution
    np.testing.assert_array_equal(runs[0].cam_positions,
                                  runs[1].cam_positions)


def test_nbp_planning_matches_jax(flax_model, tmp_path, capsys):
    """The multi-scene evaluation over two scenes writes the JAX one's
    results JSON: the same scene names and keys, the same trajectories, the
    coverage and AUC within 1e-3; and prints a line a scene."""
    model, variables = flax_model
    pairs = [_scenes("simple", 4), _scenes("normal", 3)]
    j_path, t_path = tmp_path / "jax.json", tmp_path / "torch.json"
    JE.test_nbp_planning([j for j, _ in pairs], model, variables,
                         params=default_params(**SMALL), n_poses=3,
                         results_path=str(j_path), seed=8, verbose=False)
    TE.test_nbp_planning([t for _, t in pairs], _torch_model(variables),
                         params=TC.default_params(**SMALL), n_poses=3,
                         results_path=str(t_path), seed=8, verbose=True,
                         device="cpu", make_draws=JaxSequentialDraws)
    want, got = json.loads(j_path.read_text()), json.loads(t_path.read_text())
    assert list(got) == list(want) and len(got) == 2
    for name in want:
        assert set(got[name]) == set(want[name])
        np.testing.assert_allclose(got[name]["coverage_evolution"],
                                   want[name]["coverage_evolution"],
                                   atol=COV_ATOL)
        assert got[name]["auc"] == pytest.approx(want[name]["auc"],
                                                 abs=COV_ATOL)
        np.testing.assert_allclose(got[name]["cam_positions"],
                                   want[name]["cam_positions"], atol=1e-5)
        assert got[name]["steps_per_sec"] > 0
    out = capsys.readouterr().out
    assert all(f"{name}: final coverage" in out for name in want)
