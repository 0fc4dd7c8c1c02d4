"""The slice as a whole: the PyTorch port's planning rollout against the
JAX host rollout (``shared_rng=True``) with the JAX draws injected, on the
small config of tests/test_scan_vs_host.py (32x56 frames, 64^2 maps, the
full-width NBP with random weights and the obstacle decoder opened).

Planning decisions (the camera trajectory, the point count) must be
identical and the coverage curves within 1e-3. Also: scenes are
byte-identical, the package imports nothing of JAX, and entry points refuse
CUDA without a card.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextbestpath_tpu.assets import generate_scene, pack_generated_scene
from nextbestpath_tpu.config import default_params
from nextbestpath_tpu.eval.nbp_planning import NBPPlanningRollout
from nextbestpath_tpu.models import NBP
from nextbestpath_tpu_torch import assets as TA
from nextbestpath_tpu_torch import config as TC
from nextbestpath_tpu_torch.draws import TorchDraws
from nextbestpath_tpu_torch.eval.nbp_planning import \
    NBPPlanningRollout as TorchRollout
from nextbestpath_tpu_torch.models.convert import flax_to_state_dict
from nextbestpath_tpu_torch.models.unet import NBP as TorchNBP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(image_height=32, image_width=56, points_per_frame=256,
             full_pc_capacity=65536, n_gt_surface_points=2048, max_path_len=32,
             pc2img_size=[64, 64], value_map_size=[16, 16])
COV_ATOL = 1e-3


class JaxDraws:
    """The JAX host rollout's key schedule in shared_rng mode, served by
    role: one split for the initial capture, then a 7-way split per pose;
    substeps and the stride draw fold their index in."""

    ROLES = ("cov", "obs", "rot", "rot2", "move", "plan")

    def __init__(self, seed):
        self.key, k_init = jax.random.split(jax.random.PRNGKey(seed))
        self.roles = {"init": k_init}

    def begin_pose(self):
        keys = jax.random.split(self.key, 7)
        self.key = keys[0]
        self.roles = dict(zip(self.ROLES, keys[1:]))

    def _key(self, role, step):
        k = self.roles[role]
        return k if step is None else jax.random.fold_in(k, step)

    def uniform(self, role, shape, step=None):
        return torch.from_numpy(np.array(
            jax.random.uniform(self._key(role, step), tuple(shape))))

    def uniforms(self, role, shapes, step=None):
        keys = jax.random.split(self._key(role, step), len(shapes))
        return [torch.from_numpy(np.array(jax.random.uniform(k, tuple(s))))
                for k, s in zip(keys, shapes)]

    def randint(self, role, low, high, step=None):
        return torch.tensor(int(jax.random.randint(
            self._key(role, step), (), int(low), int(high))))


def _flax_model():
    model = NBP()
    variables = jax.jit(lambda k, x: model.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 5)))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    params = {k: dict(v) for k, v in params.items() if k != "log_vars"}
    params["log_vars"] = np.zeros(2, np.float32)
    params["final2"] = {"Conv_0": dict(params["final2"]["Conv_0"])}
    params["final2"]["Conv_0"]["bias"] = params["final2"]["Conv_0"]["bias"] - 4.0
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    return model, {"params": params, "batch_stats": stats}


@pytest.mark.parametrize("difficulty,seed", [("simple", 4), ("simple", 8),
                                             ("normal", 3)])
def test_scenes_are_byte_identical(difficulty, seed):
    p = default_params(**SMALL)
    a = pack_generated_scene(generate_scene(difficulty, seed=seed), params=p)
    b = TA.pack_generated_scene(TA.generate_scene(difficulty, seed=seed),
                                params=TC.default_params(**SMALL))
    assert a.tris.tobytes() == b.tris.tobytes()
    assert a.gt_surface.tobytes() == b.gt_surface.tobytes()
    assert (a.n_tris, a.pose_l, a.pose_h, a.n_azim) == (b.n_tris, b.pose_l,
                                                        b.pose_h, b.n_azim)
    np.testing.assert_array_equal(a.start_cam_idx, b.start_cam_idx)
    np.testing.assert_array_equal(a.pose_origin, b.pose_origin)


def test_default_scene_sizes():
    a = TA.pack_generated_scene(TA.generate_scene("simple", seed=8))
    assert (a.n_tris, a.tris.shape[0]) == (252, 512)
    assert (a.pose_l, a.pose_h, a.n_azim) == (17, 17, 8)
    assert a.gt_surface.shape == (20000, 3)


def test_main_path_setup():
    """The configuration the card smoke and the profiler share: the simple/8
    scene at the default config and a repeatable full-width seeded NBP with
    its obstacle decoder opened."""
    from nextbestpath_tpu_torch.eval.nbp_planning import (main_path_setup,
                                                          seeded_nbp)

    params, assets, model = main_path_setup()
    assert (params.image_height, params.image_width) == (256, 456)
    assert (assets.n_tris, assets.tris.shape[0]) == (252, 512)
    assert assets.gt_surface.shape == (20000, 3)
    torch.manual_seed(0)
    fresh = TorchNBP()
    torch.testing.assert_close(model.final2.bias, fresh.final2.bias - 4.0,
                               rtol=0, atol=0)
    again = seeded_nbp()
    for k, v in model.state_dict().items():
        assert torch.equal(v, again.state_dict()[k]), k


# ("normal", 3) over 8 poses regenerates the plan 6 times and memoises
# first-segment collisions, so the retry loop is held to the reference too.
@pytest.mark.parametrize("difficulty,scene_seed,n_poses",
                         [("simple", 4, 4), ("normal", 3, 8)])
def test_rollout_matches_jax_host_rollout(difficulty, scene_seed, n_poses):
    params = default_params(**SMALL)
    assets = pack_generated_scene(generate_scene(difficulty, seed=scene_seed),
                                  params=params)
    model, variables = _flax_model()
    host = NBPPlanningRollout(assets, model, variables, params=params, seed=8,
                              shared_rng=True, max_plan_retries=8)
    want = host.run(n_poses=n_poses)

    t_assets = TA.pack_generated_scene(
        TA.generate_scene(difficulty, seed=scene_seed),
        params=TC.default_params(**SMALL))
    t_model = TorchNBP()
    t_model.load_state_dict(flax_to_state_dict(variables["params"],
                                               variables["batch_stats"]))
    roll = TorchRollout(t_assets, t_model, params=TC.default_params(**SMALL),
                        draws=JaxDraws(8), shared_rng=True,
                        max_plan_retries=8, device="cpu")
    got = roll.run(n_poses=n_poses)

    assert len(got.coverage_evolution) == n_poses
    np.testing.assert_allclose(got.coverage_evolution, want.coverage_evolution,
                               atol=COV_ATOL)
    assert got.n_points == want.n_points
    assert got.cam_positions.shape == want.cam_positions.shape
    np.testing.assert_allclose(got.cam_positions, want.cam_positions, atol=1e-5)
    assert got.auc == pytest.approx(want.auc, abs=COV_ATOL)
    # The stride subsample can dip for a pose (a stride sharing a factor
    # with the count revisits slots), in both packages alike.
    assert max(got.coverage_evolution[1:]) > got.coverage_evolution[0]


@pytest.mark.slow
def test_rollout_matches_jax_host_rollout_full_width():
    """The main path's configuration (eval.nbp_planning.main_path_setup:
    simple/8 at default_params(), 256x456 frames, 2M point capacity, 20000
    GT points, 6144 points a frame) for 2 poses against the JAX host rollout,
    with the same tolerances as the small config."""
    from nextbestpath_tpu_torch.eval.nbp_planning import (MAIN_PATH_SEED,
                                                          main_path_setup)

    n_poses = 2
    t_params, t_assets, _ = main_path_setup()
    params = default_params()
    assets = pack_generated_scene(generate_scene("simple", seed=MAIN_PATH_SEED),
                                  params=params)
    assert (params.image_height, params.image_width) == (
        t_params.image_height, t_params.image_width) == (256, 456)
    assert assets.tris.tobytes() == t_assets.tris.tobytes()
    model, variables = _flax_model()
    host = NBPPlanningRollout(assets, model, variables, params=params,
                              seed=MAIN_PATH_SEED, shared_rng=True,
                              max_plan_retries=8)
    want = host.run(n_poses=n_poses)

    t_model = TorchNBP()
    t_model.load_state_dict(flax_to_state_dict(variables["params"],
                                               variables["batch_stats"]))
    roll = TorchRollout(t_assets, t_model, params=t_params,
                        draws=JaxDraws(MAIN_PATH_SEED), shared_rng=True,
                        max_plan_retries=8, device="cpu")
    got = roll.run(n_poses=n_poses)

    assert len(got.coverage_evolution) == n_poses
    np.testing.assert_allclose(got.coverage_evolution, want.coverage_evolution,
                               atol=COV_ATOL)
    assert got.n_points == want.n_points
    assert got.cam_positions.shape == want.cam_positions.shape
    np.testing.assert_allclose(got.cam_positions, want.cam_positions, atol=1e-5)


def test_rollout_default_draws_run_and_repeat():
    """The port's own provider: two runs from one seed agree exactly."""
    params = TC.default_params(**SMALL)
    t_assets = TA.pack_generated_scene(TA.generate_scene("simple", seed=4),
                                       params=params)
    torch.manual_seed(0)
    m = TorchNBP(width=8)
    runs = [TorchRollout(t_assets, m, params=params, seed=3, shared_rng=True,
                         device="cpu").run(n_poses=3) for _ in range(2)]
    assert runs[0].coverage_evolution == runs[1].coverage_evolution
    np.testing.assert_array_equal(runs[0].cam_positions, runs[1].cam_positions)
    assert all(0.0 <= c <= 1.0 for c in runs[0].coverage_evolution)


def test_torch_draws_randint_range():
    d = TorchDraws(0, torch.device("cpu"))
    vals = [int(d.randint("cov", 1, torch.tensor(5))) for _ in range(200)]
    assert min(vals) == 1 and max(vals) == 4
    assert d.uniform("obs", (3, 4)).shape == (3, 4)


def test_rollout_turns_tf32_off():
    """The rollout's U-Net runs its convolutions with cuDNN's TF32 off
    whatever the caller set, so no caller runs them in TF32 against the f32
    reference by omission, and the caller's flags are back after the run
    (the card twin is in tests/test_torch_kernels.py)."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        params = TC.default_params(**SMALL)
        a = TA.pack_generated_scene(TA.generate_scene("simple", seed=4),
                                    params=params)
        model = TorchNBP(width=4)
        seen = []
        model.conv_blocks[0].register_forward_pre_hook(
            lambda *_: seen.append(torch.backends.cudnn.allow_tf32))
        TorchRollout(a, model, params=params, shared_rng=True,
                     device="cpu").run(n_poses=1)
        assert seen and not any(seen)
        assert torch.backends.cudnn.allow_tf32 is True
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def test_cuda_requested_without_card_raises():
    from nextbestpath_tpu_torch.device import resolve_device

    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device()
        with pytest.raises(RuntimeError):
            TorchRollout(None, TorchNBP(width=4))


def test_port_imports_nothing_of_jax():
    """Import the port (the scan rollout, BN folding, the planner, the
    profiler, the checkpoint reader, the held-out recipe, the random walk,
    bench_torch.py and test_nbp_planning_torch.py among it), render a tiny
    frame and read the committed checkpoint with jax, flax, msgpack and the
    JAX package blocked from import."""
    code = r"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "msgpack",
                                  "nextbestpath_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import torch
import nextbestpath_tpu_torch
from nextbestpath_tpu_torch.eval import nbp_planning
from nextbestpath_tpu_torch.models import convert, unet
from nextbestpath_tpu_torch import kernels
from nextbestpath_tpu_torch.ops.raytrace import render_depth, tris_to_soa
from nextbestpath_tpu_torch.geometry.cameras import CameraIntrinsics, get_camera_RT
from nextbestpath_tpu_torch.assets import generate_scene, pack_generated_scene
from nextbestpath_tpu_torch.eval import scan_rollout
from nextbestpath_tpu_torch.models import fold
from nextbestpath_tpu_torch.planning import grid_paths
from nextbestpath_tpu_torch.ops import scatter2d
from nextbestpath_tpu_torch import profile_rollout
from nextbestpath_tpu_torch.utils import checkpoint
from nextbestpath_tpu_torch.eval import heldout, random_walk
import bench_torch
import test_nbp_planning_torch
a = pack_generated_scene(generate_scene("simple", seed=1))
R, T = get_camera_RT(torch.tensor([[7.5, 3.3, 7.5]]), torch.tensor([[0.0, 0.0]]))
z = render_depth(tris_to_soa(torch.from_numpy(a.tris)), a.n_tris, R[0], T[0],
                 CameraIntrinsics(8, 12))
assert (z > 0).all(), z
v, _, epoch, _ = checkpoint.load_checkpoint("weights/nbp/nbp_best_val.ckpt")
assert epoch == 4 and len(v["params"]) > 20
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "flax", "msgpack", "nextbestpath_tpu")]
assert not bad, bad
print("ok")
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_chip_smoke_refuses_without_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without a card,
    and alone in a directory without the package."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and '"ok"' not in out.stdout
