"""The port's training entry points on the CPU: the epoch driver
``train/driver.py::run_training_nbp`` and the root ``train_nbp_torch.py``
(through ``main(argv)``), on temporary paths at a small config. Their
checkpoints are read by the JAX package's loader and equal the trained
model; their replay store by the JAX ``ReplayDB``. The trainer imports
nothing of JAX; the card is refused when absent."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextbestpath_tpu.models import NBP as FlaxNBP
from nextbestpath_tpu.train.replay import ReplayDB as JReplayDB
from nextbestpath_tpu.utils.checkpoint import load_checkpoint as j_load
from nextbestpath_tpu_torch import assets as TA
from nextbestpath_tpu_torch import config as TC
from nextbestpath_tpu_torch.models.convert import state_dict_to_flax
from nextbestpath_tpu_torch.train.driver import (run_training_nbp,
                                                 seeded_train_model)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import train_nbp_torch as cli  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the tier-1 run puts several test processes on
    the machine's cores, where PyTorch's default (one thread a core) makes
    each small operation wait on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _jax_read(path, width=8, size=64):
    template = FlaxNBP(width=width).init(jax.random.PRNGKey(0),
                                         jnp.zeros((1, size, size, 5)),
                                         train=True)
    variables, _, epoch, _ = j_load(path, template)
    return jax.tree_util.tree_map(np.asarray, variables), epoch


def _assert_equal_trees(got, want):
    g = jax.tree_util.tree_leaves_with_path(got)
    w = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(g) == len(w)
    for k, v in g:
        np.testing.assert_array_equal(v, w[k], err_msg=jax.tree_util.keystr(k))


def test_run_training_nbp_writes_what_jax_reads(tmp_path):
    """Three epochs on simple/4 (epoch 0 collects and splits validation,
    epoch 1 trains on nothing, its pool skipping poses <= 10, epoch 2 on
    everything): the best-val and every-epoch checkpoints, the loss log
    and the replay store."""
    params = TC.default_params(**cli.QUICK, save_model_every_n_epoch=1)
    scene = TA.pack_generated_scene(TA.generate_scene("simple", seed=4),
                                    params=params)
    wdir, ldir = tmp_path / "w", tmp_path / "log"
    db = tmp_path / "db" / "replay.npz"
    state = run_training_nbp([scene], params=params, epochs=3, n_poses=6,
                             db_path=str(db), weights_dir=str(wdir),
                             log_dir=str(ldir), seed=5, verbose=False,
                             device="cpu", model=seeded_train_model(5, 8))
    assert state.optimizer.state  # the optimizer stepped
    assert sorted(os.listdir(wdir)) == ["nbp_best_val.ckpt",
                                        "nbp_epoch_1.ckpt", "nbp_epoch_2.ckpt"]
    log = json.loads((ldir / "nbp_loss.json").read_text())
    assert len(log["train"]) == len(log["val"]) == 2
    assert log["train"][0] == 0.0 and log["train"][1] > 0.0
    assert len(log["coverage_after_trajectory"]) == 3
    assert all(np.isfinite(log["val"]))
    variables, epoch = _jax_read(str(wdir / "nbp_epoch_2.ckpt"))
    assert epoch == 2
    p, s = state_dict_to_flax(state.model.state_dict())
    _assert_equal_trees(variables, {"params": p, "batch_stats": s})
    jdb = JReplayDB(str(db))
    assert len(jdb) > 0 and jdb.entries[0].model_input.shape == (5, 64, 64)


def test_cli_trains_on_tmp_paths(tmp_path, capsys):
    args = ["--device", "cpu", "--quick", "--procgen", "simple",
            "--epochs", "2", "--poses", "4", "--seed", "3",
            "--weights-dir", str(tmp_path / "w"), "--log-dir",
            str(tmp_path / "log"), "--db", str(tmp_path / "replay.npz")]
    assert cli.main(args) == 0
    out = capsys.readouterr().out
    assert "=== epoch 1 ===" in out and "inner epoch 5" in out
    variables, epoch = _jax_read(str(tmp_path / "w" / "nbp_best_val.ckpt"))
    assert epoch == 1 and "log_vars" in variables["params"]
    assert (tmp_path / "log" / "nbp_loss.json").exists()


def test_cli_refuses_cuda_without_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert cli.main(["--procgen", "simple", "--epochs", "1"]) == 2
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err


def test_trainer_imports_nothing_of_jax():
    """Import the trainer's modules and the CLI and take one micro step on
    the CPU with jax, flax, optax and the JAX package blocked from import."""
    code = r"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "msgpack",
                                  "nextbestpath_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import numpy as np, torch
torch.set_num_threads(2)
import train_nbp_torch
from nextbestpath_tpu_torch.ops import obstacle_map
from nextbestpath_tpu_torch.train import collection, driver, replay, train_nbp
model = driver.seeded_train_model(0, width=4)
state = train_nbp.init_train_state(model, accumulation_steps=1)
e = replay.Experience(np.ones((5, 32, 32), np.float16),
                      np.zeros((32, 32), np.uint8),
                      np.array([[1, 2, 3]], np.int32),
                      np.array([0.5], np.float32), 12)
ds, n = train_nbp.build_device_dataset([e, e], torch.device("cpu"))
w0 = model.final1.weight.detach().clone()
loss = train_nbp._train_step_ds(state, ds, torch.tensor([0, 1]), torch.ones(2))
assert torch.isfinite(loss) and not torch.equal(w0, model.final1.weight)
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "flax", "optax", "nextbestpath_tpu")]
assert not bad, bad
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
