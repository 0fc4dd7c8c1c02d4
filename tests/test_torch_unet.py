"""NBP U-Net of the PyTorch port against flax ``apply``, through
``models/convert.py``. f32 on the CPU; outputs agree to atol 1e-4 (convolution
sums run in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextbestpath_tpu.models import NBP as FlaxNBP
from nextbestpath_tpu_torch.models.convert import flax_to_state_dict
from nextbestpath_tpu_torch.models.unet import NBP

ATOL = 1e-4


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb_stats(stats, seed):
    """Non-trivial running statistics, so that eval-mode BN is exercised."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(stats)
    leaves = [(rng.uniform(0.5, 2.0, x.shape) if x.min() > 0.5
               else rng.normal(0, 0.1, x.shape)).astype(np.float32)
              for x in leaves]
    return jax.tree_util.tree_unflatten(treedef, leaves)


@pytest.mark.parametrize("size", [32, 64])
def test_nbp_width8_matches_flax(size):
    fm = FlaxNBP(width=8)
    x = np.random.default_rng(0).random((2, size, size, 5)).astype(np.float32)
    variables = fm.init(jax.random.PRNGKey(1), jnp.zeros((1, size, size, 5)))
    params = _to_numpy(variables["params"])
    stats = _perturb_stats(_to_numpy(variables["batch_stats"]), 2)
    v_j, o_j = fm.apply({"params": params, "batch_stats": stats},
                        jnp.asarray(x), train=False)
    tm = NBP(width=8)
    missing = tm.load_state_dict(flax_to_state_dict(params, stats), strict=True)
    assert not missing.missing_keys and not missing.unexpected_keys
    tm.eval()
    with torch.no_grad():
        v_t, o_t = tm(torch.from_numpy(x))
    assert v_t.shape == (2, size // 4, size // 4, 8)
    assert o_t.shape == (2, size, size, 1)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=ATOL)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=ATOL)


def test_full_width_names_and_shapes_map():
    """Every tensor of the full-width port gets a flax tensor of its shape
    (shapes only: jax.eval_shape, no forward pass)."""
    fm = FlaxNBP()
    shapes = jax.eval_shape(lambda: fm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 256, 256, 5))))
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = flax_to_state_dict(zeros["params"], zeros["batch_stats"])
    tm = NBP()
    want = tm.state_dict()
    assert set(sd) == set(want)
    for k, v in want.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    n_flax = sum(int(np.prod(s.shape)) for s in
                 jax.tree_util.tree_leaves(shapes["params"]))
    n_port = sum(p.numel() for p in tm.parameters())
    assert n_port == n_flax  # log_vars included, as in the flax module


def test_convert_sorts_by_numeric_suffix():
    fm = FlaxNBP(width=4)
    variables = fm.init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 5)))
    params = _to_numpy(variables["params"])
    sd = flax_to_state_dict(params, _to_numpy(variables["batch_stats"]))
    # ConvBlock_10 is the last decoder block (2w -> w); as strings it would
    # sort right after ConvBlock_1.
    k10 = params["ConvBlock_10"]["TorchConv_0"]["Conv_0"]["kernel"]
    np.testing.assert_array_equal(sd["conv_blocks.10.conv0.weight"].numpy(),
                                  k10.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["log_vars"].numpy(), params["log_vars"])
