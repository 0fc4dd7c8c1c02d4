"""The port's bf16 NBP U-Net (``NBP(dtype=torch.bfloat16)``) against the
JAX package's ``NBP(dtype=jnp.bfloat16)`` with the same weights (width 8,
32x32 input, non-trivial BatchNorm statistics), BN folded and not.

Tolerance: 1e-2 max abs on both outputs. Measured on the CPU: 9.8e-4 on
the value map and 3.9e-3 on the obstacle map (one bf16 ulp at 0.5, where
its sigmoid sits), the same at width 16 and a 64x64 input; the JAX bf16
forward itself is 1.0e-3 from its f32 forward on the value map.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextbestpath_tpu.models import NBP as FlaxNBP
from nextbestpath_tpu.models.fold import fold_model_and_variables
from nextbestpath_tpu_torch.models.convert import flax_to_state_dict
from nextbestpath_tpu_torch.models.fold import fold_bn
from nextbestpath_tpu_torch.models.unet import NBP, Conv

from test_torch_unet import _perturb_stats, _to_numpy

BF16_ATOL = 1e-2
SIZE, WIDTH = 32, 8


@pytest.fixture(scope="module")
def weights():
    variables = FlaxNBP(width=WIDTH).init(jax.random.PRNGKey(1),
                                          jnp.zeros((1, SIZE, SIZE, 5)))
    return (_to_numpy(variables["params"]),
            _perturb_stats(_to_numpy(variables["batch_stats"]), 2))


@pytest.mark.parametrize("fold", [False, True], ids=["unfolded", "folded"])
def test_bf16_nbp_matches_flax_bf16(weights, fold):
    params, stats = weights
    x = np.random.default_rng(0).random((2, SIZE, SIZE, 5)).astype(
        np.float32) * 3
    fm, fv = FlaxNBP(width=WIDTH, dtype=jnp.bfloat16), {
        "params": params, "batch_stats": stats}
    if fold:
        fm, fv = fold_model_and_variables(fm, fv)
    v_j, o_j = fm.apply(fv, jnp.asarray(x), train=False)

    tm = NBP(width=WIDTH, dtype=torch.bfloat16)
    tm.load_state_dict(flax_to_state_dict(params, stats), strict=True)
    tm.eval()
    if fold:
        tm = fold_bn(tm)
    seen = []
    for m in tm.modules():
        if isinstance(m, Conv):
            m.register_forward_hook(
                lambda mod, inp, out: seen.append((inp[0].dtype, out.dtype)))
    with torch.no_grad():
        v_t, o_t = tm(torch.from_numpy(x))
    assert v_t.dtype == o_t.dtype == torch.float32
    assert v_t.shape == (2, SIZE // 4, SIZE // 4, 8)
    assert o_t.shape == (2, SIZE, SIZE, 1)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=BF16_ATOL)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=BF16_ATOL)
    # Every convolution computes in bf16 (its output); with BN folded the
    # activations stay bf16 between them, so every one after the first
    # takes a bf16 input; the parameters stay f32.
    assert len(seen) == 11 * 2 + 6 + 6 * 3 + 2
    assert all(out == torch.bfloat16 for _, out in seen)
    ins = {dt for dt, _ in seen[1:]}
    assert ins == ({torch.bfloat16} if fold else {torch.float32})
    assert all(p.dtype == torch.float32 for p in tm.parameters())


def test_bf16_differs_from_f32_by_rounding_only(weights):
    """The same weights in f32 and bf16: the bf16 outputs stay within the
    tolerance of the f32 ones, and are not the f32 ones."""
    params, stats = weights
    x = torch.from_numpy(np.random.default_rng(1).random(
        (1, SIZE, SIZE, 5)).astype(np.float32))
    outs = []
    for dt in (torch.float32, torch.bfloat16):
        m = NBP(width=WIDTH, dtype=dt)
        m.load_state_dict(flax_to_state_dict(params, stats))
        with torch.no_grad():
            outs.append(m.eval()(x))
    (v32, o32), (v16, o16) = outs
    assert not torch.equal(v32, v16)
    torch.testing.assert_close(v16, v32, rtol=0, atol=BF16_ATOL)
    torch.testing.assert_close(o16, o32, rtol=0, atol=BF16_ATOL)


def test_nbp_refuses_other_dtypes():
    with pytest.raises(ValueError, match="float16"):
        NBP(width=4, dtype=torch.float16)
