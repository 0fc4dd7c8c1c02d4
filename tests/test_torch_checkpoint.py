"""Flax checkpoints read and written by the port without flax or msgpack
(``nextbestpath_tpu_torch/utils/checkpoint.py``), against the JAX
package's ``utils/checkpoint.py`` and ``flax.serialization``:

(a) a JAX ``save_checkpoint`` of ``NBP(width=8)``, loaded into the port,
    gives the JAX forward in f32 within 1e-5;
(b) the port's ``save_nbp``, read by the JAX ``load_checkpoint`` with a
    flax template, gives every array bit for bit, ``log_vars`` included;
(c) the committed ``weights/nbp/nbp_best_val.ckpt``, read by the port,
    gives its 281 leaves bit for bit as
    ``flax.serialization.msgpack_restore``, with its epoch and ``extra``;
(d) the trained full-width U-Net's f32 forward at a 64x64 input, loaded by
    each package, agrees within 1e-4 (tests/test_torch_unet.py's tolerance).

Also: the msgpack the port writes is the byte string ``msgpack.packb``
gives with flax's extension hook, chunked leaves are reassembled, and
what the port cannot read or write is refused by name.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from nextbestpath_tpu.models import NBP as FlaxNBP
from nextbestpath_tpu.utils import checkpoint as JCK
from nextbestpath_tpu_torch.models.unet import NBP
from nextbestpath_tpu_torch.utils import checkpoint as TCK

from test_torch_unet import _perturb_stats, _to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINED = os.path.join(REPO, "weights", "nbp", "nbp_best_val.ckpt")


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _flax_variables(width, size, seed):
    fm = FlaxNBP(width=width)
    v = fm.init(jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 5)))
    params = _to_numpy(v["params"])
    params["log_vars"] = np.array([0.25, -0.5], np.float32)
    return fm, {"params": params,
                "batch_stats": _perturb_stats(_to_numpy(v["batch_stats"]), 4)}


def test_jax_checkpoint_loads_into_port(tmp_path):
    fm, variables = _flax_variables(8, 32, 1)
    path = str(tmp_path / "jax.ckpt")
    JCK.save_checkpoint(path, variables, epoch=3, extra={"mean_auc": 0.5})
    model = NBP(width=8)
    epoch, extra = TCK.load_nbp(path, model)
    assert (epoch, extra) == (3, {"mean_auc": 0.5})
    np.testing.assert_array_equal(model.log_vars.detach().numpy(),
                                  variables["params"]["log_vars"])
    x = np.random.default_rng(0).random((2, 32, 32, 5)).astype(np.float32)
    v_j, o_j = fm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        v_t, o_t = model.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-5)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-5)


def test_port_checkpoint_loads_in_jax(tmp_path):
    torch.manual_seed(2)
    model = NBP(width=8)
    with torch.no_grad():
        model.log_vars.copy_(torch.tensor([1.5, -2.0]))
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.5, 2.0)
    path = str(tmp_path / "port.ckpt")
    TCK.save_nbp(path, model, epoch=7, extra={"note": "port"})
    fm = FlaxNBP(width=8)
    template = jax.jit(lambda k, x: fm.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 5)))
    restored, _, epoch, extra = JCK.load_checkpoint(path, template)
    assert (epoch, extra) == (7, {"note": "port"})
    from nextbestpath_tpu_torch.models.convert import state_dict_to_flax

    params, stats = state_dict_to_flax(model.state_dict())
    want = {"params": params, "batch_stats": stats}
    got_l, want_l = _leaves(restored), _leaves(want)
    assert len(got_l) == len(want_l) == len(_leaves(template))
    for (pg, g), (pw, w) in zip(got_l, want_l):
        assert pg == pw
        g = np.asarray(g)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes(), pg
    np.testing.assert_array_equal(np.asarray(restored["params"]["log_vars"]),
                                  [1.5, -2.0])
    # And back into the port, bit for bit.
    again = NBP(width=8)
    TCK.load_nbp(path, again)
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


@pytest.fixture(scope="module")
def trained():
    with open(TRAINED, "rb") as f:
        payload = pickle.load(f)
    return payload, serialization.msgpack_restore(payload["variables"])


def test_committed_checkpoint_reads_bit_for_bit(trained):
    payload, want = trained
    got, opt, epoch, extra = TCK.load_checkpoint(TRAINED)
    assert opt is None and epoch == 4 == payload["epoch"]
    assert extra == payload["extra"] and "mean_auc" in extra
    got_l, want_l = _leaves(got), _leaves(want)
    assert len(got_l) == len(want_l) == 281
    assert set(got) == {"params", "batch_stats"}
    assert sum(np.asarray(w).size for _, w in want_l) == 49_986_441
    for (pg, g), (pw, w) in zip(got_l, want_l):
        assert pg == pw and g.dtype == w.dtype == np.float32
        assert g.shape == w.shape and g.tobytes() == w.tobytes(), pg
    np.testing.assert_array_equal(got["params"]["log_vars"],
                                  want["params"]["log_vars"])
    # The writer gives the committed file's msgpack back, byte for byte.
    assert TCK.msgpack_serialize(got) == payload["variables"]


def test_trained_full_width_forward_matches_jax(trained):
    _, variables = trained
    x = np.random.default_rng(1).random((1, 64, 64, 5)).astype(np.float32)
    v_j, o_j = FlaxNBP().apply(variables, jnp.asarray(x), train=False)
    model = NBP()
    TCK.load_nbp(TRAINED, model)
    with torch.no_grad():
        v_t, o_t = model.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-4)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-4)


def _tree():
    return {"i": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32, -33,
                  -128, -129, -32768, -32769, -2 ** 31 - 1],
            "f": 1.5, "none": None, "t": True, "no": False,
            "s": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40],
            "b": b"\x00" * 300, "big": b"\x01" * 70_000,
            "arr": np.arange(24, dtype=np.int16).reshape(2, 3, 4),
            "f64": np.float64(2.25), "f32": np.float32(-1.0),
            "bool": np.bool_(True), "c": 1 - 2j,
            "empty": np.zeros((0, 3), np.float32),
            "wide": {str(k): k for k in range(20)},
            "list": list(range(20))}


def test_writer_matches_msgpack_with_flax_hook():
    tree = _tree()
    want = msgpack.packb(tree, default=serialization._msgpack_ext_pack,
                         strict_types=True)
    assert TCK.msgpack_serialize(tree) == want
    got, ref = TCK.msgpack_restore(want), serialization.msgpack_restore(want)
    for k in tree:
        g, r = got[k], ref[k]
        assert type(g) is type(r), k
        if isinstance(r, np.ndarray):
            assert g.dtype == r.dtype and np.array_equal(g, r), k
        else:
            assert g == r, k


def test_chunked_leaves_are_reassembled_and_never_written(monkeypatch):
    arr = np.arange(1000, dtype=np.float32).reshape(10, 100)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 1024)
    data = serialization.msgpack_serialize({"w": arr, "x": {"y": arr}})
    assert b"__msgpack_chunked_array__" in data
    got = TCK.msgpack_restore(data)
    np.testing.assert_array_equal(got["w"], arr)
    np.testing.assert_array_equal(got["x"]["y"], arr)
    monkeypatch.setattr(TCK, "MAX_LEAF_BYTES", 1024)
    with pytest.raises(ValueError, match="chunked"):
        TCK.msgpack_serialize({"w": arr})


def test_unsupported_data_is_refused():
    with pytest.raises(ValueError, match="extension type 9"):
        TCK.msgpack_restore(msgpack.packb(msgpack.ExtType(9, b"x")))
    with pytest.raises(ValueError, match="truncated"):
        TCK.msgpack_restore(msgpack.packb({"a": b"x" * 10})[:-3])
    with pytest.raises(TypeError, match="set"):
        TCK.msgpack_serialize({"a": {1, 2}})
