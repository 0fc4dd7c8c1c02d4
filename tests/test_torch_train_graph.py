"""The trainer's micro step as one CUDA graph (``train/train_nbp.py::
_loss_and_grads``): what its key follows and that the CPU captures
nothing (CPU tests), and on a card a replay equal to the eager step bit
for bit, and a second staged dataset captured anew (``cuda`` tests).

Imports torch and the port only, so that the card, which has no JAX, can
run it without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_train_graph.py
"""

import random

import numpy as np
import pytest
import torch

from nextbestpath_tpu_torch.device import cudnn_f32
from nextbestpath_tpu_torch.train import train_nbp as T
from nextbestpath_tpu_torch.train.driver import seeded_train_model
from nextbestpath_tpu_torch.train.replay import Experience
from nextbestpath_tpu_torch.utils import timing


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _data(n, size, seed):
    rng = np.random.default_rng(seed)
    return [Experience(
        model_input=(rng.random((5, size, size)) * 3).astype(np.float16),
        gt_layout=(rng.random((size, size)) > 0.7).astype(np.uint8),
        pixels=np.stack([rng.integers(0, 8, 4), rng.integers(0, size // 4, 4),
                         rng.integers(0, size // 4, 4)], 1).astype(np.int32),
        gains=(rng.random(4) * 5).astype(np.float32), pose_i=12)
        for _ in range(n)]


def _batch(device, n=4):
    idx = torch.tensor([0, 3, 5, 1, 2, 4, 7, 6][:n], device=device)
    sw = torch.ones(n, device=device)
    sw[-1] = 0.0
    return idx, sw


def test_cpu_micro_step_captures_no_graph():
    """On the CPU every micro step dispatches op by op: the pass record
    holds a ``forward`` and a ``backward`` span a micro step, no
    ``capture`` or ``replay`` span and no graph counter, and the model
    has no graph."""
    model = seeded_train_model(1, width=4)
    state = T.init_train_state(model, accumulation_steps=3)
    ds, _ = T.build_device_dataset(_data(6, 32, 0), torch.device("cpu"))
    before = {id(r) for r in timing.records()}
    _, loss = T.train_epoch_ds(state, ds, list(range(6)), random.Random(0),
                               micro_batch=2)
    (rec,) = [r for r in timing.records() if id(r) not in before]
    assert np.isfinite(loss)
    assert rec.n("forward") == rec.n("backward") == 3
    assert "capture" not in rec.spans and "replay" not in rec.spans
    assert not rec.counts.get("graph_captures")
    assert not rec.counts.get("graph_replays")
    assert model not in T._GRAPHS


def _changed(case, model, ds, idx, sw):
    """(model, ds, idx, sw) after the change ``case``; restores nothing."""
    if case == "same":
        pass
    elif case == "parameters_updated_in_place":
        opt = torch.optim.AdamW(model.parameters())
        for p in model.parameters():
            p.grad = torch.ones_like(p)
        opt.step()
    elif case == "batch_stats_updated_in_place":
        T._eager_loss_and_grads(model, ds, idx, sw)
    elif case == "another_dataset":
        ds, _ = T.build_device_dataset(_data(6, 32, 1), torch.device("cpu"))
    elif case == "another_micro_batch":
        idx, sw = _batch("cpu", n=3)
    elif case == "eval_mode":
        model.eval()
    elif case == "cudnn_tf32":
        torch.backends.cudnn.allow_tf32 = not torch.backends.cudnn.allow_tf32
    elif case == "cast":
        model.double()
    return model, ds, idx, sw


@pytest.mark.parametrize("case,same_key", [
    ("same", True), ("parameters_updated_in_place", True),
    ("batch_stats_updated_in_place", True), ("another_dataset", False),
    ("another_micro_batch", False), ("eval_mode", False),
    ("cudnn_tf32", False), ("cast", False)])
def test_graph_key_follows_what_the_captured_kernels_read(case, same_key):
    """The key stays through AdamW's and BatchNorm's in-place updates and
    changes with the dataset's addresses, the micro batch's size, the
    modes, the TF32 flag and the parameters' dtype."""
    model = seeded_train_model(1, width=4).train()
    ds, _ = T.build_device_dataset(_data(6, 32, 0), torch.device("cpu"))
    idx, sw = _batch("cpu")
    key = T._graph_key(model, ds, idx, sw)
    flag = torch.backends.cudnn.allow_tf32
    try:
        args = _changed(case, model, ds, idx, sw)
        assert (T._graph_key(*args) == key) == same_key
    finally:
        torch.backends.cudnn.allow_tf32 = flag


def _step_outputs(model, ds, idx, sw, fn=None):
    """(loss, gradients, buffers) of one micro step, copied."""
    loss, grads = (fn or T._loss_and_grads)(model, ds, idx, sw)
    return (loss.clone(), [g.clone() for g in grads],
            [b.clone() for b in model.buffers()])


def _assert_bit_equal(a, b):
    assert torch.equal(a[0], b[0]), (float(a[0]), float(b[0]))
    for x, y in zip(a[1], b[1]):
        assert torch.equal(x, y)
    for x, y in zip(a[2], b[2]):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_replay_equals_the_eager_step_bit_for_bit(dtype):
    """From the same parameters and BatchNorm statistics, restored before
    each call, the eager first call, the capture call (whose replay does
    its step) and a later replay give bit-equal loss, gradients and
    running statistics, and the statistics moved once a call.

    bf16 runs cuDNN's default algorithms. In f32 those give other bits
    from one eager call to the next on the H100 (the early layers'
    weight gradients, in their last bits), so f32 runs cuDNN's
    deterministic ones, with which eager calls agree."""
    _need_card()
    dev = torch.device("cuda")
    model = seeded_train_model(1, width=8, dtype=dtype).to(dev).train()
    ds, _ = T.build_device_dataset(_data(6, 64, 0), dev)
    idx, sw = _batch(dev)
    snap = {k: v.clone() for k, v in model.state_dict().items()}
    outs = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = dtype == torch.float32
    try:
        with timing.run("t") as rec, cudnn_f32():
            for _ in range(3):
                model.load_state_dict(snap)
                outs.append(_step_outputs(model, ds, idx, sw))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert rec.counts == {"graph_captures": 1, "graph_replays": 2}
    assert rec.n("forward") == rec.n("backward") == 2
    assert rec.n("capture") == 1 and rec.n("replay") == 2
    assert torch.isfinite(outs[0][0])
    stats0 = [snap[k] for k, _ in model.named_buffers()]
    assert not all(torch.equal(a, b) for a, b in zip(outs[0][2], stats0))
    for out in outs[1:]:
        _assert_bit_equal(out, outs[0])


@pytest.mark.cuda
def test_another_staged_dataset_captures_again():
    """A second staged dataset of the same shape (other addresses) is
    another key: its first call runs eagerly, its second captures anew,
    and each gives that dataset's step, bit for bit as the eager step."""
    _need_card()
    dev = torch.device("cuda")
    model = seeded_train_model(2, width=8, dtype=torch.bfloat16).to(
        dev).train()
    ds1, _ = T.build_device_dataset(_data(6, 64, 0), dev)
    ds2, _ = T.build_device_dataset(_data(6, 64, 1), dev)
    idx, sw = _batch(dev)
    snap = {k: v.clone() for k, v in model.state_dict().items()}
    with timing.run("t") as rec, cudnn_f32():
        first = []
        for _ in range(2):
            model.load_state_dict(snap)
            first.append(_step_outputs(model, ds1, idx, sw))
        model.load_state_dict(snap)
        want = _step_outputs(model, ds2, idx, sw, T._eager_loss_and_grads)
        outs = []
        for _ in range(3):
            model.load_state_dict(snap)
            outs.append(_step_outputs(model, ds2, idx, sw))
    assert rec.counts == {"graph_captures": 2, "graph_replays": 3}
    _assert_bit_equal(first[1], first[0])
    assert not torch.equal(want[0], first[0][0])
    for out in outs:
        _assert_bit_equal(out, want)
