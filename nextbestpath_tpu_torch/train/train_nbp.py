"""NBP supervised training: the micro step, gradient accumulation, AdamW,
the inner-epoch loop and the host bookkeeping.

Port of ``nextbestpath_tpu/train/train_nbp.py``. The optimizer is
``torch.optim.AdamW`` (lr 1e-3, betas (0.9, 0.999), eps 1e-8, weight decay
0.01 on every parameter, ``log_vars`` and BatchNorm's included, as optax's
unmasked ``adamw``), behind an accumulator that reproduces
``optax.MultiSteps(every_k)``: each micro step's gradient, taken at
unchanged parameters, joins a running mean ``acc + (g - acc) / (n + 1)``;
the k-th micro step hands the mean to AdamW, whose step count therefore
rises only on an emitted step. The mini-step counter and the partial mean
live in ``TrainState`` and carry across inner and outer epochs, as optax's
state does. The default 7 micro batches of 8 make the reference's logical
batch of 56.

A micro step (forward in train mode, loss, backward, and on the k-th the
optimizer step; each a span of ``utils/timing.py``) runs
under ``cudnn_f32``: autograd runs the backward
convolutions after the forward has returned, so the U-Net's own guard
does not cover them. The caller's TF32 flag is back after the step.

``opt_state_to_flax`` and ``opt_state_from_flax`` map a ``TrainState`` to
and from the state dict that flax writes for the JAX package's optimizer,
``optax.MultiSteps(optax.inject_hyperparams(optax.adamw))`` (optax 0.2.6,
flax 0.12.3), so that a resume checkpoint is read by either package.

A ``NBP(dtype=torch.bfloat16)`` trains through the same step: its
convolutions compute in bf16, its parameters, gradients, accumulator and
Adam moments stay f32, and its BatchNorms run in f32, as flax's ``dtype``
does.

The epoch's data is staged once on the device (f16 inputs, u8 layouts,
``build_device_dataset``), and micro batches are gathered by index. Ragged
per-experience pixel lists are padded to ``MAX_PIXELS`` with zero weights.
The JAX package pads the dataset to a power-of-two length so that XLA
compiles one program a bucket; eager PyTorch needs no padding.
"""

from __future__ import annotations

import dataclasses
import random
import sys
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Params, default_params
from ..models.convert import flax_to_state_dict, state_dict_to_flax
from ..device import cudnn_f32
from ..models.unet import NBP, nbp_loss
from ..utils import timing
from ..utils.timing import span
from .replay import Experience, ReplayDB

MAX_PIXELS = 128  # pad width for per-experience target pixel lists
MICRO_BATCH = 8   # device batch of a micro step

Dataset = Dict[str, torch.Tensor]


def make_optimizer(model: NBP, lr: float = 1e-3,
                   weight_decay: float = 0.01) -> torch.optim.AdamW:
    """AdamW over every parameter of ``model``; the trainer sets the
    learning rate through the param groups (``set_lr``)."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


@dataclasses.dataclass
class TrainState:
    model: NBP                  # parameters and BatchNorm statistics
    optimizer: torch.optim.AdamW
    every_k: int                # micro steps an optimizer step
    acc: List[torch.Tensor]     # running mean of this cycle's gradients
    mini_step: int              # micro steps taken in this cycle
    lr: float

    @property
    def params(self) -> List[torch.nn.Parameter]:
        return list(self.model.parameters())

    @property
    def device(self) -> torch.device:
        return self.model.log_vars.device


def init_train_state(model: NBP, lr: float = 1e-3,
                     accumulation_steps: int = 7) -> TrainState:
    """A fresh optimizer and accumulator for ``model``, on its device.
    accumulation_steps counts micro batches: 7 x 8 is the reference's
    logical batch of 56."""
    return TrainState(
        model=model, optimizer=make_optimizer(model, lr=lr),
        every_k=int(accumulation_steps),
        acc=[torch.zeros_like(p) for p in model.parameters()],
        mini_step=0, lr=float(lr))


def set_lr(state: TrainState, lr: float) -> None:
    """The learning rate of the next optimizer steps."""
    state.lr = float(lr)
    for group in state.optimizer.param_groups:
        group["lr"] = state.lr


def _flax_param_tree(state: TrainState, tensors: List[torch.Tensor],
                     dtype=np.float32) -> Dict:
    """One tensor a parameter of ``state.model`` -> flax's params tree."""
    sd = dict(state.model.state_dict())
    sd.update({name: t for (name, _), t in
               zip(state.model.named_parameters(), tensors)})
    return state_dict_to_flax(sd, dtype=dtype)[0]


def _from_flax_param_tree(state: TrainState, tree: Dict
                          ) -> List[torch.Tensor]:
    """flax's params tree -> one tensor a parameter of ``state.model``."""
    _, stats = state_dict_to_flax(state.model.state_dict())
    dtype = np.float64 if state.model.log_vars.dtype == torch.float64 \
        else np.float32
    sd = flax_to_state_dict(tree, stats, dtype=dtype)
    return [sd[name] for name, _ in state.model.named_parameters()]


def opt_state_to_flax(state: TrainState, dtype=np.float32) -> Dict:
    """The state dict flax writes for the JAX package's optimizer state
    (``MultiStepsState`` over ``inject_hyperparams(adamw)``): AdamW's step,
    ``exp_avg`` and ``exp_avg_sq`` as the inner Adam ``count``, ``mu`` and
    ``nu``; the accumulator as ``acc_grads``; ``mini_step``; the emitted
    steps as ``gradient_step``; ``lr`` as ``hyperparams.learning_rate``.
    Numpy leaves, the moments in ``dtype``."""
    params = state.params
    opt = state.optimizer
    group = opt.param_groups[0]
    slots = [opt.state.get(p, {}) for p in params]
    step = int(slots[0]["step"]) if slots[0] else 0
    mu = [s.get("exp_avg", torch.zeros_like(p)) for s, p in zip(slots, params)]
    nu = [s.get("exp_avg_sq", torch.zeros_like(p))
          for s, p in zip(slots, params)]

    def f32(x):
        return np.asarray(x, np.float32)

    count = np.asarray(step, np.int32)
    hyper = {"learning_rate": f32(state.lr), "b1": f32(group["betas"][0]),
             "b2": f32(group["betas"][1]), "eps": f32(group["eps"]),
             "eps_root": f32(0.0),
             "weight_decay": f32(group["weight_decay"])}
    adam = {"count": count, "mu": _flax_param_tree(state, mu, dtype),
            "nu": _flax_param_tree(state, nu, dtype)}
    return {"mini_step": np.asarray(state.mini_step, np.int32),
            "gradient_step": count,
            "inner_opt_state": {"count": count, "hyperparams": hyper,
                                "hyperparams_states": {},
                                "inner_state": {"0": adam, "1": {}, "2": {}}},
            "acc_grads": _flax_param_tree(state, state.acc, dtype),
            "skip_state": {}}


@torch.no_grad()
def opt_state_from_flax(tree: Dict, state: TrainState) -> TrainState:
    """Load a flax optimizer state dict (``opt_state_to_flax``'s layout, as
    the JAX package's checkpoints hold it) into ``state`` in place: AdamW's
    step and moments, the accumulator, the mini-step count and the
    learning rate. Returns ``state``."""
    inner = tree["inner_opt_state"]
    adam = inner["inner_state"]["0"]
    step = int(np.asarray(adam["count"]))
    params = state.params
    opt = state.optimizer
    for p, m, v in zip(params, _from_flax_param_tree(state, adam["mu"]),
                       _from_flax_param_tree(state, adam["nu"])):
        if step == 0:
            opt.state.pop(p, None)
            continue
        opt.state[p] = {"step": torch.tensor(float(step), dtype=torch.float32),
                        "exp_avg": m.to(p), "exp_avg_sq": v.to(p)}
    for a, g in zip(state.acc, _from_flax_param_tree(state,
                                                     tree["acc_grads"])):
        a.copy_(g)
    state.mini_step = int(np.asarray(tree["mini_step"]))
    set_lr(state, float(np.asarray(inner["hyperparams"]["learning_rate"])))
    return state


def build_device_dataset(data: List[Experience], device: torch.device
                         ) -> Tuple[Dataset, int]:
    """Stack a replay slice into one dataset on ``device``: x (N, S, S, 5)
    f16, layout (N, S, S) u8, pixels (N, MAX_PIXELS, 3) i64, gains and
    pweights (N, MAX_PIXELS) f32. Returns (arrays, N)."""
    N = len(data)
    S = data[0].gt_layout.shape[0] if data else 1
    cap = max(N, 1)
    x = np.zeros((cap, S, S, 5), np.float16)
    layout = np.zeros((cap, S, S), np.uint8)
    pixels = np.zeros((cap, MAX_PIXELS, 3), np.int64)
    gains = np.zeros((cap, MAX_PIXELS), np.float32)
    pweights = np.zeros((cap, MAX_PIXELS), np.float32)
    n_dropped = 0
    for i, e in enumerate(data):
        x[i] = e.model_input.transpose(1, 2, 0)
        layout[i] = e.gt_layout
        k = min(len(e.gains), MAX_PIXELS)
        n_dropped += len(e.gains) - k
        pixels[i, :k] = e.pixels[:k]
        gains[i, :k] = e.gains[:k]
        pweights[i, :k] = 1.0
    if n_dropped:
        print(f"WARNING: build_device_dataset dropped {n_dropped} target "
              f"pixels past the MAX_PIXELS={MAX_PIXELS} pad width "
              "(raise it for longer rollouts)", file=sys.stderr)
    arrays = dict(x=x, layout=layout, pixels=pixels, gains=gains,
                  pweights=pweights)
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}, N


def _gather_pred_values(value_map: torch.Tensor, pixels: torch.Tensor
                        ) -> torch.Tensor:
    """value_map (B, S, S, 8) NHWC at pixels (B, K, 3) = (rot, row, col):
    (B, K)."""
    b_idx = torch.arange(value_map.shape[0], device=value_map.device)[:, None]
    pixels = pixels.long()
    return value_map[b_idx, pixels[..., 1], pixels[..., 2], pixels[..., 0]]


def _batch(ds: Dataset, idx: torch.Tensor, sw: torch.Tensor):
    with span("batch"):
        x = ds["x"][idx].to(torch.float32)
        layout = ds["layout"][idx].to(torch.float32)[..., None]
        weights = ds["pweights"][idx] * sw[:, None]
        return x, layout, ds["pixels"][idx], ds["gains"][idx], weights


def _accumulate(state: TrainState, grads) -> None:
    """optax.MultiSteps: fold ``grads`` into the running mean; on the k-th
    micro step hand the mean to AdamW and start a new cycle."""
    diff = torch._foreach_sub(list(grads), state.acc)
    torch._foreach_div_(diff, float(state.mini_step + 1))
    torch._foreach_add_(state.acc, diff)
    if state.mini_step < state.every_k - 1:
        state.mini_step += 1
        return
    params = state.params
    for p, g in zip(params, state.acc):
        p.grad = g
    with span("optimizer"):
        state.optimizer.step()
    for p in params:
        p.grad = None
    torch._foreach_zero_(state.acc)
    state.mini_step = 0


def _loss_and_grads(model: NBP, ds: Dataset, idx: torch.Tensor,
                    sw: torch.Tensor
                    ) -> Tuple[torch.Tensor, Sequence[torch.Tensor]]:
    """The loss of the micro batch (idx, sw) gathered from the staged
    dataset, in the model's current mode, and its gradients. Returns
    (loss, gradients), the loss detached."""
    with span("forward"):
        x, layout, pixels, gains, weights = _batch(ds, idx, sw)
        vm, om = model(x)
        pred_vals = _gather_pred_values(vm, pixels)
        loss = nbp_loss(model.log_vars, pred_vals, gains, om, layout,
                        value_weight=weights, sample_weight=sw)
    with span("backward"):
        grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss.detach(), grads


# (model, ds, idx, sw) -> (loss, gradients) of a micro batch: one process's
# (``_loss_and_grads``) or the global batch's over ranks
# (``parallel/dp.py::dp_loss_and_grads_ds``).
LossAndGrads = Callable[[NBP, Dataset, torch.Tensor, torch.Tensor],
                        Tuple[torch.Tensor, Sequence[torch.Tensor]]]


def _train_step_ds(state: TrainState, ds: Dataset, idx: torch.Tensor,
                   sw: torch.Tensor,
                   loss_and_grads: LossAndGrads = _loss_and_grads
                   ) -> torch.Tensor:
    """One micro step gathered from the staged dataset: idx (B,) entry
    indices, sw (B,) row weights (0 for padded tail rows, which still
    enter the BatchNorm batch statistics). Updates the model's running
    statistics, the accumulator and, on the k-th micro step, the
    parameters. Returns the loss (0-d, on the device)."""
    model = state.model
    model.train()
    with cudnn_f32():
        loss, grads = loss_and_grads(model, ds, idx, sw)
        with span("accumulate"):
            _accumulate(state, grads)
    return loss


@torch.no_grad()
def _eval_step_ds(model: NBP, ds: Dataset, idx: torch.Tensor,
                  sw: torch.Tensor) -> torch.Tensor:
    """Validation loss of a micro batch, eval-mode BatchNorm: weighted MSE
    plus the sample-weighted layout BCE, without the log-variances."""
    model.eval()
    x, layout, pixels, gains, w = _batch(ds, idx, sw)
    vm, om = model(x)
    pred_vals = _gather_pred_values(vm, pixels)
    mse = torch.sum(((pred_vals - gains) ** 2) * w) / torch.clamp(
        torch.sum(w), min=1.0)
    eps = 1e-7
    p_clip = torch.clamp(om, eps, 1 - eps)
    bce_map = -(layout * torch.log(p_clip)
                + (1 - layout) * torch.log(1 - p_clip))
    per_sample = bce_map.reshape(bce_map.shape[0], -1).mean(dim=-1)
    bce = torch.sum(per_sample * sw) / torch.clamp(torch.sum(sw), min=1.0)
    return mse + bce


def _micro_chunks(indices: List[int], micro: int,
                  rng: Optional[random.Random] = None,
                  device: torch.device = torch.device("cpu")
                  ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """(idx (micro,), sw (micro,)) chunks of ``indices``; a ragged tail is
    zero-weighted and, with an rng, filled with random draws from the pool
    (its rows still enter the BatchNorm statistics), else with the first
    index."""
    for j in range(0, len(indices), micro):
        with span("chunk"):
            chunk = indices[j: j + micro]
            n_pad = micro - len(chunk)
            if n_pad and rng is not None:
                pad = [indices[rng.randrange(len(indices))]
                       for _ in range(n_pad)]
            else:
                pad = [indices[0] if indices else 0] * n_pad
            sw = np.zeros((micro,), np.float32)
            sw[: len(chunk)] = 1.0
            idx = torch.tensor(list(chunk) + pad, dtype=torch.int64,
                               device=device)
            sw = torch.from_numpy(sw).to(device)
        yield idx, sw


def _mean_loss(losses: List[torch.Tensor]) -> float:
    if not losses:
        return 0.0
    with span("loss_read"):
        return float(np.mean(torch.stack(losses).cpu().numpy().astype(
            np.float64)))


def train_epoch_ds(state: TrainState, ds: Dataset, index_pool: List[int],
                   rng: random.Random, micro_batch: int = MICRO_BATCH,
                   loss_and_grads: LossAndGrads = _loss_and_grads
                   ) -> Tuple[TrainState, float]:
    """One shuffled pass over ``index_pool`` of the staged dataset; returns
    (state, mean micro-step loss). Leaves a run record
    (``utils/timing.py``) of kind ``pass``: the spans ``pass``,
    ``shuffle``, ``chunk``, ``forward`` (holding ``batch``), ``backward``,
    ``accumulate`` (holding ``optimizer``) and ``loss_read``, over its
    micro steps, AdamW steps and rows."""
    micro_steps = -(-len(index_pool) // micro_batch)
    with timing.run("pass", micro_steps=micro_steps,
                    adamw_steps=(state.mini_step + micro_steps)
                    // state.every_k, rows=len(index_pool)), span("pass"):
        with span("shuffle"):
            pool = list(index_pool)
            rng.shuffle(pool)
        losses = [_train_step_ds(state, ds, idx, sw, loss_and_grads)
                  for idx, sw in _micro_chunks(pool, micro_batch, rng=rng,
                                               device=state.device)]
        return state, _mean_loss(losses)


def validate_ds(state: TrainState, ds: Dataset, n: int,
                micro_batch: int = MICRO_BATCH) -> float:
    losses = [_eval_step_ds(state.model, ds, idx, sw)
              for idx, sw in _micro_chunks(list(range(n)), micro_batch,
                                           device=state.device)]
    return _mean_loss(losses)


def _epoch_pool(data: List[Experience], current_epoch: int) -> List[int]:
    """Trainable indices: epoch 1 skips samples with pose_i <= 10, as the
    reference does."""
    return [i for i, e in enumerate(data)
            if (e.pose_i > 10 and current_epoch == 1) or current_epoch > 1]


def release_device_dataset(ds: Dataset) -> None:
    """Drop the dataset's references to its tensors (PyTorch frees them
    with the last reference)."""
    ds.clear()


def train_epoch(state: TrainState, data: List[Experience], batch_size: int,
                current_epoch: int, rng: random.Random,
                micro_batch: int = MICRO_BATCH) -> Tuple[TrainState, float]:
    """Stage ``data``, run one epoch over its trainable pool, release."""
    ds, _ = build_device_dataset(data, state.device)
    pool = _epoch_pool(data, current_epoch)
    try:
        return train_epoch_ds(state, ds, pool, rng,
                              micro_batch=min(micro_batch, batch_size))
    finally:
        release_device_dataset(ds)


# One cached staged validation set, keyed by the identity of the list it
# holds (the entry keeps the list alive, so its id cannot be recycled) and
# by the device.
_VAL_DS_CACHE: List[Tuple[Dataset, int, List[Experience]]] = []


def validate(state: TrainState, data: List[Experience], batch_size: int,
             micro_batch: int = MICRO_BATCH) -> float:
    if not data:
        return 0.0
    hit = (_VAL_DS_CACHE and _VAL_DS_CACHE[0][2] is data
           and _VAL_DS_CACHE[0][0]["x"].device == state.device)
    if not hit:
        if _VAL_DS_CACHE:
            release_device_dataset(_VAL_DS_CACHE[0][0])
            _VAL_DS_CACHE.clear()
        ds, n = build_device_dataset(data, state.device)
        _VAL_DS_CACHE.append((ds, n, data))
    ds, n, _ = _VAL_DS_CACHE[0]
    return validate_ds(state, ds, n, micro_batch=min(micro_batch, batch_size))


class PlateauScheduler:
    """ReduceLROnPlateau(mode=min, factor, patience) on the host, floored
    at min_lr (1e-4, the JAX package's floor for small validation sets)."""

    def __init__(self, factor: float = 0.1, patience: int = 2,
                 min_lr: float = 1e-4):
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.best = float("inf")
        self.bad = 0

    def step(self, metric: float, lr: float) -> float:
        if metric < self.best:
            self.best = metric
            self.bad = 0
            return lr
        self.bad += 1
        if self.bad > self.patience:
            self.bad = 0
            return max(lr * self.factor, self.min_lr)
        return lr


class EarlyStopping:
    """Patience/min-delta early stopping: ``early_stop`` latches True
    after ``patience`` calls that do not improve the best loss by more
    than min_delta."""

    def __init__(self, patience: int = 5, min_delta: float = 0.2):
        self.patience = patience
        self.min_delta = min_delta
        self.counter = 0
        self.best_loss = float("inf")
        self.early_stop = False

    def __call__(self, val_loss: float) -> bool:
        if self.best_loss - val_loss > self.min_delta:
            self.best_loss = val_loss
            self.counter = 0
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.early_stop = True
        return self.early_stop


def count_parameters(model: NBP) -> int:
    """Trainable parameter count (``log_vars`` included, as flax's
    params)."""
    return sum(p.numel() for p in model.parameters())


def train_nbp(state: TrainState, db: ReplayDB,
              validation_data: List[Experience], current_epoch: int,
              params: Optional[Params] = None, num_epochs: int = 5,
              seed: int = 0, verbose: bool = True,
              micro_batch: Optional[int] = None,
              whole_store_first: bool = False,
              loss_and_grads: LossAndGrads = _loss_and_grads
              ) -> Tuple[TrainState, float, float]:
    """``num_epochs`` inner epochs over a bounded slice of the replay data
    (the newest 4608 and 2048 sampled older ones, staged once), each
    validated, the learning rate on a plateau schedule. Returns (state,
    mean train loss, mean validation loss).

    The data-parallel trainer (``parallel/dp.py::train_nbp_dp``) sets the
    rest: micro_batch (default ``min(MICRO_BATCH, nbp_batch_size)``),
    whole_store_first (epoch 1 reads the whole store), loss_and_grads (a
    micro batch's loss and gradients)."""
    p = params or default_params()
    rng = random.Random(seed)
    if whole_store_first and current_epoch == 1:
        data = db.read_combined(last_n=None)
    else:
        data = db.read_combined(last_n=4608, sample_size=2048, rng=rng)
    sched = PlateauScheduler()
    lr = state.lr
    train_losses, val_losses = [], []
    ds, _ = build_device_dataset(data, state.device)
    pool = _epoch_pool(data, current_epoch)
    micro = micro_batch or min(MICRO_BATCH, int(p.nbp_batch_size))
    for e in range(num_epochs):
        state, tl = train_epoch_ds(state, ds, pool, rng, micro_batch=micro,
                                   loss_and_grads=loss_and_grads)
        vl = validate(state, validation_data, int(p.nbp_batch_size))
        train_losses.append(tl)
        val_losses.append(vl)
        new_lr = sched.step(vl, lr)
        if new_lr != lr:
            lr = new_lr
            set_lr(state, lr)
        if verbose:
            print(f"  inner epoch {e + 1}: train {tl:.4f} val {vl:.4f} "
                  f"lr {lr:.2e}")
    state.lr = lr
    release_device_dataset(ds)
    return state, float(np.mean(train_losses)), float(np.mean(val_losses))
