"""Data-parallel NBP training over ranks.

Port of ``nextbestpath_tpu/parallel/dp.py``. The reference trains under
DDP: parameters replicated on each GPU, a batch a rank, an NCCL gradient
all-reduce and SyncBatchNorm (macarons_utils.py:177-326, 483-494). The JAX
package expresses it as one jitted step whose shardings make XLA insert
the gradient psum and compute the BatchNorm statistics over the global
batch. Here each rank runs the step on its contiguous block of the global
micro batch (``parallel/mesh.py::local_block``), and the collectives are
explicit:

* BatchNorm over the global batch: ``models/unet.py::batch_norm_group``,
  one differentiable all-reduce a layer forward and one backward;
* the loss is the global batch's: each rank's share has the global
  denominators (the value-pixel and row weight sums of the whole micro
  batch, which every rank holds) and ``1 / W`` of the log-variance terms
  (``nbp_loss(..., totals=, n_shares=)``), so a rank that holds only
  padded rows (``sw = 0``) of a ragged tail still gets the global
  gradient. Averaging per-rank mean losses, as DDP would, would not;
* one SUM all-reduce of a flat bucket of the gradients (and the loss
  share, whose sum is the reported loss) after ``torch.autograd.grad``,
  before the accumulator (``train_nbp._accumulate``: MultiSteps and
  AdamW). DDP's reducer hooks do not fire under ``autograd.grad``.

Every rank then holds the same bits: the weights start from rank 0's
broadcast (``replicate``), every rank adds the same all-reduced gradient,
and the shuffle and the micro chunks come from ``random.Random(seed)`` on
each rank, seeded alike.

Not ported: ``_DP_STEP_CACHE``, the cache of XLA's compiled steps (eager
PyTorch compiles nothing).
"""

from __future__ import annotations

import copy
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import Params, default_params
from ..device import cudnn_f32
from ..models.unet import NBP, as_float64, batch_norm_group, nbp_loss
from ..train.driver import seeded_train_model
from ..train.replay import Experience, ReplayDB
from ..train.train_nbp import (MICRO_BATCH, Dataset, LossAndGrads,
                               TrainState, _batch, _gather_pred_values,
                               make_optimizer, train_nbp)
from ..utils.timing import span
from .mesh import Mesh, local_block, replicate

Batch = Dict[str, torch.Tensor]


def batch_totals(weights: torch.Tensor, sw: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The loss's denominators over a global micro batch: the value-pixel
    weights' sum and the row weights' sum (``nbp_loss``'s)."""
    return torch.sum(weights), torch.sum(sw)


def dp_loss_and_grads(model: NBP, mesh: Mesh, block: Batch,
                      totals: Tuple[torch.Tensor, torch.Tensor]
                      ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The global batch's loss and gradients, from this rank's ``block``
    (x, layout, pixels, gains, weights, sw) of it: train-mode forward with
    BatchNorm over the global batch, this rank's loss share, its
    gradients, and one SUM all-reduce of the gradients and the share.
    Returns (loss, gradients), the same on every rank."""
    params = list(model.parameters())
    with cudnn_f32(), batch_norm_group(model, mesh.group):
        with span("forward"):
            vm, om = model(block["x"])
            pred = _gather_pred_values(vm, block["pixels"])
            share = nbp_loss(model.log_vars, pred, block["gains"], om,
                             block["layout"], value_weight=block["weights"],
                             sample_weight=block["sw"], totals=totals,
                             n_shares=mesh.size)
        with span("backward"):
            grads = torch.autograd.grad(share, params)
    with span("grad_all_reduce"):
        flat = torch.cat([g.reshape(-1) for g in grads]
                         + [share.detach().reshape(1).to(grads[0].dtype)])
        dist.all_reduce(flat, group=mesh.group)
    out = [f.view_as(g) for f, g in
           zip(torch.split(flat[:-1], [g.numel() for g in grads]), grads)]
    return flat[-1], out


def dp_loss_and_grads_ds(model: NBP, ds: Dataset, idx: torch.Tensor,
                         sw: torch.Tensor, mesh: Mesh
                         ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The global micro batch (idx, sw)'s loss and gradients (every rank
    holds both; ``train_nbp.LossAndGrads`` once ``mesh`` is bound): the
    loss's denominators from the whole batch, then this rank's block
    gathered from the staged dataset through ``dp_loss_and_grads``."""
    totals = batch_totals(ds["pweights"][idx] * sw[:, None], sw)
    idx_l, sw_l = local_block(idx, mesh), local_block(sw, mesh)
    x, layout, pixels, gains, weights = _batch(ds, idx_l, sw_l)
    block = dict(x=x, layout=layout, pixels=pixels, gains=gains,
                 weights=weights, sw=sw_l)
    return dp_loss_and_grads(model, mesh, block, totals)


def dp_step(mesh: Mesh) -> LossAndGrads:
    """``dp_loss_and_grads_ds`` on ``mesh``, for ``train_nbp``'s
    ``loss_and_grads`` and its micro step."""
    return functools.partial(dp_loss_and_grads_ds, mesh=mesh)


def dp_micro_batch(p: Params, mesh: Mesh) -> int:
    """The global micro batch: ``min(MICRO_BATCH, nbp_batch_size)``, at
    least one row a rank, rounded up to a multiple of the ranks (JAX
    ``train_nbp_dp``; 8 on 3 ranks is 9)."""
    micro = max(min(MICRO_BATCH, int(p.nbp_batch_size)), mesh.size)
    return (micro + mesh.size - 1) // mesh.size * mesh.size


def train_nbp_dp(state: TrainState, db: ReplayDB,
                 validation_data: List[Experience], current_epoch: int,
                 mesh: Mesh, params: Optional[Params] = None,
                 num_epochs: int = 5, seed: int = 0, verbose: bool = True
                 ) -> Tuple[TrainState, float, float]:
    """``train_nbp`` with every micro batch split over the ranks (JAX
    ``train_nbp_dp``), called on every rank with the same replay store:
    epoch 1 reads the whole store (later epochs, as ``train_nbp``, the
    newest 4608 and 2048 sampled older ones), the micro batch is
    ``dp_micro_batch``, and a micro step's loss and gradients are
    ``dp_loss_and_grads_ds``'s. Every rank stages the whole slice and
    gathers its own rows; validation scores the whole set on every rank
    (a metric; the same on each); rank 0 alone prints. Returns (state,
    mean train loss, mean validation loss), the same on every rank."""
    p = params or default_params()
    return train_nbp(state, db, validation_data, current_epoch, params=p,
                     num_epochs=num_epochs, seed=seed,
                     verbose=verbose and mesh.rank == 0,
                     micro_batch=dp_micro_batch(p, mesh),
                     whole_store_first=True, loss_and_grads=dp_step(mesh))


# -- the dry run's pieces (``parallel/dryrun.py``) ---------------------------

def _global_batch(n_rows: int, image_size: int, seed: int, device,
                  dtype: torch.dtype = torch.float32,
                  n_padded: int = 0) -> Batch:
    """A random global batch from a numpy seed: x (B, S, S, 5) normal, a
    random binary layout, K = 8 value pixels a row with random 0/1 weights
    and uniform gains; the last ``n_padded`` rows zero-weighted (sw = 0),
    as a ragged tail's padding."""
    rng = np.random.default_rng(seed)
    S, K = image_size, 8
    vms = S // 4
    sw = np.ones(n_rows, np.float32)
    sw[n_rows - n_padded:] = 0.0
    arrays = dict(
        x=rng.standard_normal((n_rows, S, S, 5)),
        layout=(rng.random((n_rows, S, S, 1)) > 0.7),
        gains=rng.random((n_rows, K)) * 5,
        weights=(rng.random((n_rows, K)) > 0.3) * sw[:, None],
        sw=sw)
    out = {k: torch.from_numpy(np.asarray(v)).to(device, dtype)
           for k, v in arrays.items()}
    out["pixels"] = torch.from_numpy(np.stack(
        [rng.integers(0, 8, (n_rows, K)), rng.integers(0, vms, (n_rows, K)),
         rng.integers(0, vms, (n_rows, K))], -1)).to(device)
    return out


def _block(batch: Batch, mesh: Mesh) -> Batch:
    return {k: local_block(v, mesh) for k, v in batch.items()}


def _seeded_model(mesh: Mesh, width: int, f64: bool = False) -> NBP:
    """NBP(width) from seed 0 on the rank's device, rank 0's weights on
    every rank."""
    model = seeded_train_model(0, width)
    if f64:
        as_float64(model)
    model.to(mesh.device).train()
    replicate(list(model.parameters()) + list(model.buffers()), mesh)
    return model


def make_dp_train_step(model: NBP, optimizer: torch.optim.Optimizer,
                       mesh: Mesh):
    """step(global batch) -> loss: one optimizer step on the global
    batch, this rank computing on its block (JAX ``make_dp_train_step``,
    with the plain optimizer given, no accumulation)."""
    def step(batch: Batch) -> torch.Tensor:
        model.train()
        params = list(model.parameters())
        loss, grads = dp_loss_and_grads(
            model, mesh, _block(batch, mesh),
            batch_totals(batch["weights"], batch["sw"]))
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()
        for p in params:
            p.grad = None
        return loss
    return step


def dp_train_demo(mesh: Mesh, image_size: int = 64, n_steps: int = 1,
                  width: int = 8, verbose: bool = True) -> float:
    """The DP train step on a tiny batch: one row a rank, the rows
    distinct (identical rows would hide a missing gradient reduction), a
    narrow U-Net (same topology as the full one), AdamW. Returns the last
    step's loss, the same on every rank."""
    model = _seeded_model(mesh, width)
    step = make_dp_train_step(model, make_optimizer(model), mesh)
    batch = _global_batch(mesh.size, image_size, 7, mesh.device)
    row = 1.0 + torch.arange(mesh.size, device=mesh.device) / mesh.size
    batch["x"] = torch.ones_like(batch["x"]) * row[:, None, None, None]
    loss = None
    for _ in range(n_steps):
        loss = step(batch)
    loss = float(loss)
    if verbose and mesh.rank == 0:
        print(f"dp_train_demo({mesh.size}): loss = {loss:.4f}", flush=True)
    return loss


def dp_grad_parity(mesh: Mesh, image_size: int = 64, width: int = 16,
                   n_padded: int = 2, f64: bool = False) -> Dict:
    """Loss and gradient of one global batch over the ranks against one
    process (this rank alone, no group) on the whole batch.

    The batch has two rows a rank, distinct and random (numpy seed 7), and
    its last ``n_padded`` rows (by default the whole last rank's block)
    zero-weighted, the ragged tail in which averaging per-rank means goes
    wrong. f64: both in f64 (the f32 gradient is
    ill-conditioned, ``tests/test_torch_train.py``). Returns dict(loss_n,
    loss_1, norm_n, norm_1, cosine, grad_n, grad_1) on every rank, the
    flat gradients as numpy."""
    dtype = torch.float64 if f64 else torch.float32
    model = _seeded_model(mesh, width, f64)
    single = copy.deepcopy(model)
    batch = _global_batch(2 * mesh.size, image_size, 7, mesh.device, dtype,
                          n_padded=n_padded)
    loss_n, g_n = dp_loss_and_grads(
        model, mesh, _block(batch, mesh),
        batch_totals(batch["weights"], batch["sw"]))
    with cudnn_f32():
        vm, om = single(batch["x"])
        loss_1 = nbp_loss(single.log_vars,
                          _gather_pred_values(vm, batch["pixels"]),
                          batch["gains"], om, batch["layout"],
                          value_weight=batch["weights"],
                          sample_weight=batch["sw"])
        g_1 = torch.autograd.grad(loss_1, list(single.parameters()))

    def flat(gs: Sequence[torch.Tensor]) -> np.ndarray:
        return torch.cat([g.reshape(-1) for g in gs]).double().cpu().numpy()

    a, b = flat(g_n), flat(g_1)
    norm_n, norm_1 = float(np.linalg.norm(a)), float(np.linalg.norm(b))
    return dict(loss_n=float(loss_n), loss_1=float(loss_1.detach()),
                norm_n=norm_n, norm_1=norm_1,
                cosine=float(np.dot(a, b) / max(norm_n * norm_1, 1e-30)),
                grad_n=a, grad_1=b)
