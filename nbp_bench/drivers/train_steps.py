"""The NBP trainer's optimizer steps (``train_epoch_ds``): passes over a
staged dataset, each a shuffle of its rows into micro batches, their
gradients accumulated into one AdamW step every ``accumulate`` micro
batches.

Set-up builds the training state once (the U-Net with weights drawn on
the device from the seed, AdamW, the accumulator), stages the dataset
and drives that same state through its first three optimizer steps, each
a pass over rows that no other step sees; their losses, the gradient the
first AdamW step got and the parameters' change after the three are kept
for the comparison, with the maps of the first micro step. The window
then runs whole passes over the dataset until ``seconds`` have passed.
"""

from __future__ import annotations

import gc
import random
import sys
import time
from typing import List

import torch

from .. import arith, checks, common, traffic, weights
from ..outcome import Outcome
from ..trace import Slice

FIRST_STEPS = 3


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(cell: common.Cell, seed: int, seconds: float, trace: bool,
        control: bool, device: str = "cuda") -> Outcome:
    from nextbestpath_tpu_torch.models.unet import NBP
    from nextbestpath_tpu_torch.train import train_nbp as T

    cfg, mix = cell.config, cell.mix
    dev = torch.device(device)
    model = NBP(width=int(cfg["model"]["width"]),
                dtype=getattr(torch, cfg["model"]["dtype"]))
    sd = weights.nbp_state(model.state_dict(), seed, dev)
    model.load_state_dict(sd)
    init_sd = {k: v.detach().to("cpu", copy=True) for k, v in sd.items()}
    del sd
    model = model.to(dev)
    micro, every_k = int(mix["micro_batch"]), int(mix["accumulate"])
    state = T.init_train_state(model, lr=float(cfg["optimizer"]["lr"]),
                               accumulation_steps=every_k)
    ds = traffic.dataset(mix, seed, dev)
    if dev.type == "cuda":
        # The peak from here on: the program's memory, not the drawing of
        # the weights and rows.
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    n_rows = int(mix["rows"])
    rng = random.Random(int(seed))
    names = [n for n, _ in model.named_parameters()]

    # The first steps, through the window's own call, on rows that all
    # differ; the micro batches and losses are kept as they pass.
    seen: List = []

    def keep(m, d, idx, sw):
        loss, grads = T._loss_and_grads(m, d, idx, sw)
        seen.append((idx.clone(), sw.clone(), loss))
        return loss, grads

    # The first micro step's maps, as the model returns them.
    first_maps: List = []
    hook = model.register_forward_hook(
        lambda mod, inp, out: first_maps.append(
            tuple(o.detach().clone() for o in out)) if not first_maps
        else None)
    order = list(range(n_rows))
    random.Random(int(seed) + 1).shuffle(order)
    step_rows = micro * every_k
    first_grad = None
    for s in range(FIRST_STEPS):
        T.train_epoch_ds(state, ds, order[s * step_rows:(s + 1) * step_rows],
                         rng, micro_batch=micro, loss_and_grads=keep)
        if s == 0:
            # A parameter the step left without a first moment got no
            # gradient: it reads 0.
            first_grad = torch.stack([
                (state.optimizer.state.get(p, {}).get(
                    "exp_avg", torch.zeros_like(p)) / 0.1).double().norm()
                for p in state.params]).cpu()
    hook.remove()
    change = torch.stack([(p.detach().cpu() - init_sd[n]).double().norm()
                          for n, p in zip(names, state.params)])
    prog_losses = [float(x[2]) for x in seen]
    _sync(dev)
    setup_s = common.seconds_since_start()

    pool = list(range(n_rows))
    passes = []
    prof = None
    t0 = time.perf_counter()
    k = 0
    failed = 0
    while True:
        profiled = trace and k == 1
        if profiled:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()
        ta = time.perf_counter()
        _, loss = T.train_epoch_ds(state, ds, pool, rng, micro_batch=micro)
        if profiled:
            _sync(dev)
        tb = time.perf_counter()
        if profiled:
            prof.stop()
        failed += 0 if loss == loss and abs(loss) != float("inf") else n_rows
        passes.append({"s": tb - ta, "samples": n_rows,
                       "profiled": profiled})
        k += 1
        if tb - t0 >= seconds and (k >= 2 or not trace):
            break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_reserved(dev) if dev.type == "cuda" else 0
    samples = sum(p["samples"] for p in passes)
    size = int(mix["side"])
    layer = {"window_s": window_s, "passes": passes, "samples": samples,
             "train_flops_per_sample": 3.0 * arith.unet_forward_flops(
                 1, width=int(cfg["model"]["width"]), size=size)}
    out = Outcome(attempted=samples, failed=failed,
                  e2e={"setup_s": setup_s,
                       "train_samples_per_s": samples / window_s},
                  layer=layer, checks={}, memory_peak_bytes=int(peak))
    if prof is not None:
        sl = Slice(prof, ("forward", "backward", "accumulate", "optimizer"))
        layer["slice"] = sl
        layer["slice_s"] = out.traced_s = passes[1]["s"]
        out.busy_s = sl.busy_s()
        out.breakdown = {"device_ops": sl.top_ops(),
                         "idle_gaps": sl.idle_gaps()}
        del prof

    # The program's state goes before the reference runs.
    del state, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out.checks, out.control = checks.train(
        seen, prog_losses, first_maps[0], first_grad, change, init_sd, names,
        ds, cfg, mix, dev, control)
    print(f"# {len(passes)} passes of {n_rows} rows in {window_s:.3f} s: "
          + ", ".join(f"{p['s']:.3f} s" for p in passes), file=sys.stderr)
    return out
