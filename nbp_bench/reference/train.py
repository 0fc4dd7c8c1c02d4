"""The NBP trainer's optimizer step, in plain PyTorch f32.

A micro batch of rows (idx, with row weights sw) of the staged dataset
goes through the U-Net in train mode (BatchNorm on the batch's
statistics); the loss is the paper's two-task homoscedastic loss,
MSE(values at the labelled pixels) / (2 exp(2 lv0)) + lv0 +
BCE(layout) / exp(2 lv1) + lv1, the layout clipped to [1e-7, 1 - 1e-7],
the MSE weighted by the labels' weights, the BCE averaged a row and
weighted by sw. The gradients of ``every_k`` micro batches are averaged
(a running mean, as optax.MultiSteps) and handed to AdamW (lr 1e-3,
betas 0.9 / 0.999, eps 1e-8, weight decay 0.01 on every parameter).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .unet import Net, full_f32


def loss_of(out, lv, pixels, gains, weights, layout, sw):
    vm, om = out
    b = torch.arange(vm.shape[0], device=vm.device)[:, None]
    px = pixels.long()
    pred = vm[b, px[..., 1], px[..., 2], px[..., 0]]
    mse = torch.sum((pred - gains) ** 2 * weights) / torch.clamp(
        weights.sum(), min=1.0)
    p = torch.clamp(om, 1e-7, 1.0 - 1e-7)
    bce = -(layout * torch.log(p) + (1.0 - layout) * torch.log(1.0 - p))
    per_row = bce.reshape(bce.shape[0], -1).mean(-1)
    bce = torch.sum(per_row * sw) / torch.clamp(sw.sum(), min=1.0)
    return (mse / (2.0 * torch.exp(2.0 * lv[0])) + lv[0]
            + bce / torch.exp(2.0 * lv[1]) + lv[1])


class Trainer:
    """The reference trainer over a state dict of f32 leaves."""

    def __init__(self, sd: Dict[str, torch.Tensor], params: List[str],
                 every_k: int = 7, lr: float = 1e-3, wd: float = 0.01,
                 quant: Optional[str] = None,
                 out_dtype: Optional[torch.dtype] = None):
        self.names = params
        self.out_dtype = out_dtype
        self.sd = {k: v.detach().clone().to(torch.float32)
                   for k, v in sd.items()}
        self.every_k, self.lr, self.wd = every_k, lr, wd
        self.quant = quant
        self.acc = [torch.zeros_like(self.sd[k]) for k in params]
        self.m = [torch.zeros_like(a) for a in self.acc]
        self.v = [torch.zeros_like(a) for a in self.acc]
        self.n = 0
        self.t = 0

    def micro(self, ds: Dict[str, torch.Tensor], idx: torch.Tensor,
              sw: torch.Tensor) -> float:
        """One micro step; on the k-th, the AdamW step. Returns the loss."""
        leaves = [self.sd[k].detach().requires_grad_(True)
                  for k in self.names]
        sd = dict(self.sd, **dict(zip(self.names, leaves)))
        x = ds["x"][idx].to(torch.float32)
        layout = ds["layout"][idx].to(torch.float32)[..., None]
        weights = ds["pweights"][idx] * sw[:, None]
        with full_f32():
            out = Net(sd, train=True, quant=self.quant,
                      out_dtype=self.out_dtype)(x)
            loss = loss_of(out, sd["log_vars"], ds["pixels"][idx],
                           ds["gains"][idx], weights, layout, sw)
            grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / float(self.n + 1))
            self.n += 1
            if self.n == self.every_k:
                self._adamw()
        return float(loss.detach())

    @torch.no_grad()
    def _adamw(self) -> None:
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        c1, c2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        for k, g, m, v in zip(self.names, self.acc, self.m, self.v):
            p = self.sd[k]
            p.mul_(1.0 - self.lr * self.wd)
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + eps))
            g.zero_()
        self.n = 0

    def first_grads(self) -> List[torch.Tensor]:
        """The gradient the first AdamW step got, from its first moment."""
        return [m / 0.1 for m in self.m]


def leaf_norms(ts: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack([t.double().norm() for t in ts])


def leaf_gaps(prog: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Each leaf's |program norm - reference norm| over the larger of the
    leaf's reference norm and the median leaf's."""
    return (prog - ref).abs() / torch.maximum(ref, ref.median())
