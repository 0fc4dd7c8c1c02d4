"""SCONE pretraining: the coverage-distribution losses.

Port of the losses of ``nextbestpath_tpu/train/pretrain_scone.py`` (the
reference's SconeVis.py KLDivCE, L1 and uncentered L1; the default
``cov_loss_fn`` is ``uncentered_l1``), which the online trainer also uses.
The two pretrainers and their sample builders are not ported yet.
"""

from __future__ import annotations

import torch


def kl_div_ce(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """KL(softmax(y) || softmax(x)), batchmean."""
    logp = torch.log_softmax(x, dim=1)
    q = torch.softmax(y, dim=1)
    return (q * (torch.log(torch.clamp(q, min=1e-12)) - logp)).sum() / x.shape[0]


def normalized_l1(x: torch.Tensor, y: torch.Tensor,
                  eps: float = 1e-7) -> torch.Tensor:
    """Std-normalised L1 between coverage distributions (population std)."""
    nx = (x - x.mean(dim=1, keepdim=True)) / (
        x.std(dim=1, keepdim=True, unbiased=False) + eps)
    ny = (y - y.mean(dim=1, keepdim=True)) / (
        y.std(dim=1, keepdim=True, unbiased=False) + eps)
    return torch.abs(nx - ny).mean()


def uncentered_l1(x: torch.Tensor, y: torch.Tensor,
                  eps: float = 1e-7) -> torch.Tensor:
    """Mean-normalised L1 (the default coverage loss)."""
    nx = x / (x.mean(dim=1, keepdim=True) + eps)
    ny = y / (y.mean(dim=1, keepdim=True) + eps)
    return torch.abs(nx - ny).mean()


COV_LOSSES = {"kl_divergence": kl_div_ce, "l1": normalized_l1,
              "uncentered_l1": uncentered_l1}
