"""BatchNorm folding for the NBP U-Net's eval forward.

Port of ``nextbestpath_tpu/models/fold.py``. In eval mode a BatchNorm is a
per-channel affine map with frozen running statistics, so it folds into the
convolution whose output it consumes:

    y = (W*x + b - mean) / sqrt(var + eps) * scale + bias
      = (W * s) * x + (b * s + (bias - mean * s)),   s = scale / sqrt(var + eps)

computed in f32 in the JAX package's order of operations, into the f32
parameters; a bf16 model then computes with the folded kernels cast to
bf16, as JAX ``models/fold.py`` keeps the kernel's f32 dtype. Every block of
``models.unet.NBP`` pairs each convolution with the BatchNorm after it
(``conv0``/``bn0``, ``conv``/``bn``, ``w_g``/``bn_g`` ...); the heads
``final1``/``final2`` have none.
"""

from __future__ import annotations

import copy

import torch
import torch.nn as nn

from .unet import NBP, AttentionGate, ConvBlock, UpConv

_PAIRS = {ConvBlock: (("conv0", "bn0"), ("conv1", "bn1")),
          UpConv: (("conv", "bn"),),
          AttentionGate: (("w_g", "bn_g"), ("w_x", "bn_x"),
                          ("psi", "bn_psi"))}


@torch.no_grad()
def _fold_pair(conv: nn.Conv2d, bn: nn.BatchNorm2d) -> None:
    s = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
    shift = bn.bias.float() - bn.running_mean.float() * s
    conv.weight.copy_(conv.weight.float() * s[:, None, None, None])
    conv.bias.copy_(conv.bias.float() * s + shift)


def fold_bn(model: NBP) -> NBP:
    """A copy of ``model`` in which every convolution has absorbed the
    BatchNorm that consumes it and every BatchNorm is ``nn.Identity``. The
    copy computes the eval forward; ``model`` is left as it is."""
    out = copy.deepcopy(model).eval()
    for module in out.modules():
        for conv_name, bn_name in _PAIRS.get(type(module), ()):
            bn = getattr(module, bn_name)
            if isinstance(bn, nn.BatchNorm2d):
                _fold_pair(getattr(module, conv_name), bn)
                setattr(module, bn_name, nn.Identity())
    return out
