"""ResNet-18 building blocks as PyTorch modules (NCHW).

Port of ``nextbestpath_tpu/models/resnet.py``: ``BasicBlock``,
``ResNetLayer``, ``ResNetStem`` and ``maxpool_stem``. Submodules carry
flax's names (``Conv_0``, ``BatchNorm_0``, ``BasicBlock_1``, ...), so
``models/convert.py`` maps a flax tree onto ``state_dict`` by name.

Padding is flax's. ``Conv(padding="SAME")`` pads each side from the input
size, ``pad = max((ceil(n / s) - 1) s + k - n, 0)`` split low ``pad // 2``,
high the rest: a 3x3 stride-2 convolution pads (0, 1) on an even side and
(1, 1) on an odd one, and a 1x1 stride-2 one pads nothing. The stem is 7x7
stride 2 with (3, 3), and the max pool 3x3 stride 2 with (1, 1) of -inf.

``BatchNorm`` is flax's ``nn.BatchNorm(use_running_average=not train)``,
and the mode is the ``train`` argument that every forward here takes (flax's
``train``), never ``module.train()``. With ``train=False`` (the default, and
the online trainer's, which applies ManyDepth so even while it takes
gradients) it is ``(x - mean) * (rsqrt(var + 1e-5) * scale) + bias`` from the
running statistics. With ``train=True`` (the depth pretrainer's) it
normalises by the batch's statistics over (N, H, W), ``mean = E[x]`` and
``var = max(E[x^2] - E[x]^2, 0)``, and moves the running ones in place as
flax's default momentum 0.99 does: ``running = 0.99 running + 0.01 batch``,
with the biased variance. A module applied twice in one forward moves them
twice, in call order, as flax's mutable ``batch_stats`` does.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

Padding = Union[str, Sequence[Tuple[int, int]]]


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """flax ``SAME`` padding (low, high) of one side of n."""
    out = -(-n // s)
    pad = max((out - 1) * s + k - n, 0)
    return pad // 2, pad - pad // 2


class Conv(nn.Conv2d):
    """flax ``nn.Conv`` on NCHW: ``padding`` "SAME" or explicit ((top,
    bottom), (left, right)); a kernel (O, I, kh, kw)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: Padding = "SAME", bias: bool = True):
        super().__init__(cin, cout, k, stride=stride, padding=0, bias=bias)
        self.k = k
        self.pad_mode = padding

    def _pads(self, x: torch.Tensor):
        if self.pad_mode == "SAME":
            s = self.stride[0]
            return (same_pads(x.shape[-2], self.k, s),
                    same_pads(x.shape[-1], self.k, s))
        return tuple(tuple(p) for p in self.pad_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (pt, pb), (pl, pr) = self._pads(x)
        if pt == pb and pl == pr:
            return F.conv2d(x, self.weight, self.bias, self.stride, (pt, pl))
        x = F.pad(x, (pl, pr, pt, pb))
        return F.conv2d(x, self.weight, self.bias, self.stride)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` (module docstring): the running statistics,
    or with ``train`` the batch's, the running ones moved in place."""

    momentum = 0.99  # flax's default

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        def c(v):
            return v[None, :, None, None]

        if not train:
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight
            return (x - c(self.running_mean)) * c(mul) + c(self.bias)
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
            self.running_var.mul_(m).add_(var.detach(), alpha=1.0 - m)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - c(mean)) * c(mul) + c(self.bias)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, features: int, strides: int = 1):
        super().__init__()
        self.Conv_0 = Conv(cin, features, 3, strides, bias=False)
        self.BatchNorm_0 = BatchNorm(features)
        self.Conv_1 = Conv(features, features, 3, bias=False)
        self.BatchNorm_1 = BatchNorm(features)
        # flax builds the shortcut when the residual's shape differs,
        # which is when the stride or the width changes.
        self.shortcut = strides != 1 or cin != features
        if self.shortcut:
            self.Conv_2 = Conv(cin, features, 1, strides, bias=False)
            self.BatchNorm_2 = BatchNorm(features)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = self.BatchNorm_1(self.Conv_1(y), train)
        res = self.BatchNorm_2(self.Conv_2(x), train) if self.shortcut else x
        return torch.relu(y + res)


class ResNetLayer(nn.Module):
    """Two BasicBlocks, the first possibly strided (ResNet-18 layout)."""

    def __init__(self, cin: int, features: int, strides: int = 1):
        super().__init__()
        self.BasicBlock_0 = BasicBlock(cin, features, strides)
        self.BasicBlock_1 = BasicBlock(features, features, 1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.BasicBlock_1(self.BasicBlock_0(x, train), train)


class ResNetStem(nn.Module):
    """conv1 (7x7 s2, padding (3, 3)) + bn + relu; the caller pools."""

    def __init__(self, cin: int = 3):
        super().__init__()
        self.Conv_0 = Conv(cin, 64, 7, 2, padding=((3, 3), (3, 3)),
                           bias=False)
        self.BatchNorm_0 = BatchNorm(64)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return torch.relu(self.BatchNorm_0(self.Conv_0(x), train))


def maxpool_stem(x: torch.Tensor) -> torch.Tensor:
    """torch's maxpool(3, stride 2, padding 1): flax's max_pool with
    (1, 1) padding of -inf."""
    return F.max_pool2d(x, 3, stride=2, padding=1)
