"""The NBP dual-decoder attention U-Net (NextBestPath, ICLR 2025), as a
plain function of a state dict.

x (B, S, S, 5) NHWC -> (value map (B, S/4, S/4, 8), obstacle map
(B, S, S, 1)), both f32. The encoder is five double (3x3 convolution,
BatchNorm, ReLU) blocks with 2x max pooling between them; two decoders
start at the bottleneck, each stage a 2x nearest up-sampling, a 3x3
convolution, BatchNorm and ReLU, an attention gate on the skip
(x * sigmoid(BN(psi(relu(BN(W_g g) + BN(W_x x)))))) and a double block on
the concatenation [gated skip, up]. Decoder 1 stops at S/4 with a 1x1
head of 8 orientations; decoder 2 reaches S with a 1x1 head and a
sigmoid. BatchNorm has eps 1e-5: eval mode uses the running statistics,
train mode the batch's (biased variance).

The tensors are named as the port's ``state_dict`` names them (a format,
read here as such): ``conv_blocks.<i>.conv0``, ``.bn0`` ...,
``up_convs.<i>``, ``att_gates.<i>`` with ``w_g``, ``w_x``, ``psi`` and
their ``bn_*``, ``final1``, ``final2``.

``out_dtype`` rounds the heads' outputs (and computes the obstacle
head's sigmoid) in the dtype the configuration states for them, as the
configured network emits them; everything before the heads stays f32.

``quant="fp8"`` is the control, the precision below the bf16 that the
configuration states: every convolution's input and kernel rounded to
float8 e4m3 with a per-tensor scale (amax / 448), its bias and its output
rounded to bf16, and in the backward the gradients of its output, input
and kernel rounded to float8 e5m2 (amax / 57344), as an fp8 path that
keeps the bf16 path's other roundings would compute them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

EPS = 1e-5
E4M3_MAX = 448.0


E5M2_MAX = 57344.0


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8(torch.autograd.Function):
    """Forward: x rounded to float8 e4m3 under a per-tensor scale.
    Backward: the gradient rounded to float8 e5m2 likewise, as fp8
    training carries gradients."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


class _Fp8Grad(torch.autograd.Function):
    """Forward: x. Backward: the gradient rounded to float8 e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x in fp8 (``_Fp8``), back in x's dtype."""
    return _Fp8.apply(x)


def fp8_grad(x: torch.Tensor) -> torch.Tensor:
    return _Fp8Grad.apply(x)


class Net:
    """The forward over a dict of tensors (parameters may require grad)."""

    def __init__(self, sd: Dict[str, torch.Tensor], train: bool = False,
                 quant: Optional[str] = None,
                 out_dtype: Optional[torch.dtype] = None):
        self.sd = sd
        self.train = train
        self.quant = quant
        self.out_dtype = out_dtype
        # Train mode: each BatchNorm's batch (mean, variance) by name.
        self.stats: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    def conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        w, b = self.sd[f"{name}.weight"], self.sd[f"{name}.bias"]
        if self.quant == "fp8":
            bf = torch.bfloat16
            b = b + (b.detach().to(bf).to(b.dtype) - b.detach())
            y = F.conv2d(fp8(x), fp8(w), b, padding=w.shape[-1] // 2)
            return fp8_grad(y + (y.detach().to(bf).to(y.dtype) - y.detach()))
        return F.conv2d(x, w, b, padding=w.shape[-1] // 2)

    def bn(self, name: str, x: torch.Tensor) -> torch.Tensor:
        w, b = self.sd[f"{name}.weight"], self.sd[f"{name}.bias"]
        if self.train:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.stats[name] = (mean.detach(), var.detach())
        else:
            mean = self.sd[f"{name}.running_mean"]
            var = self.sd[f"{name}.running_var"]
        inv = torch.rsqrt(var + EPS) * w
        return (x - mean[None, :, None, None]) * inv[None, :, None, None] \
            + b[None, :, None, None]

    def block(self, i: int, x: torch.Tensor) -> torch.Tensor:
        p = f"conv_blocks.{i}"
        x = F.relu(self.bn(f"{p}.bn0", self.conv(f"{p}.conv0", x)))
        return F.relu(self.bn(f"{p}.bn1", self.conv(f"{p}.conv1", x)))

    def up(self, i: int, x: torch.Tensor) -> torch.Tensor:
        p = f"up_convs.{i}"
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        return F.relu(self.bn(f"{p}.bn", self.conv(f"{p}.conv", x)))

    def gate(self, i: int, g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        p = f"att_gates.{i}"
        a = F.relu(self.bn(f"{p}.bn_g", self.conv(f"{p}.w_g", g))
                   + self.bn(f"{p}.bn_x", self.conv(f"{p}.w_x", x)))
        return x * torch.sigmoid(self.bn(f"{p}.bn_psi",
                                         self.conv(f"{p}.psi", a)))

    def __call__(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.permute(0, 3, 1, 2).to(torch.float32)
        x1 = self.block(0, x)
        x2 = self.block(1, F.max_pool2d(x1, 2))
        x3 = self.block(2, F.max_pool2d(x2, 2))
        x4 = self.block(3, F.max_pool2d(x3, 2))
        x5 = self.block(4, F.max_pool2d(x4, 2))
        d = self.up(0, x5)
        d = self.block(5, torch.cat([self.gate(0, d, x4), d], 1))
        d = self.up(1, d)
        d = self.block(6, torch.cat([self.gate(1, d, x3), d], 1))
        out1 = self._out(self.conv("final1", d))
        e = x5
        for k, skip in enumerate((x4, x3, x2, x1)):
            e = self.up(2 + k, e)
            e = self.block(7 + k, torch.cat([self.gate(2 + k, e, skip), e],
                                            1))
        out2 = self._out(torch.sigmoid(self._out(self.conv("final2", e))))
        return out1.permute(0, 2, 3, 1), out2.permute(0, 2, 3, 1)

    def _out(self, y: torch.Tensor) -> torch.Tensor:
        """A head's output in the configuration's output dtype (its
        rounding), back in f32; the gradient passes it unchanged."""
        if self.out_dtype is None:
            return y
        return y + (y.detach().to(self.out_dtype).to(y.dtype) - y.detach())


def full_f32():
    """cuDNN and matmuls in full f32 (TF32 off) for the block; restores
    the caller's flags."""
    return _Flags()


class _Flags:
    def __enter__(self):
        self.prev = (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self.prev
        return False
