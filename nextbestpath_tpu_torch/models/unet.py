"""NBP dual-decoder attention U-Net as a PyTorch module.

Port of ``nextbestpath_tpu/models/unet.py::NBP``. The module computes in
NCHW and takes and returns NHWC at its boundary, as the JAX package's
layouts:

    forward(x (B, S, S, 5)) -> (value_map (B, S/4, S/4, 8),
                                obstacle_map (B, S, S, 1))

BatchNorm uses eps 1e-5 and runs in eval mode on the planning path. In
train mode (``model.train()``, the trainer's) it normalises by the batch
statistics and updates the running ones as flax does: flax momentum 0.9
(torch momentum 0.1) on the *biased* batch variance, where
``nn.BatchNorm2d`` would take the unbiased one (``BatchNorm`` below).
Upsampling is nearest 2x, as the JAX UpConv's
``jax.image.resize(..., "nearest")``. ``nbp_loss`` is the two-task
training loss.

Data parallelism (``parallel/dp.py``): inside ``batch_norm_group(model,
group)`` a train-mode BatchNorm takes its statistics over the global
batch of the ranks of a ``torch.distributed`` group, as flax's
``BatchNorm`` does over a GSPMD-sharded batch: the per-channel sum, sum of
squares and count are all-reduced, ``mean = E[x]`` and ``var = max(E[x^2]
- E[x]^2, 0)``, the running update is flax's, and the backward is the
global batch's gradient, with its own all-reduce (``_GlobalBatchNorm``).
Outside the context (and in eval mode) it is the single-process
BatchNorm above. ``nbp_loss(..., totals=, n_shares=)`` gives a rank's
share of the loss of a global batch.

Submodules are kept in the order flax numbers its auto-named modules
(``ConvBlock_0..10``, ``UpConv_0..5``, ``AttentionGate_0..5``), so that
``models/convert.py`` maps a flax tree onto ``state_dict`` by index.
``log_vars`` (2,), the training loss's log-variances, is a parameter here
as in the flax module, which the forward does not read.

Precision mirrors flax's ``dtype``: parameters stay f32, and with
``dtype=torch.bfloat16`` every convolution (the 1x1 gate convolutions and
the heads included) casts its input, kernel and bias to bf16 and returns
bf16; BatchNorm takes its input to f32 and returns f32; both outputs are
cast to f32. With the BatchNorms folded (``models/fold.py``) the
activations therefore stay bf16 through ReLU, pooling and the gates. The
casts are explicit, not ``torch.autocast``, so the CPU and the card give
the same dtypes. A model made f64 (``as_float64``) stays f64 throughout.

Numerics: ``NBP.forward`` runs with ``torch.backends.cudnn.allow_tf32``
off and puts the caller's setting back when it returns, so its f32
convolutions on the card run in full f32 as the reference's do (it has no
matmul). Autograd runs the backward convolutions later, outside the
forward, so the trainer puts its whole step under ``cudnn_f32`` too
(``train/train_nbp.py``).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F


@contextmanager
def cudnn_f32() -> Iterator[None]:
    """cuDNN without TF32 inside the block; the caller's flag after it."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the global batch of a process group.

    Forward: each rank's per-channel sum and sum of squares (from one
    ``var_mean`` pass) and count, one SUM all-reduce, then flax's
    statistics, ``mean = E[x]`` and ``var = max(E[x^2] - E[x]^2, 0)``, the
    running update ``0.9 r + 0.1 batch`` with the biased variance, and
    ``y = x a + (bias - mean a)`` with ``a = weight / sqrt(var + eps)``.
    Backward: the global batch's gradient, for which every rank's
    ``sum(dy)`` and ``sum(dy (x - mean))`` a channel are all-reduced (the
    backward's one all-reduce): ``dx = a dy - a sum(dy) / N - a (x - mean)
    sum(dy (x - mean)) / (N (var + eps))``; the weight and bias gradients
    are this rank's shares, which the caller's gradient all-reduce sums.
    (Autograd through the formulas themselves would keep many full-size
    intermediates and make several times the passes.)"""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, group,
                eps: float, momentum: float):
        # Few operations a layer: each is a host dispatch, and a DP micro
        # step runs 46 layers forward and back.
        c = x.shape[1]
        var_l, mean_l = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        stats = torch.cat([mean_l, torch.addcmul(var_l, mean_l, mean_l),
                           x.new_ones(1)]) * (x.numel() // c)
        dist.all_reduce(stats, group=group)
        moments = stats / stats[2 * c]
        mean, ex2 = moments[:c], moments[c:2 * c]
        var = torch.addcmul(ex2, mean, mean, value=-1.0).clamp_(min=0.0)
        invstd = torch.rsqrt(var + eps)
        a = invstd * weight
        y = torch.addcmul(torch.addcmul(bias, mean, a, value=-1.0).view(
            1, c, 1, 1), x, a.view(1, c, 1, 1))
        torch._foreach_mul_([running_mean, running_var], 1.0 - momentum)
        torch._foreach_add_([running_mean, running_var], [mean, var],
                            alpha=momentum)
        ctx.save_for_backward(x, mean, invstd, a, stats[2 * c])
        ctx.group = group
        return y

    @staticmethod
    def backward(ctx, dy):
        x, mean, invstd, a, n = ctx.saved_tensors
        c = x.shape[1]
        sum_dy = dy.sum((0, 2, 3))
        sum_dy_xmu = torch.addcmul((dy * x).sum((0, 2, 3)), mean, sum_dy,
                                   value=-1.0)
        sums = torch.cat([sum_dy, sum_dy_xmu])
        dist.all_reduce(sums, group=ctx.group)
        sums /= n
        # dx = a dy + c1 x + c0, c1 = -a invstd^2 mean(dy (x - mean)),
        # c0 = -a mean(dy) - c1 mean.
        c1 = (a * invstd * invstd).mul_(sums[c:]).neg_()
        c0 = torch.addcmul(torch.mul(a, sums[:c]), c1, mean).neg_()
        dx = torch.addcmul(torch.addcmul(c0.view(1, c, 1, 1), x,
                                         c1.view(1, c, 1, 1)),
                           dy, a.view(1, c, 1, 1))
        return (dx, sum_dy_xmu * invstd, sum_dy, None, None, None, None,
                None)


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (eps 1e-5, momentum 0.1) whose train mode updates
    the running statistics as flax's ``BatchNorm(momentum=0.9)``:
    ``running = 0.9 * running + 0.1 * batch`` with the biased batch
    variance. Eval mode is ``nn.BatchNorm2d``'s. ``group`` (set by
    ``batch_norm_group``): the process group whose global batch gives the
    train-mode statistics; None, this process's batch."""

    group = None

    def __init__(self, c: int):
        super().__init__(c, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.group is not None:
            return _GlobalBatchNorm.apply(x, self.weight, self.bias,
                                          self.running_mean, self.running_var,
                                          self.group, self.eps, self.momentum)
        y = F.batch_norm(x, None, None, self.weight, self.bias,
                         training=True, eps=self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            keep = 1.0 - self.momentum
            self.running_mean.mul_(keep).add_(mean * self.momentum)
            self.running_var.mul_(keep).add_(var * self.momentum)
        return y


@contextmanager
def batch_norm_group(model: nn.Module, group) -> Iterator[None]:
    """Inside the block every ``BatchNorm`` of ``model`` takes its
    train-mode statistics over the global batch of ``group``'s ranks;
    after it, over this process's batch again. (The group is not kept on
    the model, which ``models/fold.py`` copies.)"""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.group = group
    try:
        yield
    finally:
        for bn in bns:
            bn.group = None


class Conv(nn.Conv2d):
    """Conv2d with 'same' padding computing in ``dtype`` (flax
    ``nn.Conv(dtype=...)``): input, kernel and bias cast to it, output in
    it. The parameters stay f32."""

    def __init__(self, cin: int, cout: int, k: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, k, padding=k // 2)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        padding=self.padding)


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _norm(bn: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm in at least f32 (flax ``BatchNorm(dtype=float32)``; an
    f64 model stays f64); a folded one (``nn.Identity``) leaves x in the
    convolution's dtype."""
    if isinstance(bn, nn.Identity):
        return x
    return bn(_at_least_f32(x))


class ConvBlock(nn.Module):
    """(Conv3x3 -> BN -> ReLU) x 2."""

    def __init__(self, cin: int, cout: int, dtype=torch.float32):
        super().__init__()
        self.conv0 = Conv(cin, cout, 3, dtype)
        self.bn0 = BatchNorm(cout)
        self.conv1 = Conv(cout, cout, 3, dtype)
        self.bn1 = BatchNorm(cout)

    def forward(self, x):
        x = F.relu(_norm(self.bn0, self.conv0(x)))
        return F.relu(_norm(self.bn1, self.conv1(x)))


class UpConv(nn.Module):
    """2x nearest upsample -> Conv3x3 -> BN -> ReLU."""

    def __init__(self, cin: int, cout: int, dtype=torch.float32):
        super().__init__()
        self.conv = Conv(cin, cout, 3, dtype)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        return F.relu(_norm(self.bn, self.conv(x)))


class AttentionGate(nn.Module):
    """x * sigmoid(BN(psi(relu(BN(W_g g) + BN(W_x x)))))."""

    def __init__(self, cg: int, cx: int, f_int: int, dtype=torch.float32):
        super().__init__()
        self.w_g = Conv(cg, f_int, 1, dtype)
        self.bn_g = BatchNorm(f_int)
        self.w_x = Conv(cx, f_int, 1, dtype)
        self.bn_x = BatchNorm(f_int)
        self.psi = Conv(f_int, 1, 1, dtype)
        self.bn_psi = BatchNorm(1)

    def forward(self, g, x):
        a = F.relu(_norm(self.bn_g, self.w_g(g))
                   + _norm(self.bn_x, self.w_x(x)))
        return x * torch.sigmoid(_norm(self.bn_psi, self.psi(a)))


class NBP(nn.Module):
    """Dual-decoder attention U-Net; NHWC in, NHWC out (f32), computing
    in ``dtype`` (f32 or bf16; module docstring)."""

    def __init__(self, img_ch: int = 5, output_ch1: int = 8,
                 output_ch2: int = 1, width: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"NBP computes in float32 or bfloat16, not "
                             f"{dtype}")
        self.dtype = dtype
        w = width
        # Flax creation order: encoder, then decoder 1, then decoder 2.
        blocks = [(img_ch, w), (w, 2 * w), (2 * w, 4 * w), (4 * w, 8 * w),
                  (8 * w, 16 * w),
                  (16 * w, 8 * w), (8 * w, 4 * w),                      # dec 1
                  (16 * w, 8 * w), (8 * w, 4 * w), (4 * w, 2 * w),       # dec 2
                  (2 * w, w)]
        self.conv_blocks = nn.ModuleList(ConvBlock(a, b, dtype)
                                         for a, b in blocks)
        ups = [(16 * w, 8 * w), (8 * w, 4 * w),
               (16 * w, 8 * w), (8 * w, 4 * w), (4 * w, 2 * w), (2 * w, w)]
        self.up_convs = nn.ModuleList(UpConv(a, b, dtype) for a, b in ups)
        gates = [(8 * w, 8 * w, 4 * w), (4 * w, 4 * w, 2 * w),
                 (8 * w, 8 * w, 4 * w), (4 * w, 4 * w, 2 * w),
                 (2 * w, 2 * w, w), (w, w, w // 2)]
        self.att_gates = nn.ModuleList(AttentionGate(*g, dtype=dtype)
                                       for g in gates)
        self.final1 = Conv(4 * w, output_ch1, 1, dtype)
        self.final2 = Conv(w, output_ch2, 1, dtype)
        self.log_vars = nn.Parameter(torch.zeros(2))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        with cudnn_f32():
            return self._forward(x)

    def _forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cb, up, ag = self.conv_blocks, self.up_convs, self.att_gates
        x = x.permute(0, 3, 1, 2)
        x1 = cb[0](x)
        x2 = cb[1](F.max_pool2d(x1, 2))
        x3 = cb[2](F.max_pool2d(x2, 2))
        x4 = cb[3](F.max_pool2d(x3, 2))
        x5 = cb[4](F.max_pool2d(x4, 2))

        d5 = up[0](x5)
        d5 = cb[5](torch.cat([ag[0](d5, x4), d5], dim=1))
        d4 = up[1](d5)
        d4 = cb[6](torch.cat([ag[1](d4, x3), d4], dim=1))
        out1 = self.final1(d4)

        e5 = up[2](x5)
        e5 = cb[7](torch.cat([ag[2](e5, x4), e5], dim=1))
        e4 = up[3](e5)
        e4 = cb[8](torch.cat([ag[3](e4, x3), e4], dim=1))
        e3 = up[4](e4)
        e3 = cb[9](torch.cat([ag[4](e3, x2), e3], dim=1))
        e2 = up[5](e3)
        e2 = cb[10](torch.cat([ag[5](e2, x1), e2], dim=1))
        out2 = torch.sigmoid(self.final2(e2))
        return (_at_least_f32(out1).permute(0, 2, 3, 1),
                _at_least_f32(out2).permute(0, 2, 3, 1))


def as_float64(model: NBP) -> NBP:
    """``model``, in place, computing in f64 throughout: parameters, running
    statistics and every convolution. The checks take it as the reference
    evaluation of a training step, whose f32 gradients are ill-conditioned
    (BatchNorm on batch statistics)."""
    model.double()
    for m in model.modules():
        if isinstance(m, Conv):
            m.compute_dtype = torch.float64
    return model


def nbp_loss(log_vars: torch.Tensor, pred_values: torch.Tensor,
             target_values: torch.Tensor, pred_layout: torch.Tensor,
             target_layout: torch.Tensor,
             value_weight: Optional[torch.Tensor] = None,
             sample_weight: Optional[torch.Tensor] = None,
             totals: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
             n_shares: int = 1) -> torch.Tensor:
    """Homoscedastic two-task loss (JAX ``nbp_loss``):
    MSE(values) / (2 sigma1^2) + lv0 + BCE(layout) / sigma2^2 + lv1, with
    sigma_i^2 = exp(2 lv_i) and the layout clipped to [1e-7, 1 - 1e-7].
    ``value_weight`` masks padded value-pixel slots; ``sample_weight`` (B,)
    masks padded batch rows in the layout BCE.

    A rank's share of a global batch's loss (both weights given):
    ``totals`` = (sum of value_weight, sum of sample_weight) over the
    global batch, the denominators, and ``n_shares`` = the ranks, which
    share the log-variance terms; the shares sum to the global loss."""
    sigma1_sq = torch.exp(2.0 * log_vars[0])
    sigma2_sq = torch.exp(2.0 * log_vars[1])
    if totals is not None:
        if value_weight is None or sample_weight is None:
            raise ValueError("a loss share needs both weights")
        value_total, sample_total = totals
        log_vars = log_vars / n_shares
    se = (pred_values - target_values) ** 2
    if value_weight is not None:
        if totals is None:
            value_total = torch.sum(value_weight)
        mse = torch.sum(se * value_weight) / torch.clamp(value_total,
                                                         min=1.0)
    else:
        mse = torch.mean(se)
    eps = 1e-7
    p = torch.clamp(pred_layout, eps, 1.0 - eps)
    bce_map = -(target_layout * torch.log(p)
                + (1.0 - target_layout) * torch.log(1.0 - p))
    if sample_weight is not None:
        if totals is None:
            sample_total = torch.sum(sample_weight)
        per_sample = bce_map.reshape(bce_map.shape[0], -1).mean(dim=-1)
        bce = torch.sum(per_sample * sample_weight) / torch.clamp(
            sample_total, min=1.0)
    else:
        bce = torch.mean(bce_map)
    loss1 = mse / (2.0 * sigma1_sq) + log_vars[0]
    loss2 = bce / sigma2_sq + log_vars[1]
    return loss1 + loss2
