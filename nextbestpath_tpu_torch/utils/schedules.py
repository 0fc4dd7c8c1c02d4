"""Learning-rate schedules as plain functions of the step.

Port of ``nextbestpath_tpu/utils/schedules.py`` (the reference's
macarons/utility/utils.py optimizers): NoamOpt, ``factor d_model^-0.5
min(step^-0.5, step warmup^-1.5)``; WarmupConstantOpt, ``lr min(1, step /
warmup)``; WarmupExponentialOpt, the linear warm-up then ``gamma^(step -
warmup)``. A schedule takes a step (an int or a tensor; steps below 1 count
as 1) and returns the rate in f32, as a float for an int step.
"""

from __future__ import annotations

import torch


def _step(step) -> torch.Tensor:
    return torch.clamp(torch.as_tensor(step), min=1).to(torch.float32)


def _out(step, value: torch.Tensor):
    return value if isinstance(step, torch.Tensor) else float(value)


def noam_schedule(d_model: int, warmup: int, factor: float = 1.0):
    def schedule(step):
        s = _step(step)
        return _out(step, factor * (d_model ** -0.5) * torch.minimum(
            s ** -0.5, s * (warmup ** -1.5)))
    return schedule


def warmup_constant_schedule(lr: float, warmup: int):
    def schedule(step):
        s = _step(step)
        return _out(step, lr * torch.clamp(s / warmup, max=1.0))
    return schedule


def warmup_exponential_schedule(lr: float, warmup: int, gamma: float = 0.9999):
    def schedule(step):
        s = _step(step)
        warm = lr * torch.clamp(s / warmup, max=1.0)
        decay = torch.tensor(gamma, dtype=torch.float32) ** torch.clamp(
            s - warmup, min=0.0)
        return _out(step, warm * decay)
    return schedule
