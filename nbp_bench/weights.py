"""Weights made on the device from the seed.

The NBP U-Net's convolutions are drawn with PyTorch's default
initialisation (uniform in +-1/sqrt(fan_in), kernels and biases alike),
the distribution of the port's ``seeded_train_model``, from which a
training run starts: in two calls of a generator on the card (one for
the kernels, one for the biases), scaled leaf by leaf. BatchNorm starts
as the identity (weight 1, bias 0, running mean 0 and variance 1).
"""

from __future__ import annotations

from typing import Dict

import torch


def draw_seed(seed: int, salt: int) -> int:
    """A generator seed for one purpose of a run's seed."""
    return (int(seed) * 1_000_003 + int(salt)) % (2 ** 63)


def nbp_state(template: Dict[str, torch.Tensor], seed: int, device
              ) -> Dict[str, torch.Tensor]:
    """A full state dict with ``template``'s names and shapes (the port's
    ``NBP.state_dict()``), f32 on ``device``, drawn from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(draw_seed(seed, 1))
    kernels = [k for k, v in template.items()
               if k.endswith(".weight") and v.dim() == 4]
    biases = [k[:-len("weight")] + "bias" for k in kernels]
    n_k = sum(template[k].numel() for k in kernels)
    n_b = sum(template[k].numel() for k in biases)
    wk = torch.rand(n_k, generator=gen, device=device) * 2.0 - 1.0
    wb = torch.rand(n_b, generator=gen, device=device) * 2.0 - 1.0
    out: Dict[str, torch.Tensor] = {}
    ok = ob = 0
    for kw, kb in zip(kernels, biases):
        shape = template[kw].shape
        scale = template[kw][0].numel() ** -0.5
        n = template[kw].numel()
        out[kw] = (wk[ok:ok + n] * scale).view(shape)
        ok += n
        n = template[kb].numel()
        out[kb] = (wb[ob:ob + n] * scale).view(template[kb].shape)
        ob += n
    for k, v in template.items():
        if k in out:
            continue
        one = k.endswith(("running_var", ".weight"))
        out[k] = (torch.ones if one else torch.zeros)(v.shape, dtype=v.dtype,
                                                      device=device)
    return out


def model_inputs(n: int, side: int, channels: int, seed: int, salt: int,
                 device, occupied: float = 0.3):
    """(n, side, side, channels) f32 count images, as the projections
    make them: a share ``occupied`` of the pixels holds 1 to 4 points."""
    gen = torch.Generator(device=device)
    gen.manual_seed(draw_seed(seed, salt))
    u = torch.rand((2, n, side, side, channels), generator=gen,
                   device=device)
    return (torch.floor(u[0] * 4.0) + 1.0) * (u[1] < occupied)
