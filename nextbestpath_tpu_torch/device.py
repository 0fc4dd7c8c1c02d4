"""Device selection for the port's entry points, and the precision scopes
that hold f32 work on the card to full f32 (TF32 off)."""

from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Raises when CUDA is asked for and no card is present, rather
    than carrying on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev


@contextmanager
def cudnn_f32() -> Iterator[None]:
    """cuDNN without TF32 inside the block; the caller's flag after it."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


@contextmanager
def full_f32() -> Iterator[None]:
    """cuDNN and matmuls without TF32 inside the block (the JAX package's
    ``Precision.HIGHEST``); the caller's flags after it."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with cudnn_f32():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
