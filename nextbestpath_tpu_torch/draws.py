"""Random draws of the rollout, served by role.

Every stochastic stage of the port takes its random numbers as explicit
tensors, so that a test can hand it the JAX package's own draws and compare
decisions one for one. A provider serves them by role, one set of roles per
pose, as the JAX host rollout derives them in ``shared_rng`` mode:

* ``init``  the initial capture's frames (one uniform vector per substep),
* ``cov``   the coverage metric's stride subsample (start and stride),
* ``obs``   the loop-start frame's pixel scores,
* ``rot``   the random rotation when no path was found,
* ``rot2``  the anti-revisit random rotation,
* ``move``  the move's frames (one uniform vector per substep),
* ``plan``  the orientation pick's random scores.

``step`` distinguishes several draws of one role within a pose (a move's
substeps, the stride of the subsample).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

IntLike = Union[int, torch.Tensor]


class TorchDraws:
    """The port's default provider: a ``torch.Generator`` on ``device``.

    ``generator_device`` may differ from ``device`` (a CPU generator with
    draws moved to the card gives the same numbers on both devices). Draws
    stay on the device: ``randint`` takes tensor or host bounds and, with a
    generator on the device, never syncs.
    """

    def __init__(self, seed: int, device: torch.device,
                 generator_device: Optional[torch.device] = None):
        self.device = torch.device(device)
        self.gen_device = torch.device(generator_device or self.device)
        self.gen = torch.Generator(device=self.gen_device)
        self.gen.manual_seed(int(seed))

    def begin_pose(self) -> None:
        """Roles are drawn from one stream; nothing to re-key per pose."""

    def uniform(self, role: str, shape: Sequence[int],
                step: Optional[int] = None) -> torch.Tensor:
        u = torch.rand(tuple(shape), generator=self.gen,
                       device=self.gen_device)
        return u.to(self.device)

    def randint(self, role: str, low: IntLike, high: IntLike,
                step: Optional[int] = None) -> torch.Tensor:
        """Integer in [low, high) as a 0-d int64 tensor on the device."""
        u = self.uniform(role, ()).double()
        lo, hi = (x.long() if isinstance(x, torch.Tensor) else int(x)
                  for x in (low, high))
        # Host bounds stay host scalars: no copy to the device.
        span = hi - lo
        span = (span.clamp(min=1) if isinstance(span, torch.Tensor)
                else max(span, 1))
        return lo + torch.clamp(torch.floor(u * span).long(), max=span - 1)
