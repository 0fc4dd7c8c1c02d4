"""Random draws of the rollouts, served by role or in sequence.

Every stochastic stage of the port takes its random numbers as explicit
tensors, so that a test can hand it the JAX package's own draws and compare
decisions one for one. A provider serves them under one of two schedules,
those of the JAX host rollout's two modes:

*The role schedule* (``shared_rng=True``, and the scan rollout). The caller
calls ``begin_pose()`` once a pose; the pose's draws then come from one key
per role, as the JAX rollout splits its key seven ways:

* ``init``  the initial capture's frames (one key, one fold per substep),
* ``cov``   the coverage metric's stride subsample (start and stride),
* ``obs``   the loop-start frame's pixel scores,
* ``rot``   the random rotation when no path was found,
* ``rot2``  the anti-revisit random rotation,
* ``move``  the move's frames (one key, one fold per substep),
* ``plan``  the orientation pick's random scores.

*The sequential schedule* (``shared_rng=False``, the JAX default, and the
random walk). The caller calls ``begin_group(role)`` before each group of
draws that the JAX rollout takes from one ``_next_key()``, in the JAX
rollout's order: the initial capture; then each pose ``cov`` (one score a
buffer slot), ``obs``, one ``plan`` group per planning attempt, ``rot`` or
``rot2`` when taken, and ``move``. The role names the group; it does not
select a key.

The host-loop training collection (``train/collection.py``) takes the
sequential schedule, with the Boltzmann pick of its first candidate as one
``goal`` group served by ``gumbel`` (``jax.random.categorical``'s noise).

The scan trainer's collection (``train/scan_collection.py``) takes the role
schedule with its own role set, one role for each key of the JAX
collection step's 8-way split (``state.key`` and seven keys): ``cov``,
``obs``, ``bolt`` (the Boltzmann pick, served by ``gumbel``), ``pick`` (the
orientations' uniforms), ``u`` (the rotation override's ``uniform``),
``rot`` (its ``randint``) and ``move``; ``init`` serves the initial
capture (the JAX ``k0``). Every role is drawn every pose.

In both schedules ``step`` folds a substep's index into its group's key
(``fold_in(key, s)``), and ``uniforms`` serves several draws from the split
of one key (``k1, k2 = split(key)``, the stratified frame draw).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

IntLike = Union[int, torch.Tensor]


class TorchDraws:
    """The port's default provider: a ``torch.Generator`` on ``device``,
    which serves every draw of either schedule from one stream.

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
        """One stream serves every role: nothing to re-key per pose."""

    def begin_group(self, role: str) -> None:
        """One stream serves every group: nothing to re-key per group."""

    def uniform(self, role: str, shape: Sequence[int],
                step: Optional[int] = None) -> torch.Tensor:
        u = torch.rand(tuple(shape), generator=self.gen,
                       device=self.gen_device)
        return u.to(self.device)

    def uniforms(self, role: str, shapes: Sequence[Sequence[int]],
                 step: Optional[int] = None) -> List[torch.Tensor]:
        return [self.uniform(role, s, step) for s in shapes]

    def gumbel(self, role: str, shape: Sequence[int],
               step: Optional[int] = None) -> torch.Tensor:
        """Standard Gumbel noise -log(-log(u)), u uniform in [tiny, 1),
        as ``jax.random.gumbel`` draws it."""
        tiny = torch.finfo(torch.float32).tiny
        u = self.uniform(role, shape, step).clamp(min=tiny)
        return -torch.log(-torch.log(u))

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


def frame_draws(draws, role: str, n_px: int, n_slots: int, stratified: bool,
                step: Optional[int] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A frame's draws: pixel scores (n_px,) and, for the stratified draw
    (``sim.sensor.stratified_applies``), the strata's ranks (n_slots,) from
    the split of the same key; None in place of the ranks for the iid
    draw."""
    if stratified:
        scores, ranks = draws.uniforms(role, ((n_px,), (n_slots,)), step=step)
        return scores, ranks
    return draws.uniform(role, (n_px,), step=step), None
