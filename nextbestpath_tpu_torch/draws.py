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

The batched random walk (``eval/random_walk.py::ScanRandomWalk``) takes
the role schedule with the roles of the JAX walk step's 5-way split
(``state.key`` and four keys): ``cov``, ``dir`` (the open neighbour's
Gumbel noise, served by ``gumbel``: ``jax.random.categorical``), ``rot``
and ``move``; ``init`` serves the initial capture. Every role is drawn
every pose, and a scene has its own provider.

The MACARONS next-best-view rollout (``eval/macarons_nbv.py``) takes the
sequential schedule, one ``begin_group`` a ``next_key()`` of the JAX
rollout: ``proxy`` (the proxy field's points), ``init`` (the initial
capture's frames); then each pose ``cov`` (one score a buffer slot), in
the learned mode ``tokens`` (``randint`` of shape (n_tokens,)), ``vs_idx``
(``randint`` of shape (n_proxy_tokens,)) and ``occ`` (SconeOcc's
permutations: ``permutation(role, N)`` from the first half of the key's
split, ``permutation(role, n_s, step=s)`` from ``fold_in`` of its second
half), ``rot`` when no candidate is valid, then ``gain`` (a candidate's
Gumbel noise of ``jax.random.categorical``'s shape from each key of a
C-way split, served by ``gumbels``) or, in the oracle mode, ``oracle`` (a
candidate frame's pixel scores from each key of the split, served by
``uniforms``), and ``move``.

The MACARONS online trainer (``train/train_macarons.py``) takes the
sequential schedule, one ``begin_group`` a ``next_key()`` of the JAX
trainer: ``proxy`` (the proxy field's points) and ``init`` (the first
move's frames); then each pose ``cov`` (one score a buffer slot); with
learned depth ``depth`` (the depth step's augmentation: ``uniforms`` of
``[[(), (), (), (), ()], ()]``, the jitter's five draws from the split of
the key's first half and the flip's from its second); with a memory, each
replay loop's ``replay`` (SconeOcc's permutations) and ``depth`` again
for the depth replay; ``frame`` (the frame's pixel scores); with the depth
error logged ``store_cov`` (one score a store slot); ``rot`` at a dead
end; ``proxy_tokens`` (``categorical``'s Gumbel noise, (n_proxy_tokens,
P)); ``tokens`` (``randint`` of shape (n_tokens,)); ``move``;
``new_frame``; ``scone`` (SconeOcc's permutations); and at a remap one
``remap`` a re-inferred frame.

The depth pretrainer (``train/pretrain_depth.py``) takes the sequential
schedule: ``begin_group("eval")`` before the held-out batch (the JAX
``PRNGKey(seed + 99991)``) and ``begin_group("batch")`` before each
step's (``fold_in(key, step + 1)``); sample b's walklet draws with
``step=b`` (``fold_in(group key, b)``), split three ways for the start,
``cell`` (``gumbel`` of shape (L H,), ``categorical``'s noise) and ``a0``
(``randint``), then again for each move, ``dir`` (``gumbel`` (4,)) and
``da`` (``randint`` in [-2, 3)).

The SCONE sample builders (``train/pretrain_scone.py``) take one ``view``
draw a view (``step`` the view: the v-th split of ``PRNGKey(seed)``), and
its pretrainers one ``begin_group("step")`` a step (the step key's split
of the running key): ``idx`` (``randint`` of shape (batch,)), then for
SconeOcc its permutations (role ``occ``, served as the online trainer's,
from the second half of the step key's split). Pose validity
(``sim/pose_validity.py``) takes one draw a call: ``pose`` (``gumbel``
over the lattice) and ``range`` (``uniform`` of the lattice's shape).

In both schedules ``step`` folds a substep's index into its group's key
(``fold_in(key, s)``), and ``uniforms`` serves several draws from the split
of one key (``k1, k2 = split(key)``, the stratified frame draw); an entry
of its shapes that is itself a list takes that half of the split and
splits it again.

``TorchDraws`` makes Gumbel noise with a generator on a card in one launch
of the hand-written kernel G1 (``kernels.gumbel_noise``) for all the shapes
of a ``gumbel`` or ``gumbels`` call: the bits, and the generator's state
after, of ``torch.rand``, ``clamp``, ``log``, ``neg``, ``log``, ``neg``
shape after shape, which a generator on the CPU still runs.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

from . import kernels

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

    def uniforms(self, role: str, shapes: Sequence, step: Optional[int] = None
                 ) -> List:
        """A draw of each shape; a list entry gives a list of draws."""
        return [self.uniforms(role, s, step) if isinstance(s, list)
                else self.uniform(role, s, step) for s in shapes]

    def gumbels(self, role: str, shapes: Sequence[Sequence[int]],
                step: Optional[int] = None) -> List[torch.Tensor]:
        """Gumbel noise of each shape, from the split of one key."""
        return self._gumbels(role, shapes, step)

    def permutation(self, role: str, n: int,
                    step: Optional[int] = None) -> torch.Tensor:
        """A random permutation of range(n), int64 on the device."""
        perm = torch.randperm(int(n), generator=self.gen,
                              device=self.gen_device)
        return perm.to(self.device)

    def gumbel(self, role: str, shape: Sequence[int],
               step: Optional[int] = None) -> torch.Tensor:
        """Standard Gumbel noise -log(-log(u)), u uniform in [tiny, 1),
        as ``jax.random.gumbel`` draws it."""
        return self._gumbels(role, [shape], step)[0]

    def _gumbels(self, role: str, shapes: Sequence[Sequence[int]],
                 step: Optional[int]) -> List[torch.Tensor]:
        """Gumbel noise of each shape in turn from the stream: one G1
        launch with a generator on a card, else the eager chain."""
        if self.gen_device.type == "cuda":
            return [g.to(self.device)
                    for g in kernels.gumbel_noise(self.gen, shapes)]
        tiny = torch.finfo(torch.float32).tiny
        return [-torch.log(-torch.log(
            self.uniform(role, s, step).clamp(min=tiny))) for s in shapes]

    def randint(self, role: str, low: IntLike, high: IntLike,
                step: Optional[int] = None,
                shape: Sequence[int] = ()) -> torch.Tensor:
        """Integers in [low, high) as an int64 tensor of ``shape`` (0-d by
        default) on the device."""
        u = self.uniform(role, shape).double()
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
