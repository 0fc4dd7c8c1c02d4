"""The rank's view of a data-parallel group.

Port of ``nextbestpath_tpu/parallel/mesh.py``. The JAX package's mesh is a
1-D ``jax.sharding.Mesh`` in one process: the batch (or the scene list) is
sharded over its axis in contiguous blocks and the weights are
replicated, and XLA inserts the collectives. Here one process (rank) runs
per device over an initialised ``torch.distributed`` group, and the
collectives are explicit (``parallel/dp.py``):

* ``Mesh``: the rank, the world size, the rank's device, the backend and
  the group;
* ``local_block``: the rank's contiguous block of a global batch (JAX
  ``P("data")`` on the leading dimension);
* ``replicate``: rank 0's tensors broadcast in place to every rank (JAX
  ``P()``), and ``same_on_all_ranks``, the check that they are equal bit
  for bit.

The reference is data parallel only, one scene per GPU (macarons_utils.py
:177-326); the largest model, the ~50M-parameter U-Net, fits on any card,
so there is no model sharding here either.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A rank of a data-parallel group. ``group`` is the process group of
    the collectives (the default group)."""

    rank: int
    size: int
    device: torch.device
    backend: str
    group: object = None


def make_mesh(n_ranks: Optional[int] = None, device: DeviceLike = "cuda"
              ) -> Mesh:
    """This rank's mesh over the initialised default group.

    n_ranks, when given, must be the world size (the JAX ``make_mesh(n)``
    raises for more devices than are visible; a process group has exactly
    its ranks). device: "cuda" (each NCCL rank takes card ``LOCAL_RANK``,
    which must exist; a gloo rank takes the card given, so that ranks
    share it only when the caller chose gloo) or "cpu". Sets the rank's
    current CUDA device."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel/multihost.py or parallel/launch.py)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_ranks is not None and n_ranks != world:
        raise ValueError(f"requested a {n_ranks}-rank mesh but the process "
                         f"group has {world} ranks")
    backend = str(dist.get_backend())
    dev = resolve_device(device)
    if dev.type == "cuda":
        if backend == "nccl":
            local = int(os.environ.get("LOCAL_RANK", rank))
            if local >= torch.cuda.device_count():
                # Two NCCL ranks on one card fail later and less clearly;
                # ranks share a card only under gloo, by the caller's
                # choice.
                raise ValueError(
                    f"NCCL rank {rank} needs card {local} but only "
                    f"{torch.cuda.device_count()} are visible; run at most "
                    "one NCCL rank a card (gloo lets ranks share one)")
            dev = torch.device("cuda", local)
        elif dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    return Mesh(rank=rank, size=world, device=dev, backend=backend,
                group=dist.group.WORLD)


def local_block(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Rows ``[r m / W, (r + 1) m / W)`` of x (m rows, a multiple of W)."""
    m = x.shape[0]
    if m % mesh.size:
        raise ValueError(f"{m} rows do not tile {mesh.size} ranks")
    per = m // mesh.size
    return x[mesh.rank * per:(mesh.rank + 1) * per]


def _by_dtype(tensors: Sequence[torch.Tensor]
              ) -> Dict[torch.dtype, List[torch.Tensor]]:
    groups: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return groups


@torch.no_grad()
def replicate(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Rank 0's values of ``tensors`` (e.g. a model's parameters and
    buffers) copied into every rank's, in place: one broadcast a dtype."""
    for ts in _by_dtype(tensors).values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, src=0, group=mesh.group)
        for t, f in zip(ts, torch.split(flat, [t.numel() for t in ts])):
            t.copy_(f.view_as(t))


_BITS = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.uint8}


@torch.no_grad()
def same_on_all_ranks(tensors: Sequence[torch.Tensor], mesh: Mesh) -> bool:
    """Whether every rank holds rank 0's ``tensors`` bit for bit (the same
    answer on every rank)."""
    differ = torch.zeros(1, dtype=torch.int32, device=mesh.device)
    for ts in _by_dtype(tensors).values():
        flat = torch.cat([t.reshape(-1) for t in ts]).to(mesh.device)
        ref = flat.clone()
        dist.broadcast(ref, src=0, group=mesh.group)
        bits = _BITS[flat.element_size()]
        if not torch.equal(flat.view(bits), ref.view(bits)):
            differ += 1
    dist.all_reduce(differ, group=mesh.group)
    return int(differ) == 0
