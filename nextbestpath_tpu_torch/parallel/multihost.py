"""Process-group initialisation for several hosts or cards.

Port of ``nextbestpath_tpu/parallel/multihost.py``. The JAX package starts
``jax.distributed`` from its coordinator variables or SLURM's; the port
starts a ``torch.distributed`` process group, one process (rank) a
device, from explicit arguments, then torchrun's ``MASTER_ADDR`` /
``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK``, then SLURM's
variables (the reference's ``idr_torch`` scheme). ``parallel/mesh.py``
then makes the rank's mesh. Metrics reduce with ``reduce_mean``.
"""

from __future__ import annotations

import datetime
import os
import re
import subprocess
from typing import Optional

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device


def _first_slurm_host(nodelist: str) -> str:
    """First hostname of a SLURM nodelist, expanding the compressed form.

    'nid[001234-001237]' -> 'nid001234' (not the bare prefix 'nid', which
    naive split-on-'[' yields: a hostname that does not exist, on which
    every rank's initialisation hangs). Prefers `scontrol show hostnames`
    as the reference's idr_torch setup does; falls back to parsing the
    first bracket range (zero-padding kept)."""
    try:
        out = subprocess.run(["scontrol", "show", "hostnames", nodelist],
                             capture_output=True, text=True, timeout=10)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.split()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    m = re.match(r"([^\[,]+)(?:\[([^\]]+)\])?", nodelist)
    prefix, inner = m.group(1), m.group(2)
    if not inner:
        return prefix
    first = inner.split(",")[0].split("-")[0]
    return prefix + first


def default_backend(device: torch.device) -> str:
    """NCCL for CUDA ranks, gloo on the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def maybe_initialize_distributed(coordinator_address: Optional[str] = None,
                                 num_processes: Optional[int] = None,
                                 process_id: Optional[int] = None,
                                 backend: Optional[str] = None,
                                 device: DeviceLike = "cuda",
                                 timeout_s: float = 1800.0) -> bool:
    """Start the default process group when a coordinator is known.

    Honors explicit args (``coordinator_address`` "host:port"), then
    ``MASTER_ADDR``/``MASTER_PORT`` with ``WORLD_SIZE``/``RANK`` (torchrun),
    then ``SLURM_JOB_NODELIST`` with ``SLURM_NTASKS``/``SLURM_PROCID``.
    Sets ``LOCAL_RANK`` when the launcher did not (``SLURM_LOCALID``, else
    the rank modulo the visible cards), which ``make_mesh`` reads. backend:
    "nccl" or "gloo", by default NCCL on the card and gloo on the CPU.
    Returns True when initialised, False when no coordinator is set.
    Raises ValueError for a coordinator without a process count or rank,
    and for a rank out of range."""
    addr = coordinator_address
    if addr is None and "MASTER_ADDR" in os.environ:
        addr = (f"{os.environ['MASTER_ADDR']}:"
                f"{os.environ.get('MASTER_PORT', '29500')}")
    from_slurm = False
    if addr is None and "SLURM_JOB_NODELIST" in os.environ:
        # The allocation's first node coordinates; the port carries a
        # per-job component so that two jobs sharing a first node do not
        # collide (idr_torch's MASTER_PORT scheme).
        node = _first_slurm_host(os.environ["SLURM_JOB_NODELIST"])
        port = 12345 + int(os.environ.get("SLURM_JOB_ID", "0")) % 20000
        addr = f"{node}:{port}"
        from_slurm = True
    if addr is None:
        return False
    n_env = os.environ.get("WORLD_SIZE", os.environ.get("SLURM_NTASKS"))
    pid_env = os.environ.get("RANK", os.environ.get("SLURM_PROCID"))
    if not from_slurm and ((num_processes is None and n_env is None)
                           or (process_id is None and pid_env is None)):
        # Without a count and a rank every process would claim rank 0 of a
        # one-process job, or wait for ranks that never come: fail fast.
        raise ValueError(
            "a coordinator address is set but WORLD_SIZE/RANK are not; "
            "export both (or pass num_processes and process_id, or run "
            "under torchrun or SLURM)")
    n = num_processes or int(n_env or "1")
    pid = process_id if process_id is not None else int(pid_env or "0")
    if not 0 <= pid < n:
        raise ValueError(f"process_id {pid} out of range for {n} processes")
    dev = resolve_device(device)
    if "LOCAL_RANK" not in os.environ:
        local = os.environ.get("SLURM_LOCALID")
        if local is None:
            cards = torch.cuda.device_count() if dev.type == "cuda" else 1
            local = pid % max(cards, 1)
        os.environ["LOCAL_RANK"] = str(local)
    dist.init_process_group(backend or default_backend(dev),
                            init_method=f"tcp://{addr}", world_size=n,
                            rank=pid,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean of ``x`` over the ranks of ``group`` (the default group when
    None): the reference's ``reduce_tensor`` (macarons_utils.py:235-240).
    A SUM all-reduce and a division, since gloo has no average."""
    y = x.clone()
    dist.all_reduce(y, group=group)
    return y / dist.get_world_size(group)
