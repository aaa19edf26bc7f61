"""Process and device topology — the port's copy of
``horovod_tpu/common/topology.py``.

Precedence, as there:
  1. ``HOROVOD_RANK``/``HOROVOD_SIZE`` (or OpenMPI's ``OMPI_COMM_WORLD_*``,
     or ``PMI_*``), then ``HOROVOD_LOCAL_*`` and ``HOROVOD_CROSS_*``;
  2. no launcher environment: rank 0 of 1.
Half-set launcher env (rank without size, or size without rank) raises.
The JAX process model of step 2 there has no counterpart: a torch job is
one process per card, launched with the environment above.

Device counts come from ``torch.cuda.device_count()``: one process binds
one card, ``cuda:{local_rank}`` — or ``cuda:0`` when
``CUDA_VISIBLE_DEVICES`` names a single card (``horovodrun
--bind-chips`` gives each local rank its own).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from .config import env_str

RANK_VARS = ("HOROVOD_RANK", "OMPI_COMM_WORLD_RANK", "PMI_RANK")
SIZE_VARS = ("HOROVOD_SIZE", "OMPI_COMM_WORLD_SIZE", "PMI_SIZE")


def _first_env_int(names: Sequence[str]) -> Optional[int]:
    for name in names:
        val = env_str(name)
        if val is not None and val.strip():
            try:
                return int(val)
            except ValueError:
                pass
    return None


@dataclasses.dataclass(frozen=True)
class Topology:
    """Immutable view of the job topology, fixed at ``init()``."""

    rank: int
    size: int
    local_rank: int
    local_size: int
    cross_rank: int
    cross_size: int
    num_devices: int = 0
    local_num_devices: int = 0
    # True when the launcher environment set rank and size (a process
    # group is built then, even at size 1).
    launched: bool = False
    # The card this process binds: the launcher's local rank (kept when
    # init(ranks=...) renumbers the job).
    device_index: int = 0

    def validate(self) -> None:
        if not (0 <= self.rank < self.size):
            raise ValueError(f"rank {self.rank} out of range for size {self.size}")
        if not (0 <= self.local_rank < self.local_size):
            raise ValueError(
                f"local_rank {self.local_rank} out of range for local_size "
                f"{self.local_size}")


def _device_index(local_rank: int) -> int:
    """The card this process binds: ``cuda:{local_rank}``, or the one
    card ``CUDA_VISIBLE_DEVICES`` leaves it."""
    visible = (env_str("CUDA_VISIBLE_DEVICES") or "").strip()
    if visible and "," not in visible:
        return 0
    return local_rank


def detect(ranks: Optional[Sequence[int]] = None) -> Topology:
    """Discover the topology. ``ranks`` narrows the job to a subset of
    processes, renumbered in the order given."""
    rank = _first_env_int(RANK_VARS)
    size = _first_env_int(SIZE_VARS)
    if (rank is None) != (size is None):
        # Half-set launcher env is a misconfiguration, not a fallback case:
        # silently training as rank 0 of 1 on every host corrupts results.
        raise RuntimeError(
            "partially-set launcher environment: exactly one of rank/size is "
            f"present (rank={rank}, size={size}); set both HOROVOD_RANK and "
            "HOROVOD_SIZE (or neither, for a single process)")
    launched = rank is not None
    if not launched:
        rank, size = 0, 1

    local_num_devices = torch.cuda.device_count()

    local_rank = _first_env_int(
        ["HOROVOD_LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_RANK"])
    local_size = _first_env_int(
        ["HOROVOD_LOCAL_SIZE", "OMPI_COMM_WORLD_LOCAL_SIZE"])
    if local_rank is None or local_size is None:
        local_rank, local_size = 0, 1

    cross_rank = _first_env_int(["HOROVOD_CROSS_RANK"])
    cross_size = _first_env_int(["HOROVOD_CROSS_SIZE"])
    if cross_rank is None or cross_size is None:
        # Homogeneous assumption: every node runs local_size ranks.
        cross_rank = rank // max(local_size, 1)
        cross_size = (size + local_size - 1) // max(local_size, 1)
    num_devices = local_num_devices * cross_size

    if ranks:
        ranks = list(ranks)
        if sorted(set(ranks)) != sorted(ranks):
            raise ValueError("init(ranks=...) must not contain duplicates")
        if rank not in ranks:
            raise RuntimeError(
                f"process rank {rank} not in init(ranks={ranks}): processes "
                "outside the subset must not call horovod APIs")
        new_rank = ranks.index(rank)
        topo = Topology(
            rank=new_rank, size=len(ranks), local_rank=0, local_size=1,
            cross_rank=new_rank, cross_size=len(ranks),
            num_devices=num_devices, local_num_devices=local_num_devices,
            launched=launched, device_index=_device_index(local_rank))
        topo.validate()
        return topo

    topo = Topology(
        rank=rank, size=size, local_rank=local_rank, local_size=local_size,
        cross_rank=cross_rank, cross_size=cross_size,
        num_devices=num_devices, local_num_devices=local_num_devices,
        launched=launched, device_index=_device_index(local_rank))
    topo.validate()
    return topo
