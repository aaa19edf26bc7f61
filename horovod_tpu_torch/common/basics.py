"""Lifecycle and topology API — the port's counterpart of
``horovod_tpu/common/basics.py`` (``init`` .. ``local_num_devices``).

``init()`` reads the topology (``common/topology.py``), binds this
process's card, ``cuda:{local_rank}`` (or the CPU when the caller passes
``device="cpu"``), and, whenever the launcher environment is present,
builds the ``torch.distributed`` process group the collectives run on:
NCCL on a card, gloo on the CPU. Its rendezvous is given explicitly:
``HOROVOD_CONTROLLER_ADDR`` (``host:port``, rank 0 listens) or
``HOROVOD_RENDEZVOUS_FILE`` (a ``FileStore``); a launched job of size 1
with neither keeps an in-process store. The JAX package's controller,
native engine, timeline, metrics and elastic parts are not ported.
"""

from __future__ import annotations

import atexit
import datetime
import threading
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .. import DeviceLike
from . import config
from .topology import Topology, detect

# How long a rank waits for its peers at the rendezvous and in a
# collective before it fails.
_TIMEOUT = datetime.timedelta(seconds=300)


class _State:
    def __init__(self, topology: Topology, device: torch.device,
                 owns_group: bool):
        self.topology = topology
        self.device = device
        self.owns_group = owns_group


_state: Optional[_State] = None
_state_lock = threading.Lock()


def _store(topology: Topology):
    path = config.rendezvous_file()
    if path:
        return dist.FileStore(path, topology.size)
    addr = config.controller_addr()
    if addr:
        host, _, port = addr.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(
                f"HOROVOD_CONTROLLER_ADDR must be host:port, got {addr!r}")
        return dist.TCPStore(host, int(port), topology.size,
                             topology.rank == 0, timeout=_TIMEOUT)
    if topology.size == 1:
        return dist.HashStore()
    raise RuntimeError(
        f"a job of size {topology.size} needs a rendezvous: set "
        "HOROVOD_CONTROLLER_ADDR=host:port or HOROVOD_RENDEZVOUS_FILE")


def init(ranks: Optional[Sequence[int]] = None,
         device: DeviceLike = None) -> None:
    """Initialize. Idempotent. ``ranks`` narrows the job to a subset of
    processes; ``device=None`` binds ``cuda:{local_rank}`` and raises
    without a card, ``device="cpu"`` runs the job on the CPU (gloo)."""
    global _state
    with _state_lock:
        if _state is not None:
            return
        topology = detect(ranks)
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "horovod_tpu_torch.init: no CUDA device is available; "
                    "pass device='cpu' explicitly to run on the CPU")
            dev = torch.device("cuda", topology.device_index)
            torch.cuda.set_device(dev)
        else:
            dev = torch.device(device)
        owns_group = False
        if topology.launched and not dist.is_initialized():
            backend = "nccl" if dev.type == "cuda" else "gloo"
            kwargs = {"device_id": dev} if dev.type == "cuda" else {}
            dist.init_process_group(
                backend, store=_store(topology), rank=topology.rank,
                world_size=topology.size, timeout=_TIMEOUT, **kwargs)
            owns_group = True
        _state = _State(topology, dev, owns_group)


def shutdown() -> None:
    """Tear down the process group ``init`` built."""
    global _state
    with _state_lock:
        if _state is not None and _state.owns_group \
                and dist.is_initialized():
            dist.destroy_process_group()
        _state = None


atexit.register(shutdown)


def _ensure_initialized() -> _State:
    if _state is None:
        raise ValueError(
            "Horovod has not been initialized; use hvd.init().")
    return _state


def is_initialized() -> bool:
    return _state is not None


def device() -> torch.device:
    """The device ``init`` bound."""
    return _ensure_initialized().device


def rank() -> int:
    return _ensure_initialized().topology.rank


def size() -> int:
    return _ensure_initialized().topology.size


def local_rank() -> int:
    return _ensure_initialized().topology.local_rank


def local_size() -> int:
    return _ensure_initialized().topology.local_size


def cross_rank() -> int:
    return _ensure_initialized().topology.cross_rank


def cross_size() -> int:
    return _ensure_initialized().topology.cross_size


def num_devices() -> int:
    """Cards in the job (``torch.cuda.device_count()`` per node times
    the nodes)."""
    return _ensure_initialized().topology.num_devices


def local_num_devices() -> int:
    return _ensure_initialized().topology.local_num_devices
