"""Lifecycle and topology API — the port's counterpart of
``horovod_tpu/common/basics.py`` (``init`` .. ``local_num_devices``).

``init()`` reads the topology (``common/topology.py``), binds this
process's card, ``cuda:{local_rank}`` (or the device the caller passes,
e.g. ``device="cpu"``), and builds the job's two tiers:

* the **process group** (``torch.distributed``: NCCL on a card, gloo on
  the CPU), whenever the launcher environment is present and no group
  exists yet. Its rendezvous is given explicitly:
  ``HOROVOD_SPMD_COORDINATOR`` (``host:port``, a ``TCPStore`` rank 0
  listens on) or ``HOROVOD_RENDEZVOUS_FILE`` (a ``FileStore``); a
  launched job of size 1 with neither keeps an in-process store. The
  code whose JAX counterpart runs inside ``jit``/``shard_map`` calls it,
  and so does every ``group=`` collective;
* the **controller** of the eager tier, when the job has more than one
  rank — the JAX rule: the native engine (``controller/native.py``, the
  C++ engine over the TCP ring) whenever the launcher exported ring
  addresses, unless ``HOROVOD_ENGINE=python`` or ``HOROVOD_CPU_OPS=star``;
  else the Python controller (``controller/controller.py``, on the ring
  or, under ``HOROVOD_CPU_OPS=star``, the TCP star) when
  ``HOROVOD_CONTROLLER_ADDR`` was exported. The world-group collectives
  of ``horovod_tpu_torch.torch`` then run through it. If it fails to
  start (the native core fails to build, ``HOROVOD_ENGINE=native``
  without ring addresses), ``init()`` raises; nothing falls back to
  another plane. Rank 0 writes the timeline (``HOROVOD_TIMELINE``): the
  engine's C++ writer under the native engine, the Python one otherwise.

Outside elastic mode the controller runs beside the process group,
never instead of it: a launched job of more than one rank needs the
group's rendezvous too.

Under elastic membership (``HOROVOD_ELASTIC=1``, ``horovodrun
--elastic``) the controller runs *instead of* the group: the job builds
no ``torch.distributed`` process group, because that group is a static
world (a dead rank wedges it and a joiner cannot enter it). Every
world-group call rides the controller, which is always the Python one
(an exported native engine is overridden with a warning: its ring is
fixed-membership), and ``group=`` collectives, ZeRO, FSDP and the
parallel modes raise, naming elastic (:func:`require_process_group`).
A reshape replaces the topology (:func:`replace_topology`) but never the
card: a process keeps the device ``init`` bound.

The card's acquisition and the process group's join run under the
port's bounded retries (``common/retry.py``: ``HOROVOD_TPU_INIT_RETRIES``,
``HOROVOD_TPU_INIT_BACKOFF``) and carry the fault plan's ``init`` and
``init_distributed`` hooks. An exhausted budget raises; nothing falls
back to the CPU.
"""

from __future__ import annotations

import atexit
import datetime
import threading
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .. import DeviceLike
from .. import fault
from . import config
from . import hvd_logging as logging
from . import retry
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
        self.controller = None
        self.timeline = None

    def close(self) -> None:
        if self.controller is not None:
            self.controller.shutdown()
            self.controller = None
        if self.timeline is not None:
            self.timeline.close()
            self.timeline = None
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()


_state: Optional[_State] = None
_state_lock = threading.Lock()


def _store(topology: Topology):
    """The process group's rendezvous."""
    path = config.rendezvous_file()
    if path:
        return dist.FileStore(path, topology.size)
    addr = config.spmd_coordinator()
    if addr:
        host, _, port = addr.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(
                f"HOROVOD_SPMD_COORDINATOR must be host:port, got {addr!r}")
        return dist.TCPStore(host, int(port), topology.size,
                             topology.rank == 0, timeout=_TIMEOUT)
    if topology.size == 1:
        return dist.HashStore()
    raise RuntimeError(
        f"a job of size {topology.size} needs a rendezvous: set "
        "HOROVOD_SPMD_COORDINATOR=host:port or HOROVOD_RENDEZVOUS_FILE, or "
        "launch with horovodrun")


def _bounded(fn, site: str, describe: str, seed: int) -> None:
    """``fn`` under the init retry budget, each attempt behind the fault
    plan's ``site`` hook. An exhausted budget raises ``RetryError``."""

    def attempt():
        fault.hook(site)
        fn()

    attempts, backoff = config.init_retry_env()
    retry.retry_call(attempt, attempts=attempts, backoff=backoff, seed=seed,
                     describe=describe)


def require_process_group(what: str) -> None:
    """Raise, naming elastic, when ``what`` needs the
    ``torch.distributed`` process group and the job is elastic (no group
    is built then)."""
    if config.elastic_enabled():
        raise RuntimeError(
            f"{what} runs on the torch.distributed process group, which an "
            "elastic job (HOROVOD_ELASTIC=1, horovodrun --elastic) does not "
            "build: the group is a static world that a dead rank wedges "
            "and a joiner cannot enter. Elastic jobs run world-group "
            "collectives through the controller; launch without --elastic "
            "for group=, ZeRO, FSDP and the parallel modes")


def init(ranks: Optional[Sequence[int]] = None,
         device: DeviceLike = None) -> None:
    """Initialize. Idempotent. ``ranks`` narrows the job to a subset of
    processes; ``device=None`` binds ``cuda:{local_rank}`` and raises
    without a card, ``device="cpu"`` runs the job on the CPU (gloo), and
    ``device="cuda:N"`` binds that card."""
    global _state
    with _state_lock:
        if _state is not None:
            return
        cfg = config.Config.from_env()
        logging.configure(cfg.log_level, cfg.log_hide_timestamp)
        # Launcher-spawned ranks die with their launcher.
        from ..run.watchdog import maybe_install_from_env

        maybe_install_from_env()
        topology = detect(ranks)
        logging.set_rank(topology.rank)
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "horovod_tpu_torch.init: no CUDA device is available; "
                    "pass device='cpu' explicitly to run on the CPU")
            dev = torch.device("cuda", topology.device_index)
        else:
            dev = torch.device(device)
        seed = config.env_rank() or 0
        _bounded((lambda: torch.cuda.set_device(dev)) if dev.type == "cuda"
                 else (lambda: None), "init", "card acquisition", seed)
        elastic = config.elastic_enabled()
        owns_group = False
        if topology.launched and not dist.is_initialized() and not elastic:
            backend = "nccl" if dev.type == "cuda" else "gloo"
            kwargs = {"device_id": dev} if dev.type == "cuda" else {}
            _bounded(lambda: dist.init_process_group(
                backend, store=_store(topology), rank=topology.rank,
                world_size=topology.size, timeout=_TIMEOUT, **kwargs),
                "init_distributed", "torch.distributed process group join",
                seed)
            owns_group = True
        state = _State(topology, dev, owns_group)
        engine = config.selected_engine()
        if elastic and engine == "native":
            logging.warning(
                "HOROVOD_ELASTIC=1 requires the python controller engine; "
                "overriding the native engine selection")
            engine = "python"
        try:
            if topology.size > 1 and engine == "native":
                from ..controller.native import NativeController

                state.controller = NativeController(cfg, topology)
            elif topology.size > 1 and config.controller_addr():
                if cfg.timeline_filename and topology.rank == 0:
                    from .timeline import Timeline

                    state.timeline = Timeline(
                        cfg.timeline_filename,
                        mark_cycles=cfg.timeline_mark_cycles)
                from ..controller.controller import Controller

                state.controller = Controller(cfg, topology,
                                              timeline=state.timeline)
                # A joiner's identity is its admission assignment.
                state.topology = state.controller.topo
                logging.set_rank(state.topology.rank)
        except BaseException:
            state.close()
            raise
        _state = state


def replace_topology(topology: Topology) -> None:
    """Elastic-reshape hook (``controller/controller.py``): swap the
    topology after a membership change, so ``hvd.rank()``/``hvd.size()``
    and the log prefix follow the re-formed world. Runs on the controller
    thread; lock-free, since the reference swap is atomic. The bound
    device is left alone."""
    if _state is not None:
        _state.topology = topology
    logging.set_rank(topology.rank)


def shutdown() -> None:
    """Stop the controller, close the timeline and tear down the process
    group ``init`` built."""
    global _state
    with _state_lock:
        if _state is not None:
            _state.close()
        _state = None


atexit.register(shutdown)


def _ensure_initialized() -> _State:
    if _state is None:
        raise ValueError(
            "Horovod has not been initialized; use hvd.init().")
    return _state


def is_initialized() -> bool:
    return _state is not None


def controller():
    """The running eager-tier controller, or None (size 1, ``--spmd``, or
    no launcher)."""
    return _ensure_initialized().controller


def mpi_threads_supported() -> bool:
    """Whether collectives may be called from several threads at once:
    True once initialised (both controllers take concurrent enqueues), as
    in the JAX package."""
    _ensure_initialized()
    return True


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
