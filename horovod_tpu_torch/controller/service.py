"""Star-topology control/data transport: coordinator (rank 0) + workers —
the port's copy of ``horovod_tpu/controller/service.py`` without the
elastic join listener and ``reform``.

The reference's control plane is MPI collectives among ranks (Gather of
RequestLists into rank 0, Bcast of the fused ResponseList back,
``horovod/common/operations.cc:1388-1518``). Here it is a TCP star: every
worker keeps one persistent authenticated connection to the coordinator,
sends its tick (gather) and receives the reply (bcast). The same
connections carry the host data phases in strict lockstep — every rank
walks the identical response list in the identical order — so control
and data frames never interleave ambiguously.

Liveness: after rendezvous every wire gets a per-recv deadline
(``HOROVOD_COMM_TIMEOUT_SECONDS``) and both sides run a heartbeat thread
(``HOROVOD_HEARTBEAT_INTERVAL_SECONDS``), so a blocked recv can tell a
slow peer (heartbeats still arriving) from a dead one (deadline fires).
A coordinator that diagnoses a dead worker broadcasts ABORT frames so
every surviving rank fails its pending work with the diagnosis.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Any, Dict, Optional

from ..common import hvd_logging as logging
from ..common.config import (
    comm_timeout_seconds,
    heartbeat_interval_seconds,
    start_timeout_seconds,
)
from ..common.retry import retry_call
from ..common.wire import CommTimeoutError, Wire, parse_addr


class PeerFailureError(RuntimeError):
    """A specific peer's connection died or timed out: carries which rank,
    so the coordinator can broadcast a diagnosis instead of a bare EOF."""

    def __init__(self, rank: int, cause: BaseException):
        self.rank = rank
        self.cause = cause
        super().__init__(f"lost contact with rank {rank}: {cause}")


class _HeartbeatMixin:
    """Idle-cycle liveness frames over one or many wires. Send errors are
    ignored — death is diagnosed on the recv side, where the rank context
    lives."""

    _hb_thread: Optional[threading.Thread] = None
    _hb_stop: Optional[threading.Event] = None

    def _hb_wires(self):
        raise NotImplementedError

    def start_heartbeats(self, interval: Optional[float] = None) -> None:
        if self._hb_thread is not None:
            return
        if interval is None:
            interval = heartbeat_interval_seconds()
        if not interval or interval <= 0:
            return
        self._hb_stop = threading.Event()

        def _beat(stop=self._hb_stop):
            while not stop.wait(interval):
                for wire in self._hb_wires():
                    try:
                        # Non-blocking: one stalled peer must not starve
                        # heartbeats to the healthy ones.
                        wire.try_send_heartbeat()
                    except Exception:
                        pass  # recv side owns the diagnosis

        self._hb_thread = threading.Thread(
            target=_beat, name="hvd-heartbeat", daemon=True)
        self._hb_thread.start()

    def stop_heartbeats(self) -> None:
        if self._hb_stop is not None:
            self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2.0)
        self._hb_thread = None
        self._hb_stop = None


class CoordinatorService(_HeartbeatMixin):
    """Rank 0's side: accept one connection per worker rank.

    The hello is validated before a connection is admitted: an
    out-of-range or duplicate rank id (or a connection that never sends a
    well-formed hello within the rendezvous window) is rejected and
    closed."""

    def __init__(self, bind_addr: str, size: int,
                 accept_timeout: Optional[float] = None,
                 comm_timeout: Optional[float] = None):
        if accept_timeout is None:
            accept_timeout = start_timeout_seconds()
        if comm_timeout is None:
            comm_timeout = comm_timeout_seconds()
        host, port = parse_addr(bind_addr)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(size)
        self.wires: Dict[int, Wire] = {}
        try:
            self._accept(size, accept_timeout)
        except BaseException:
            self.close()
            raise
        for _, wire in sorted(self.wires.items()):
            wire.set_deadline(comm_timeout)

    def _accept(self, size: int, accept_timeout: float) -> None:
        deadline = time.monotonic() + accept_timeout
        while len(self.wires) < size - 1:
            self._listener.settimeout(max(0.1, deadline - time.monotonic()))
            try:
                conn, peer = self._listener.accept()
            except socket.timeout:
                raise TimeoutError(
                    f"coordinator: only {len(self.wires)}/{size - 1} workers "
                    f"connected within {accept_timeout}s")
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # A connected-but-silent client (port scanner, probe) must
            # neither wedge the rendezvous nor eat the accept window.
            conn.settimeout(
                min(5.0, max(0.1, deadline - time.monotonic())))
            wire = Wire(conn)
            try:
                hello = wire.recv_obj()
                rank = int(hello["rank"])
            except Exception as exc:
                logging.warning(
                    "coordinator: rejecting connection from %s "
                    "(bad hello: %s)", peer, exc)
                wire.close()
                continue
            if not 1 <= rank < size:
                logging.warning(
                    "coordinator: rejecting hello with out-of-range rank %d "
                    "(job size %d)", rank, size)
                wire.close()
                continue
            if rank in self.wires:
                logging.warning(
                    "coordinator: rejecting duplicate hello for rank %d "
                    "(keeping the first connection)", rank)
                wire.close()
                continue
            conn.settimeout(None)
            self.wires[rank] = wire
            logging.debug("coordinator: rank %d connected", rank)

    def recv_from(self, rank: int) -> Any:
        try:
            return self.wires[rank].recv_obj()
        except (CommTimeoutError, ConnectionError, OSError) as exc:
            raise PeerFailureError(rank, exc) from exc

    def recv_bytes_from(self, rank: int) -> bytearray:
        try:
            return self.wires[rank].recv_bytes()
        except (CommTimeoutError, ConnectionError, OSError) as exc:
            raise PeerFailureError(rank, exc) from exc

    def send_to(self, rank: int, obj: Any) -> None:
        try:
            self.wires[rank].send_obj(obj)
        except (ConnectionError, OSError) as exc:
            raise PeerFailureError(rank, exc) from exc

    def send_bytes_to(self, rank: int, payload) -> None:
        try:
            self.wires[rank].send_bytes(payload)
        except (ConnectionError, OSError) as exc:
            raise PeerFailureError(rank, exc) from exc

    def send_all(self, obj: Any) -> None:
        for rank in sorted(self.wires):
            self.send_to(rank, obj)

    def send_abort_all(self, message: str, dead_rank: Optional[int] = None,
                       op: Optional[str] = None) -> None:
        """Best-effort coordinated abort: every surviving worker's next
        recv — control or data phase — raises RemoteAbortError with this
        diagnosis."""
        for rank in sorted(self.wires):
            if rank == dead_rank:
                continue
            try:
                self.wires[rank].send_abort(message, dead_rank=dead_rank,
                                            op=op)
            except Exception:
                pass  # that worker is dying too; nothing more to do

    def _hb_wires(self):
        return [self.wires[r] for r in sorted(self.wires)]

    def close(self) -> None:
        self.stop_heartbeats()
        for _, wire in sorted(self.wires.items()):
            wire.close()
        self._listener.close()


# Dial cadence while the coordinator comes up: the first retries are
# quick (rank 0 is usually a moment behind), later ones a second apart.
_DIAL_BACKOFF = 0.05
_DIAL_BACKOFF_MAX = 1.0


class WorkerClient(_HeartbeatMixin):
    """A non-zero rank's side: one persistent connection, dialled with
    bounded retries (``common/retry.py``) while the coordinator comes
    up."""

    def __init__(self, addr: str, rank: int,
                 connect_timeout: Optional[float] = None,
                 comm_timeout: Optional[float] = None):
        if connect_timeout is None:
            connect_timeout = start_timeout_seconds()
        if comm_timeout is None:
            comm_timeout = comm_timeout_seconds()
        host, port = parse_addr(addr)
        # Enough attempts to span the rendezvous window at the capped
        # backoff, plus the short ones before the cap.
        attempts = int(connect_timeout / _DIAL_BACKOFF_MAX) + 6
        try:
            sock = retry_call(
                lambda: socket.create_connection((host, port), timeout=5.0),
                attempts=attempts, backoff=_DIAL_BACKOFF,
                backoff_max=_DIAL_BACKOFF_MAX, seed=rank,
                describe=f"rank {rank}: dialling the coordinator at {addr}",
                retry_on=(OSError,))
        except Exception as exc:
            raise ConnectionError(
                f"rank {rank}: cannot reach coordinator at {addr}: "
                f"{exc}") from exc
        sock.settimeout(None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.wire = Wire(sock)
        self.wire.send_obj({"rank": rank})
        if comm_timeout:
            # The coordinator stays silent until every worker has
            # connected: the first frame gets the whole rendezvous window
            # on top of the liveness deadline.
            self.wire.set_deadline(comm_timeout,
                                   first=comm_timeout + connect_timeout)

    def send(self, obj: Any) -> None:
        self.wire.send_obj(obj)

    def recv(self) -> Any:
        return self.wire.recv_obj()

    def send_bytes(self, payload) -> None:
        self.wire.send_bytes(payload)

    def recv_bytes(self) -> bytearray:
        return self.wire.recv_bytes()

    def _hb_wires(self):
        return [self.wire]

    def close(self) -> None:
        self.stop_heartbeats()
        self.wire.close()
