"""Star-topology control/data transport: coordinator (rank 0) + workers —
the port's copy of ``horovod_tpu/controller/service.py``.

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

Elastic membership (``HOROVOD_ELASTIC``): after rendezvous the
coordinator keeps accepting connections; a well-formed JOIN hello parks
its wire until the controller admits it at the next epoch boundary, and
:meth:`CoordinatorService.reform` re-forms the world without dead ranks
and with parked joiners — a RESHAPE to every member, then each member's
stream drained until its acknowledgement.
"""

from __future__ import annotations

import dataclasses
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..analysis.lockorder import make_lock
from ..common import hvd_logging as logging
from ..common.config import (
    comm_timeout_seconds,
    heartbeat_interval_seconds,
    start_timeout_seconds,
)
from ..common.retry import retry_call
from ..common.wire import (
    FRAME_JOIN,
    CommTimeoutError,
    RanksChangedError,
    Wire,
    parse_addr,
)


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


@dataclasses.dataclass(frozen=True)
class ReshapeResult:
    """What one successful membership re-formation produced: the epoch it
    committed, the new world size, the old global ranks that left, and
    how many joiners were admitted."""

    epoch: int
    size: int
    lost: Tuple[int, ...]
    joined: int


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
        self._comm_timeout = comm_timeout
        # Elastic membership: the epoch (1 at rendezvous), and the JOIN
        # hellos the accept thread parks until an epoch boundary. The lock
        # covers the parked list and the replacement of ``wires`` by
        # reform() against the heartbeat thread's snapshot; every other
        # access to ``wires`` stays on the controller thread.
        self.epoch = 1
        self._wires_lock = make_lock("service.wires")
        self._shard_cb = None
        self._pending_joins: List[Tuple[Wire, dict]] = []
        self._join_stop: Optional[threading.Event] = None
        self._join_thread: Optional[threading.Thread] = None
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
            # Conformance role (HOROVOD_PROTOCHECK, analysis/protocol.py),
            # assigned before the first frame so the hello itself is
            # checked against the coordinator's handshake state.
            wire.set_protocol_role("coordinator")
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

    def set_clock_sync(self, clock) -> None:
        """Feed ``clock`` (a ``trace.ClockSync``) from every worker wire's
        pongs; from then on the heartbeats double as clock pings."""
        for worker_rank, wire in sorted(self.wires.items()):
            wire.set_clock_callback(
                lambda t0, wall, t1, _r=worker_rank:
                clock.observe(_r, t0, wall, t1))

    def send_clock_pings(self) -> None:
        """One best-effort clock ping on every worker wire; the pongs
        reach the clock whenever the wire is next drained."""
        for _, wire in sorted(self.wires.items()):
            wire.send_clock_ping()

    def _hb_wires(self):
        with self._wires_lock:
            wires = [self.wires[r] for r in sorted(self.wires)]
            # Parked joiners too: their recv deadline is armed while they
            # block in await_assignment, and a slot may take long to free
            # under --max-ranks.
            wires.extend(wire for wire, _ in self._pending_joins)
            return wires

    def set_shard_callback(self, cb) -> None:
        """Install the p2p shard plane's consumer on every current wire,
        parked joiners included, and on every wire accepted from now on.
        ``reform()`` keeps Wire objects, so one installation survives
        membership epochs."""
        self._shard_cb = cb
        with self._wires_lock:
            wires = [self.wires[r] for r in sorted(self.wires)]
            wires.extend(wire for wire, _ in self._pending_joins)
        for wire in wires:
            wire.set_shard_callback(cb)

    # -- elastic membership ---------------------------------------------------

    def start_join_listener(self) -> None:
        """Keep accepting connections after rendezvous: a well-formed JOIN
        hello parks the wire until the controller admits it at the next
        epoch boundary; anything else is rejected and closed, as at
        rendezvous."""
        if self._join_thread is not None:
            return
        self._join_stop = threading.Event()
        self._listener.settimeout(0.25)

        def _accept_loop(stop=self._join_stop):
            while not stop.is_set():
                try:
                    conn, peer = self._listener.accept()
                except socket.timeout:
                    continue
                except OSError:
                    return  # listener closed: teardown
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                conn.settimeout(5.0)  # real joiners send the hello at once
                wire = Wire(conn)
                wire.set_protocol_role("coordinator")
                try:
                    kind, hello = wire.recv_hello()
                    if kind != FRAME_JOIN or not hello.get("join"):
                        raise ValueError("not a join hello")
                except Exception as exc:
                    logging.warning(
                        "coordinator: rejecting elastic connection from %s "
                        "(bad join hello: %s)", peer, exc)
                    wire.close()
                    continue
                conn.settimeout(None)
                if self._shard_cb is not None:
                    wire.set_shard_callback(self._shard_cb)
                with self._wires_lock:
                    self._pending_joins.append((wire, hello))
                logging.info(
                    "coordinator: joiner connected (previous rank %s); "
                    "admitting at the next membership epoch boundary",
                    hello.get("rank"))

        self._join_thread = threading.Thread(
            target=_accept_loop, name="hvd-elastic-accept", daemon=True)
        self._join_thread.start()

    def parked_joiner_count(self) -> int:
        """How many validated joiners are parked awaiting an epoch
        boundary."""
        with self._wires_lock:
            return len(self._pending_joins)

    def reform(self, dead, min_ranks: int = 1,
               max_ranks: int = 0) -> Optional[ReshapeResult]:
        """Re-form the world without the ``dead`` old ranks and with any
        parked joiners (capped by ``max_ranks``): bump the epoch, send
        every member its new (rank, size, epoch), and drain each member's
        wire until its acknowledgement, discarding the dead epoch's
        in-flight frames on the way. A member that fails mid-handshake is
        dropped and the handshake retried at a fresh epoch, so the
        committed epoch is always fully acknowledged.

        Returns None, with the membership untouched beyond closing dead
        wires, when the survivors would fall below ``min_ranks``; the
        caller then aborts like the non-elastic path."""
        # (old rank, or None for a joiner; wire), survivors in rank order.
        members: List[Tuple[Optional[int], Wire]] = []
        lost: List[int] = []
        with self._wires_lock:
            for old_rank in sorted(self.wires):
                if old_rank in dead:
                    lost.append(old_rank)
                else:
                    members.append((old_rank, self.wires[old_rank]))
            dead_wires = [self.wires[r] for r in lost]
        # Closed outside the membership lock: a socket's close is I/O.
        for wire in dead_wires:
            try:
                wire.close()
            except Exception:
                pass
        joined = 0
        while True:
            capacity = (max_ranks - 1 - len(members)) if max_ranks else None
            with self._wires_lock:
                while self._pending_joins and (capacity is None
                                               or capacity > 0):
                    wire, _hello = self._pending_joins.pop(0)
                    # Arm the joiner's deadline now, so that one that
                    # wedges cannot hang the ack drain below.
                    wire.set_deadline(self._comm_timeout)
                    members.append((None, wire))
                    joined += 1
                    if capacity is not None:
                        capacity -= 1
            new_size = 1 + len(members)
            if new_size < min_ranks:
                # Joiners absorbed above go back to the parked list.
                with self._wires_lock:
                    self._pending_joins[:0] = [
                        (wire, {"join": True})
                        for old_rank, wire in members if old_rank is None]
                return None
            self.epoch += 1
            epoch = self.epoch
            failed = set()
            for i, (_, wire) in enumerate(members):
                try:
                    wire.send_reshape(i + 1, new_size, epoch)
                except Exception:
                    failed.add(i)
            if not failed:
                for i, (_, wire) in enumerate(members):
                    try:
                        wire.recv_reshape_ack(epoch)
                    except Exception as exc:
                        logging.warning(
                            "coordinator: member (old rank %s) failed the "
                            "epoch %d reshape handshake (%s); dropping it "
                            "and re-forming", members[i][0], epoch, exc)
                        failed.add(i)
            if failed:
                for i in sorted(failed, reverse=True):
                    old_rank, wire = members.pop(i)
                    if old_rank is not None:
                        lost.append(old_rank)
                    else:
                        joined -= 1
                    try:
                        wire.close()
                    except Exception:
                        pass
                continue
            with self._wires_lock:
                self.wires = {i + 1: wire
                              for i, (_, wire) in enumerate(members)}
                for _, wire in sorted(self.wires.items()):
                    wire.set_deadline(self._comm_timeout)
            return ReshapeResult(epoch=epoch, size=new_size,
                                 lost=tuple(sorted(lost)), joined=joined)

    def close(self) -> None:
        self.stop_heartbeats()
        if self._join_stop is not None:
            self._join_stop.set()
        if self._join_thread is not None:
            self._join_thread.join(timeout=2.0)
            self._join_thread = None
        with self._wires_lock:
            pending = list(self._pending_joins)
            self._pending_joins.clear()
        for wire, _ in pending:
            wire.close()
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
                 comm_timeout: Optional[float] = None,
                 join: bool = False):
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
        # Conformance role (HOROVOD_PROTOCHECK): a joiner plays the
        # parked-joiner machine until its admission commits, after which
        # the spec aliases it onto the worker machine.
        self.wire.set_protocol_role("joiner" if join else "worker")
        if join:
            # Elastic late joiner: a JOIN hello instead of the rendezvous
            # hello; the coordinator parks this wire and answers with a
            # RESHAPE assignment at the next epoch boundary
            # (await_assignment). ``rank`` is advisory only: the previous
            # rank of a respawned worker, logged, never trusted.
            self.wire.send_join({"join": True, "rank": rank})
        else:
            self.wire.send_obj({"rank": rank})
        if comm_timeout:
            # The coordinator stays silent until every worker has
            # connected: the first frame gets the whole rendezvous window
            # on top of the liveness deadline.
            self.wire.set_deadline(comm_timeout,
                                   first=comm_timeout + connect_timeout)

    def await_assignment(self) -> RanksChangedError:
        """Joiner half of the admission handshake: block until the
        coordinator's RESHAPE assignment (this wire's first real frame)
        and return it. Anything else means the coordinator is not
        elastic."""
        try:
            self.wire.recv_obj()
        except RanksChangedError as exc:
            return exc
        raise ConnectionError(
            "joiner expected a RESHAPE assignment as its first frame but "
            "got ordinary data — is the coordinator running with "
            "HOROVOD_ELASTIC=1?")

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
