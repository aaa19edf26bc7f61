"""Authenticated framed TCP transport for the control plane — the port's
copy of ``horovod_tpu/common/wire.py``, frame for frame. Every frame is

    [1-byte kind][4-byte big-endian payload length][32-byte HMAC-SHA256][payload]

with the HMAC keyed by the per-job secret and computed over kind+payload
(the kind is authenticated, so a tamperer cannot turn a data frame into
an abort). Kinds handled here:

* ``DATA`` — control payloads are pickled messages; tensor payloads are
  raw buffer bytes (no pickling on the data path).
* ``HEARTBEAT`` — liveness frame; receivers skip it transparently, so
  heartbeats may interleave anywhere in the lockstep protocol (a per-wire
  send lock keeps frames whole). An empty payload is plain liveness; a
  non-empty one carries the clock-sync ping-pong of the trace plane
  (``trace/clock.py``): ``{"ping": t0}`` is answered in place with
  ``{"pong": t0, "wall": time.time()}``, and a pong is reported to
  :meth:`Wire.set_clock_callback`, all invisible to the lockstep protocol
  and best-effort (a dropped pong only delays the next offset sample).
* ``ABORT`` — coordinated failure notice (pickled ``{"message",
  "dead_rank", "op"}``); any recv raises :class:`RemoteAbortError`.
* ``JOIN`` — elastic membership, two payloads: a join hello ``{"join":
  True, "rank": <previous rank or None>}`` from a late worker dialling a
  live job, and a reshape acknowledgement ``{"ack": <epoch>}`` a member
  returns after applying a RESHAPE. JOIN frames belong to the
  rendezvous and reshape seams only (:meth:`Wire.recv_hello`,
  :meth:`Wire.recv_reshape_ack`); one in the data stream raises
  :class:`AuthError`.
* ``RESHAPE`` — the coordinator's new-membership assignment (pickled
  ``{"rank", "size", "epoch"}``): any recv raises
  :class:`RanksChangedError` carrying this rank's place in the re-formed
  world, tearing in-flight work of the dead epoch out of a blocked
  receiver at the frame boundary where that epoch ends.
* ``SHARD_FETCH`` / ``SHARD_DATA`` — the peer-to-peer checkpoint-shard
  plane (``elastic/shards.py``): a pickled request for one committed
  shard, addressed by content digest, and its reply. Invisible to the
  lockstep protocol: ``recv_bytes`` hands them to the wire's shard
  callback (:meth:`Wire.set_shard_callback`) and keeps reading.

``send_bytes`` and ``recv_bytes`` carry the fault plan's ``wire_send``
and ``wire_recv`` hooks (``fault/``): no-ops without a plan.

Each wire plays one role of the protocol spec (``analysis/protocol.py``:
coordinator, worker or joiner, set by :meth:`Wire.set_protocol_role`).
Under ``HOROVOD_PROTOCHECK`` every frame sent or received is checked
against that role's state machine; off, a frame pays one ``is None``
check. The three recv loops branch on every frame kind explicitly, as
the spec's handler table (``protocol.HANDLERS``) requires, and end in an
"unhandled frame kind" error.

Receives honour a per-wire deadline (:meth:`Wire.set_deadline`, wired to
``HOROVOD_COMM_TIMEOUT_SECONDS``): a recv that sees no bytes for that long
raises :class:`CommTimeoutError`.

Large payloads cost one pass each for the digest and the socket and no
copies: the digest is fed the kind byte and then the payload, the header
and the payload go out as two writes under one lock, and a payload is
received into one buffer. The bytes on the socket are the same as
hashing and sending their concatenation.

The secret comes from ``HOROVOD_SECRET_KEY`` (hex), generated by the
launcher per job. ``run/task_fn.py`` (the standalone ssh-piped NIC probe)
re-implements this frame layout; keep them byte-compatible.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import pickle
import select
import socket
import struct
import time
from typing import Any, Optional

from .. import fault
from .. import metrics
from ..analysis.lockorder import make_lock
from ..analysis.protocol import epoch_is_stale, make_monitor
from .config import secret_key_hex

DIGEST_LEN = 32
_HDR = struct.Struct(">BI")  # frame kind, payload length
MAX_FRAME = 1 << 31  # sanity bound

FRAME_DATA = 0
FRAME_HEARTBEAT = 1
FRAME_ABORT = 2
FRAME_JOIN = 3
FRAME_RESHAPE = 4
FRAME_SHARD_FETCH = 5
FRAME_SHARD_DATA = 6
_KNOWN_KINDS = (FRAME_DATA, FRAME_HEARTBEAT, FRAME_ABORT, FRAME_JOIN,
                FRAME_RESHAPE, FRAME_SHARD_FETCH, FRAME_SHARD_DATA)
_KIND_NAMES = {FRAME_DATA: "data", FRAME_HEARTBEAT: "heartbeat",
               FRAME_ABORT: "abort", FRAME_JOIN: "join",
               FRAME_RESHAPE: "reshape",
               FRAME_SHARD_FETCH: "shard_fetch",
               FRAME_SHARD_DATA: "shard_data"}

_m = None


def _wire_metrics():
    """Lazy registration, with per-kind children pre-resolved so the frame
    path is one cached lookup + a locked add."""
    global _m
    if _m is None:
        from types import SimpleNamespace

        frames_sent = metrics.counter(
            "hvd_wire_frames_sent_total",
            "Control-plane frames sent, by frame kind.", ("kind",))
        bytes_sent = metrics.counter(
            "hvd_wire_bytes_sent_total",
            "Control-plane bytes sent (header + payload), by frame kind.",
            ("kind",))
        frames_recv = metrics.counter(
            "hvd_wire_frames_recv_total",
            "Control-plane frames received, by frame kind.", ("kind",))
        bytes_recv = metrics.counter(
            "hvd_wire_bytes_recv_total",
            "Control-plane bytes received (header + payload), by frame "
            "kind.", ("kind",))
        deadline = metrics.counter(
            "hvd_wire_deadline_trips_total",
            "Liveness deadline expiries (CommTimeoutError), by side.",
            ("side",))
        _m = SimpleNamespace(
            sent={k: (frames_sent.labels(v), bytes_sent.labels(v))
                  for k, v in _KIND_NAMES.items()},
            recv={k: (frames_recv.labels(v), bytes_recv.labels(v))
                  for k, v in _KIND_NAMES.items()},
            recv_wait=metrics.histogram(
                "hvd_wire_recv_wait_seconds",
                "Time a blocked recv waited for its data frame."),
            trip_recv=deadline.labels("recv"),
            trip_send=deadline.labels("send"),
        )
    return _m


def job_secret() -> bytes:
    """Per-job HMAC key, minted by the launcher and exported to every
    rank."""
    key = secret_key_hex()
    if key:
        return bytes.fromhex(key)
    # Hermetic single-job default (tests / manual runs without the launcher).
    return b"horovod-tpu-default-insecure-key"


def make_secret() -> str:
    return os.urandom(32).hex()


def parse_addr(addr: str) -> "tuple[str, int]":
    """``host:port`` → ``(host, port)``, empty host meaning loopback."""
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)


class AuthError(RuntimeError):
    pass


class CommTimeoutError(ConnectionError):
    """No frame (not even a heartbeat) arrived within the deadline: the
    peer process is dead, wedged, or partitioned."""


class RemoteAbortError(RuntimeError):
    """The peer broadcast a coordinated abort (ABORT frame): the job is
    failing and this rank must fail its pending work with the attached
    diagnosis instead of waiting out its own timeout."""

    def __init__(self, message: str, dead_rank: Optional[int] = None,
                 op: Optional[str] = None):
        super().__init__(message)
        self.dead_rank = dead_rank
        self.op = op


class RanksChangedError(RuntimeError):
    """Cluster membership changed (elastic reshape): the coordinator
    re-formed the world at a new epoch and this process's place in it is
    attached. In-flight collectives of the dead epoch fail with this
    error; ``hvd.elastic.run`` catches it, restores the last commit
    consistent with rank 0, and resumes the training loop."""

    def __init__(self, message: str, rank: Optional[int] = None,
                 size: Optional[int] = None, epoch: Optional[int] = None):
        super().__init__(message)
        self.rank = rank
        self.size = size
        self.epoch = epoch


def _pickled(obj) -> bytes:
    return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def _abort_error(payload) -> RemoteAbortError:
    info = pickle.loads(payload)
    return RemoteAbortError(info.get("message", "job aborted"),
                            dead_rank=info.get("dead_rank"),
                            op=info.get("op"))


def _as_bytes_view(payload) -> memoryview:
    """A flat byte view of any contiguous buffer (bytes, bytearray, a
    numpy array)."""
    view = memoryview(payload)
    return view if view.format == "B" and view.ndim == 1 else view.cast("B")


class Wire:
    """Frame/unframe over a connected socket."""

    # A peer that stops draining (SIGSTOP, wedged in native code) never
    # closes its socket: a send may sit in flow control at most this
    # multiple of the recv deadline before the peer is declared dead.
    SEND_STALL_FACTOR = 8

    def __init__(self, sock: socket.socket, secret: Optional[bytes] = None):
        self._sock = sock
        self._secret = secret if secret is not None else job_secret()
        # Heartbeats ride a background thread; frames must never
        # interleave mid-send. Tracked under HOROVOD_LOCKCHECK: held
        # across the socket send, so its order against the controller
        # and metrics locks is what the deadlock detector must see.
        self._send_lock = make_lock("wire.send")
        self._deadline: Optional[float] = None
        self._first_deadline: Optional[float] = None
        # The shard plane's consumer: cb("fetch"|"data", info), called
        # from whatever recv loop drains the frame. None drops them (the
        # requester's own timeout diagnoses an unserviced fetch).
        self._shard_cb = None
        # The clock-sync pong consumer (the coordinator's side of a traced
        # job): cb(t0, peer_wall, t1). Setting it also makes this wire's
        # heartbeats carry pings.
        self._clock_cb = None
        # The protocol monitor: None until a role is assigned under
        # HOROVOD_PROTOCHECK.
        self._monitor = None

    def set_protocol_role(self, role: str) -> None:
        """Declare which side of the protocol this wire plays
        (``coordinator``/``worker``/``joiner``); under
        ``HOROVOD_PROTOCHECK`` every later frame is checked against the
        spec's state machine for that role."""
        self._monitor = make_monitor(role)

    def _observe(self, direction: str, kind: int,
                 info: Optional[dict] = None) -> None:
        if self._monitor is not None:
            self._monitor.observe(direction, _KIND_NAMES[kind], info)

    def set_deadline(self, seconds: Optional[float],
                     first: Optional[float] = None) -> None:
        """Per-recv liveness bound; None or <=0 restores blocking mode.
        ``first`` optionally bounds only the first frame with a longer
        one-shot deadline (the rendezvous window)."""
        self._deadline = seconds if seconds and seconds > 0 else None
        self._first_deadline = first if first and first > 0 else None
        self._sock.settimeout(self._first_deadline or self._deadline)

    def _digest(self, kind: int, payload) -> bytes:
        mac = hmac.new(self._secret, bytes((kind,)), hashlib.sha256)
        mac.update(payload)
        return mac.digest()

    def _header(self, kind: int, view: memoryview) -> bytes:
        return _HDR.pack(kind, view.nbytes) + self._digest(kind, view)

    def _count_sent(self, kind: int, nbytes: int) -> None:
        if metrics.on():
            frames, counted = _wire_metrics().sent[kind]
            frames.inc()
            counted.inc(_HDR.size + DIGEST_LEN + nbytes)

    def _send_frame(self, kind: int, payload,
                    info: Optional[dict] = None) -> None:
        # Conformance first: under HOROVOD_PROTOCHECK=raise an off-spec
        # frame is stopped before it desyncs the peer. ``info`` is the
        # payload dict of the epoch-bearing kinds, before pickling.
        self._observe("send", kind, info)
        view = _as_bytes_view(payload)
        header = self._header(kind, view)
        with self._send_lock:
            self._sendall(header, view)
        self._count_sent(kind, view.nbytes)

    def _try_send_frame(self, kind: int, payload: bytes) -> bool:
        """Non-blocking frame send: never lets one stalled wire starve the
        heartbeat thread's loop over the other wires. Skips (False) when a
        bulk send holds the lock (frames are flowing — that is liveness)
        or when the peer's buffer cannot take a frame."""
        if not self._send_lock.acquire(blocking=False):
            return False
        try:
            poller = select.poll()
            poller.register(self._sock, select.POLLOUT)
            if not poller.poll(0):
                return False  # send buffer full: don't block the loop
            self._observe("send", kind)
            view = _as_bytes_view(payload)
            self._sendall(self._header(kind, view) + bytes(view))
            self._count_sent(kind, view.nbytes)
            return True
        finally:
            self._send_lock.release()

    def try_send_heartbeat(self) -> bool:
        """Idle-cycle liveness frame. On a wire with a clock callback the
        heartbeat doubles as a clock-sync ping, so the offset table
        refreshes at the heartbeat cadence."""
        if self._clock_cb is not None:
            return self.send_clock_ping()
        return self._try_send_frame(FRAME_HEARTBEAT, b"")

    # -- clock-sync ping-pong (piggybacked on heartbeat frames) -------------

    def set_clock_callback(self, cb) -> None:
        """Install the pong consumer: ``cb(t0, peer_wall, t1)`` with t0/t1
        on this process's ``time.time()`` and ``peer_wall`` the peer's."""
        self._clock_cb = cb

    def send_clock_ping(self) -> bool:
        """Best-effort RTT probe; the reply reaches the clock callback
        whenever this wire next drains frames."""
        # Wall clock by design: the ping-pong estimates cross-host
        # wall-clock offsets (trace/clock.py).
        return self._try_send_frame(FRAME_HEARTBEAT,
                                    # hvdlint: disable=HVD004
                                    _pickled({"ping": time.time()}))

    def _handle_clock_payload(self, payload) -> None:
        """Ping: answer with our wall clock; pong: report the sample.
        Never raises: clock sync rides the liveness plane and must not
        break the recv path it piggybacks on."""
        try:
            info = pickle.loads(payload)
            if "ping" in info:
                self._try_send_frame(FRAME_HEARTBEAT, _pickled(
                    # hvdlint: disable=HVD004 (clock-sync wall anchor)
                    {"pong": float(info["ping"]), "wall": time.time()}))
            elif "pong" in info and self._clock_cb is not None:
                self._clock_cb(float(info["pong"]), float(info["wall"]),
                               time.time())  # hvdlint: disable=HVD004
        except Exception:
            pass

    def _sendall(self, *parts) -> None:
        """sendall of ``parts`` back to back, each attempt one ``sendmsg``
        over what is left: a frame's header and payload leave in one call,
        as the JAX package's one concatenated send does, so a peer that
        already closed fails the frame's next recv (which still reads what
        the peer sent before closing, an ABORT say) rather than the
        payload's send. It tolerates the recv deadline: ``settimeout``
        applies to sends too, and a send that raised after one timeout
        would be a spurious failure (a full buffer is flow control) and a
        stream desync. Timed-out sends keep going until the stall bound."""
        views = [v for v in map(_as_bytes_view, parts) if v.nbytes]
        stalled = 0.0
        while views:
            try:
                sent = self._sock.sendmsg(views)
                stalled = 0.0  # progress resets the stall clock
                while views and sent >= views[0].nbytes:
                    sent -= views.pop(0).nbytes
                if sent:
                    views[0] = views[0][sent:]
            except socket.timeout:
                deadline = self._first_deadline or self._deadline
                stalled += deadline or 0.0
                if deadline and stalled >= self.SEND_STALL_FACTOR * deadline:
                    if metrics.on():
                        _wire_metrics().trip_send.inc()
                        metrics.record_event(
                            "deadline_trip", side="send",
                            stalled_seconds=round(stalled, 3))
                    raise CommTimeoutError(
                        f"peer stopped draining its socket for {stalled:.0f}s "
                        f"({self.SEND_STALL_FACTOR}x the "
                        "HOROVOD_COMM_TIMEOUT_SECONDS deadline) — peer alive "
                        "but wedged")

    def send_bytes(self, payload) -> None:
        """One DATA frame carrying ``payload`` (any contiguous buffer)."""
        if fault.hook("wire_send") == "drop":
            return  # injected frame loss: the peer's deadline must catch it
        self._send_frame(FRAME_DATA, payload)

    def send_heartbeat(self) -> None:
        self._send_frame(FRAME_HEARTBEAT, b"")

    def send_abort(self, message: str, dead_rank: Optional[int] = None,
                   op: Optional[str] = None) -> None:
        info = {"message": message, "dead_rank": dead_rank, "op": op}
        self._send_frame(FRAME_ABORT, _pickled(info), info=info)

    # -- elastic membership frames -------------------------------------------

    def send_join(self, info: dict) -> None:
        """Join hello (``{"join": True, ...}``) or reshape acknowledgement
        (``{"ack": epoch}``): the worker-side halves of the elastic
        handshake."""
        self._send_frame(FRAME_JOIN, _pickled(info), info=info)

    def send_reshape(self, rank: int, size: int, epoch: int) -> None:
        """New-membership assignment: the receiver's next recv, wherever
        it is blocked in the lockstep protocol, raises RanksChangedError
        with this (rank, size, epoch)."""
        info = {"rank": rank, "size": size, "epoch": epoch}
        self._send_frame(FRAME_RESHAPE, _pickled(info), info=info)

    def recv_hello(self) -> "tuple[int, Any]":
        """Rendezvous/admission read: the next DATA (initial hello) or
        JOIN (elastic late hello) frame as ``(kind, obj)``, skipping
        heartbeats. Any other kind during a hello is a protocol
        violation. The branch set is the spec's ``coordinator.handshake``
        state (``protocol.HANDLERS``, hvdlint HVD008)."""
        while True:
            kind, payload = self._recv_frame()
            if kind == FRAME_HEARTBEAT:
                if payload:
                    self._handle_clock_payload(payload)
                continue
            if kind in (FRAME_DATA, FRAME_JOIN):
                return kind, pickle.loads(payload)
            if kind in (FRAME_ABORT, FRAME_RESHAPE, FRAME_SHARD_FETCH,
                        FRAME_SHARD_DATA):
                raise AuthError(
                    f"unexpected {_KIND_NAMES[kind]} frame during hello")
            raise AuthError(f"unhandled frame kind {kind} during hello")

    def recv_reshape_ack(self, epoch: int) -> None:
        """Drain this wire until the peer acknowledges membership epoch
        ``epoch``. DATA and shard frames seen on the way are in-flight
        traffic of the dead epoch and are discarded; this drain lets the
        re-formed lockstep start from a clean stream. A stale ack (of a
        reshape attempt superseded mid-handshake) is skipped the same
        way. The branch set is the spec's ``coordinator.draining`` state
        (``protocol.HANDLERS``, hvdlint HVD008)."""
        while True:
            kind, payload = self._recv_frame()
            if kind == FRAME_HEARTBEAT:
                if payload:
                    self._handle_clock_payload(payload)
                continue
            if kind == FRAME_DATA:
                continue  # dead-epoch traffic: discard
            if kind in (FRAME_SHARD_FETCH, FRAME_SHARD_DATA):
                # Shard traffic of the epoch being torn down: the restore
                # that issued it fails with the reshape and retries at the
                # new epoch. Discard it like DATA.
                continue
            if kind == FRAME_JOIN:
                info = pickle.loads(payload)
                ack = info.get("ack")
                if ack == epoch:
                    return
                if ack is not None and epoch_is_stale(ack, epoch):
                    continue  # a superseded reshape attempt's ack
                raise AuthError(
                    f"unexpected join payload {info!r} while draining for "
                    f"epoch {epoch} ack")
            if kind == FRAME_ABORT:
                raise _abort_error(payload)
            if kind == FRAME_RESHAPE:
                # Members never originate reshapes: both sides think they
                # are the coordinator. Fail loudly, don't desync.
                raise AuthError(
                    f"unexpected reshape frame while draining for epoch "
                    f"{epoch} ack")
            raise AuthError(f"unhandled frame kind {kind} while draining "
                            f"for epoch {epoch} ack")

    # -- the p2p checkpoint-shard frames -------------------------------------

    def set_shard_callback(self, cb) -> None:
        """Install the shard plane's consumer: ``cb(event, info)`` with
        ``event`` ``"fetch"`` or ``"data"`` and ``info`` the unpickled
        payload dict. It runs on whatever thread drains the frame and
        must not block on this wire's own traffic."""
        self._shard_cb = cb

    def send_shard_fetch(self, info: dict) -> None:
        """Request one committed shard by content digest (``{"shard",
        "digest", "leaves", "req", "owner", "nonce"}``)."""
        self._send_frame(FRAME_SHARD_FETCH, _pickled(info), info=info)

    def send_shard_data(self, info: dict) -> None:
        """Answer (or relay) one shard fetch: the request's keys plus
        ``found`` and ``data`` (the packed leaf bytes)."""
        self._send_frame(FRAME_SHARD_DATA, _pickled(info), info=info)

    def _handle_shard_frame(self, kind: int, payload) -> None:
        """Hand a shard frame to the callback. Never raises into the recv
        path it rides: a lost or unserviced fetch is diagnosed by the
        requester's own timeout."""
        cb = self._shard_cb
        if cb is None:
            return
        try:
            cb("fetch" if kind == FRAME_SHARD_FETCH else "data",
               pickle.loads(payload))
        except Exception:
            pass  # the exchange logs its own failures

    def recv_bytes(self) -> bytearray:
        """Lockstep data-stream read: the next DATA frame's payload, in a
        writable buffer of its own. Every other kind is dispatched
        explicitly: the branch set is the spec's ``worker.steady`` /
        ``coordinator.steady`` / ``joiner.parked`` states
        (``protocol.HANDLERS``, hvdlint HVD008)."""
        fault.hook("wire_recv")
        mon = metrics.on()
        t0 = time.monotonic() if mon else 0.0
        while True:
            kind, payload = self._recv_frame()
            if kind == FRAME_HEARTBEAT:
                if payload:  # the clock-sync ping/pong rides these
                    self._handle_clock_payload(payload)
                continue  # liveness only; invisible to the protocol
            if kind == FRAME_ABORT:
                raise _abort_error(payload)
            if kind == FRAME_RESHAPE:
                info = pickle.loads(payload)
                raise RanksChangedError(
                    "cluster membership changed: this process is now rank "
                    f"{info.get('rank')} of {info.get('size')} at membership "
                    f"epoch {info.get('epoch')}",
                    rank=info.get("rank"), size=info.get("size"),
                    epoch=info.get("epoch"))
            if kind in (FRAME_SHARD_FETCH, FRAME_SHARD_DATA):
                self._handle_shard_frame(kind, payload)
                continue
            if kind == FRAME_JOIN:
                # Hellos and acks belong to the rendezvous and reshape
                # seams only; here the two sides disagree about elastic
                # mode.
                raise AuthError(
                    "unexpected join frame in the data stream (is the "
                    "coordinator running without HOROVOD_ELASTIC?)")
            if kind == FRAME_DATA:
                if mon:
                    _wire_metrics().recv_wait.observe(time.monotonic() - t0)
                return payload
            raise AuthError(f"unhandled frame kind {kind} in the data "
                            "stream")

    def _recv_frame(self) -> tuple:
        header = self._recv_exact(_HDR.size + DIGEST_LEN)
        kind, length = _HDR.unpack(header[:_HDR.size])
        if length > MAX_FRAME:
            raise AuthError(f"oversized frame ({length} bytes)")
        digest = bytes(header[_HDR.size:])
        payload = self._recv_exact(length)
        if not hmac.compare_digest(digest, self._digest(kind, payload)):
            raise AuthError("HMAC digest mismatch on control frame")
        if kind not in _KNOWN_KINDS:
            # Authenticated but unknown: version skew inside one job.
            raise AuthError(f"unknown frame kind {kind}")
        if metrics.on():
            frames, nbytes = _wire_metrics().recv[kind]
            frames.inc()
            nbytes.inc(len(header) + length)
        if self._monitor is not None:
            # The epoch-bearing kinds are unpickled for the guard checks
            # (rare frames, tiny payloads, monitor on only); the caller
            # unpickles again on its own path.
            info = None
            if kind in (FRAME_JOIN, FRAME_RESHAPE):
                try:
                    info = pickle.loads(payload)
                except Exception:
                    info = None
            self._observe("recv", kind, info)
        if self._first_deadline is not None:
            # First frame arrived: the rendezvous grace is spent.
            self._first_deadline = None
            self._sock.settimeout(self._deadline)
        return kind, payload

    def send_obj(self, obj: Any) -> None:
        self.send_bytes(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))

    def recv_obj(self) -> Any:
        return pickle.loads(self.recv_bytes())

    def _recv_exact(self, n: int) -> bytearray:
        buf = bytearray(n)
        view = memoryview(buf)
        got = 0
        while got < n:
            try:
                k = self._sock.recv_into(view[got:], min(n - got, 1 << 24))
            except socket.timeout:
                bound = (self._first_deadline or self._deadline
                         or self._sock.gettimeout())
                if metrics.on():
                    _wire_metrics().trip_recv.inc()
                    metrics.record_event("deadline_trip", side="recv",
                                         bound_seconds=bound)
                raise CommTimeoutError(
                    f"no frame within {bound}s "
                    "(HOROVOD_COMM_TIMEOUT_SECONDS or the rendezvous "
                    "window) — peer dead, wedged, or silent")
            if not k:
                raise ConnectionError("peer closed connection")
            got += k
        return buf

    def close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
