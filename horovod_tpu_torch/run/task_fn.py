"""Per-host NIC-probe task — the port's copy of
``horovod_tpu/run/task_fn.py`` (reference ``run/task_fn.py``).

Deliberately standalone: stdlib-only, imports nothing of the package —
the launcher pipes this file over ssh stdin (``python - <index> <addrs>``),
so the remote host needs no checkout and pays no torch import just to
enumerate NICs. ``nic_discovery`` imports the shared pieces from here; the
wire framing below must stay byte-compatible with ``common/wire.py``:

    [1-byte kind][4-byte big-endian length][32-byte HMAC-SHA256][payload]

keyed by ``HOROVOD_SECRET_KEY`` (hex) from the environment, HMAC over
kind+payload. The probe protocol only uses kind 0 (DATA) and skips
kind 1 (HEARTBEAT) frames like the package Wire does.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import os
import pickle
import socket
import struct
import sys
import threading
from typing import List, Optional, Sequence, Tuple

PROBE_TIMEOUT = 3.0
_HDR = struct.Struct(">BI")  # wire._HDR: frame kind, payload length
_DIGEST_LEN = 32
_MAX_FRAME = 1 << 31  # wire.MAX_FRAME: bound BEFORE reading the payload
_FRAME_DATA = 0
_FRAME_HEARTBEAT = 1


def _secret() -> bytes:
    # Standalone by contract (ssh-piped, no package on the remote host):
    # the one env read that cannot route through common/config.py.
    key = os.environ.get("HOROVOD_SECRET_KEY")
    if key:
        return bytes.fromhex(key)
    return b"horovod-tpu-default-insecure-key"  # wire.job_secret default


def _send_obj(sock: socket.socket, obj) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    digest = hmac.new(_secret(), bytes((_FRAME_DATA,)) + payload,
                      hashlib.sha256).digest()
    sock.sendall(_HDR.pack(_FRAME_DATA, len(payload)) + digest + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed connection")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def _recv_obj(sock: socket.socket):
    while True:
        header = _recv_exact(sock, _HDR.size + _DIGEST_LEN)
        kind, length = _HDR.unpack(header[:_HDR.size])
        if length > _MAX_FRAME:
            raise RuntimeError(f"oversized probe frame ({length} bytes)")
        payload = _recv_exact(sock, length)
        if not hmac.compare_digest(header[_HDR.size:],
                                   hmac.new(_secret(),
                                            bytes((kind,)) + payload,
                                            hashlib.sha256).digest()):
            raise RuntimeError("HMAC digest mismatch on probe frame")
        if kind == _FRAME_HEARTBEAT:
            continue
        if kind != _FRAME_DATA:
            raise RuntimeError(f"unexpected probe frame kind {kind}")
        return pickle.loads(payload)


def list_interfaces() -> List[Tuple[str, str]]:
    """(interface, IPv4 address) pairs of this host, loopback last (a
    loopback route only helps same-host links)."""
    pairs: List[Tuple[str, str]] = []
    try:
        import fcntl

        SIOCGIFADDR = 0x8915
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            for _, name in socket.if_nameindex():
                try:
                    packed = fcntl.ioctl(
                        s.fileno(), SIOCGIFADDR,
                        struct.pack("256s", name.encode()[:255]))
                    pairs.append((name, socket.inet_ntoa(packed[20:24])))
                except OSError:
                    continue  # interface without an IPv4 address
    except (ImportError, OSError):
        pass
    if not pairs:
        try:
            pairs = [("host", socket.gethostbyname(socket.gethostname()))]
        except OSError:
            pairs = [("lo", "127.0.0.1")]
    pairs.sort(key=lambda p: p[1].startswith("127."))
    return pairs


def _dial_driver(driver_addr: str) -> socket.socket:
    """Dial every candidate concurrently, first answer wins: a firewalled
    candidate black-holes for PROBE_TIMEOUT instead of serialising 30 s
    stalls."""
    candidates = driver_addr.split(",")
    winner: List[socket.socket] = []
    errors: List[Exception] = []
    lock = threading.Lock()
    done = threading.Event()

    def _try(cand):
        host, port = cand.rsplit(":", 1)
        try:
            s = socket.create_connection((host, int(port)),
                                         timeout=PROBE_TIMEOUT)
        except OSError as exc:
            with lock:
                errors.append(exc)
                if len(errors) == len(candidates):
                    done.set()
            return
        with lock:
            if winner:
                s.close()
                return
            winner.append(s)
            done.set()

    for cand in candidates:
        threading.Thread(target=_try, args=(cand,),
                         name=f"hvd-probe-dial-{cand}", daemon=True).start()
    done.wait(PROBE_TIMEOUT + 2.0)
    with lock:
        if not winner:
            raise ConnectionError(
                f"could not reach NIC driver at any of {driver_addr}: "
                f"{errors[-1] if errors else 'timeout'}")
        return winner[0]


def run_probe_task(index: int, driver_addr: str,
                   addrs: Optional[Sequence[Tuple[str, str]]] = None) -> dict:
    """One host's probe: advertise local interfaces, try every interface
    address of the next host in the ring, report the reachable ones.
    Returns the driver's final answer."""
    addrs = list(addrs) if addrs is not None else list_interfaces()

    # Probe listener the *previous* host will dial.
    probe_srv = socket.create_server(("0.0.0.0", 0))
    probe_port = probe_srv.getsockname()[1]
    accepting = True

    def _absorb():
        while accepting:
            try:
                conn, _ = probe_srv.accept()
                conn.close()
            except OSError:
                return

    threading.Thread(target=_absorb, name="hvd-probe-absorb",
                     daemon=True).start()

    sock = _dial_driver(driver_addr)
    # Protocol waits are driver-paced (replies arrive only after every host
    # checks in) — the dial timeout must not apply to them.
    sock.settimeout(None)
    with sock:
        _send_obj(sock, {"op": "register", "index": index,
                         "addrs": addrs, "probe_port": probe_port})
        ans = _recv_obj(sock)
        if "error" in ans:
            raise RuntimeError(f"NIC discovery failed: {ans['error']}")

        # Probe every advertised address concurrently: a veth/docker-heavy
        # peer can advertise dozens, and 3 s each sequentially would starve
        # the other tasks' protocol waits.
        reachable: List[Tuple[str, str]] = []
        lock = threading.Lock()

        def _try(name, ip):
            try:
                with socket.create_connection(
                        (ip, ans["next_probe_port"]),
                        timeout=PROBE_TIMEOUT):
                    with lock:
                        reachable.append((name, ip))
            except OSError:
                pass

        # daemon=False on purpose: the join below IS the probe barrier.
        probes = [threading.Thread(target=_try, args=tuple(a),
                                   name=f"hvd-probe-{a[1]}", daemon=False)
                  for a in ans["next_addrs"]]
        for t in probes:
            t.start()
        for t in probes:
            t.join()
        # Restore the advertised order (real NICs before loopback) so
        # "first reachable" stays meaningful.
        order = {tuple(a): k for k, a in enumerate(ans["next_addrs"])}
        reachable.sort(key=lambda a: order[tuple(a)])

        _send_obj(sock, {"op": "report", "index": index,
                         "reachable": reachable})
        final = _recv_obj(sock)
    accepting = False
    probe_srv.close()
    if "error" in final:
        raise RuntimeError(f"NIC discovery failed: {final['error']}")
    return final


def main() -> int:
    index, driver_addr = int(sys.argv[1]), sys.argv[2]
    final = run_probe_task(index, driver_addr)
    # Machine-readable result on stdout (tests parse it; the launcher's
    # driver already holds the same answer).
    print(json.dumps({"routable": final["routable"],
                      "common_interfaces": final["common_interfaces"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
