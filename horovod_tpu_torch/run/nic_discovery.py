"""Routable-interface (NIC) discovery for multi-host launches — the
port's copy of ``horovod_tpu/run/nic_discovery.py``.

Reference shape (``run/run.py:105-256``): the launcher starts a TCP driver
service, launches a small task on every host (over ssh), and each task
ring-probes the next host — it tries to connect to every advertised
interface address of task ``(i+1) % N`` and reports which ones worked. The
driver then knows, per host, an address its ring predecessor can actually
route to, and the set of interface names that worked on every link.

The result feeds the launcher: the coordinator's and the process group's
addresses use the discovered routable IPs instead of whatever ``-H``
said, so multi-homed hosts work without ``--controller-addr``.

The probe task itself lives in ``task_fn.py`` — standalone and
stdlib-only so the launcher can pipe it over ssh stdin; this module
re-exports it and hosts the driver, whose transport is the job's
authenticated ``Wire`` framing (byte-compatible with the probe's).
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Dict, List, Tuple

from ..common.wire import Wire
from .task_fn import (  # noqa: F401  (re-exported shared implementation)
    PROBE_TIMEOUT,
    list_interfaces,
    run_probe_task,
)


def infer_link_class(ring_addrs) -> str:
    """Classify a ring's link from its launcher-exported addresses
    (comma-separated ``host:port``): every host loopback, or the one
    non-loopback host being this machine, -> ``local``; anything else ->
    ``tcp``. DCN/ICI fabrics cannot be told from plain ethernet by
    address, so operators export ``HOROVOD_RING_LINK_CLASS``. Keys the
    link-class tables in ``common.config``."""
    if not ring_addrs:
        return "local"
    hosts = set()
    for addr in str(ring_addrs).split(","):
        host = addr.rsplit(":", 1)[0].strip().lower()
        if host:
            hosts.add(host)
    local_names = {"127.0.0.1", "localhost", "::1", "0.0.0.0"}
    if hosts <= local_names:
        return "local"
    if len(hosts - local_names) == 1:
        try:
            own = {ip.lower() for _, ip in list_interfaces()}
            if hosts - local_names <= own:
                return "local"
        except OSError:
            pass
    return "tcp"


class NICDriverService:
    """Rendezvous for the probe tasks. One instance per launch; threads
    serve each task connection."""

    def __init__(self, num_hosts: int, timeout: float = 60.0):
        self._num = num_hosts
        self._timeout = timeout
        self._lock = threading.Condition()
        self._registered: Dict[int, dict] = {}
        self._reports: Dict[int, List[Tuple[str, str]]] = {}
        self._srv = socket.create_server(("0.0.0.0", 0))
        self.port = self._srv.getsockname()[1]
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               name="hvd-nic-accept",
                                               daemon=True)
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             name="hvd-nic-serve", daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        wire = Wire(conn)
        try:
            while True:
                msg = wire.recv_obj()
                op = msg.get("op")
                if op == "register":
                    with self._lock:
                        self._registered[msg["index"]] = msg
                        self._lock.notify_all()
                        ok = self._wait(
                            lambda: len(self._registered) == self._num)
                    if not ok:
                        wire.send_obj({"error": "registration timeout"})
                        return
                    nxt = self._registered[(msg["index"] + 1) % self._num]
                    wire.send_obj({"next_addrs": nxt["addrs"],
                                   "next_probe_port": nxt["probe_port"]})
                elif op == "report":
                    with self._lock:
                        self._reports[msg["index"]] = msg["reachable"]
                        self._lock.notify_all()
                        ok = self._wait(
                            lambda: len(self._reports) == self._num)
                    if not ok:
                        wire.send_obj({"error": "report timeout"})
                        return
                    wire.send_obj({"routable": self.routable_addrs(),
                                   "common_interfaces":
                                       sorted(self.common_interfaces())})
                    return
        except (ConnectionError, OSError):
            return
        finally:
            conn.close()

    def _wait(self, pred) -> bool:
        deadline = time.monotonic() + self._timeout
        while not pred():
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            self._lock.wait(remaining)
        return True

    def routable_addrs(self) -> Dict[int, str]:
        """Per host index: an IP of that host proven reachable from its ring
        predecessor (first reported wins; interface enumeration order puts
        real NICs before loopback)."""
        out = {}
        for i in range(self._num):
            pred = (i - 1) % self._num
            reached = self._reports.get(pred, [])
            if reached:
                out[i] = reached[0][1]
        return out

    def common_interfaces(self) -> set:
        """Interface names that worked on every probed link (the
        reference's intersection that feeds ``btl_tcp_if_include``)."""
        sets = [set(name for name, _ in r) for r in self._reports.values()]
        return set.intersection(*sets) if sets else set()

    def done(self) -> bool:
        with self._lock:
            return len(self._reports) == self._num

    def wait_done(self) -> bool:
        with self._lock:
            return self._wait(lambda: len(self._reports) == self._num)

    def close(self) -> None:
        try:
            self._srv.close()
        except OSError:
            pass
