"""Spark driver-side rendezvous service — the port's counterpart of
``horovod_tpu/spark/driver.py``.

Tasks register with a TCP service on the driver, which groups them by
host and replies with everything a rank needs (topology ints, the
controller's address, the ring addresses, the job secret); the task then
calls ``hvd.init()``. The port's ``init`` also joins a
``torch.distributed`` group (the ``group=`` collectives and the parallel
modes run on it), whose store rank 0 hosts: each task binds a third
port for it, and the reply carries rank 0's as ``spmd_coordinator``
(``HOROVOD_SPMD_COORDINATOR``).

Protocol (authenticated ``common/wire.Wire`` frames):
  task  -> driver  {"index", "host", "ring_port", "controller_port",
                    "store_port"}
  driver -> task   {"rank", "size", "local_rank", "local_size",
                    "cross_rank", "cross_size", "controller_addr",
                    "ring_addrs", "spmd_coordinator", "secret"}
"""

from __future__ import annotations

import socket
import threading
from typing import Dict, List, Tuple

from ..common.wire import Wire, make_secret


def compute_assignments(registrations: List[dict]) -> List[dict]:
    """Pure assignment logic (testable without Spark): given each task's
    {"index", "host", "ring_port", "controller_port"[, "store_port"]},
    the per-task environment dict. Ranks are task indices; local ranks
    follow the order of task indices within a host."""
    size = len(registrations)
    by_index = sorted(registrations, key=lambda r: r["index"])
    hosts: List[str] = []
    local_rank: Dict[int, int] = {}
    local_size: Dict[str, int] = {}
    for reg in by_index:
        host = reg["host"]
        if host not in hosts:
            hosts.append(host)
        local_rank[reg["index"]] = local_size.get(host, 0)
        local_size[host] = local_size.get(host, 0) + 1

    rank0 = by_index[0]
    controller_addr = f"{rank0['host']}:{rank0['controller_port']}"
    store_addr = (f"{rank0['host']}:{rank0['store_port']}"
                  if "store_port" in rank0 else None)
    ring_addrs = ",".join(f"{r['host']}:{r['ring_port']}" for r in by_index)
    secret = make_secret()

    out = []
    for reg in by_index:
        host = reg["host"]
        out.append({
            "rank": reg["index"],
            "size": size,
            "local_rank": local_rank[reg["index"]],
            "local_size": local_size[host],
            "cross_rank": hosts.index(host),
            "cross_size": len(hosts),
            "controller_addr": controller_addr,
            "ring_addrs": ring_addrs,
            "spmd_coordinator": store_addr,
            "secret": secret,
        })
    return out


class SparkDriverService:
    """Accept ``num_proc`` registrations, reply with assignments, then
    stop. Runs on the Spark driver; its address travels to the tasks in
    the closure."""

    def __init__(self, num_proc: int, timeout: float = 300.0):
        self.num_proc = num_proc
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("0.0.0.0", 0))
        self._listener.listen(num_proc)
        self._listener.settimeout(timeout)
        self.port = self._listener.getsockname()[1]
        self._thread = threading.Thread(target=self._serve,
                                        name="hvd-spark-driver", daemon=True)
        self._error = None
        self._thread.start()

    def addr(self) -> str:
        return f"{socket.gethostname()}:{self.port}"

    def _serve(self) -> None:
        wires: List[Tuple[dict, Wire]] = []
        try:
            while len(wires) < self.num_proc:
                conn, _ = self._listener.accept()
                wire = Wire(conn)
                wires.append((wire.recv_obj(), wire))
            assignments = compute_assignments([r for r, _ in wires])
            by_index = {a["rank"]: a for a in assignments}
            for reg, wire in wires:
                wire.send_obj(by_index[reg["index"]])
                wire.close()
        except Exception as exc:  # surfaced by join()
            self._error = exc
        finally:
            self._listener.close()

    def join(self) -> None:
        self._thread.join()
        if self._error is not None:
            raise self._error


def _free_port() -> int:
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def register_task(driver_addr: str, index: int) -> dict:
    """Task side: pick this task's ring, controller and store ports,
    register, receive the assignment."""
    host, _, port = driver_addr.rpartition(":")
    sock = socket.create_connection((host, int(port)), timeout=300.0)
    wire = Wire(sock)
    wire.send_obj({
        "index": index,
        "host": socket.gethostname(),
        "ring_port": _free_port(),
        "controller_port": _free_port(),
        "store_port": _free_port(),
    })
    assignment = wire.recv_obj()
    wire.close()
    return assignment
