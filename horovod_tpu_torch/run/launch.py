"""``horovodrun`` for the port — its copy of ``horovod_tpu/run/launch.py``.

Reference: ``horovod/run/run.py`` — parses ``-np``/``-H``, does an ssh
preflight, discovers routable NICs, then fans ranks out. Here the
launcher's jobs are:

  1. mint a per-job HMAC secret and pick the rendezvous addresses,
  2. for remote hosts: cached ssh preflight (reference ``run/run.py:46-102``)
     and NIC discovery,
  3. start one process per rank with the topology exported in env
     (``HOROVOD_RANK/SIZE/LOCAL_RANK/LOCAL_SIZE/CROSS_RANK/CROSS_SIZE/
     SECRET_KEY``),
  4. stream rank-prefixed output, propagate failures, kill stragglers,
     and (``--max-restarts``) relaunch a failed job.

Rendezvous. In the default, eager mode every rank gets two addresses on
two ports: ``HOROVOD_CONTROLLER_ADDR``, the controller's TCP star (the
JAX package's meaning), and ``HOROVOD_SPMD_COORDINATOR``, the
``TCPStore`` of the ``torch.distributed`` process group. The JAX launcher
exports the star alone in eager mode; the port also needs its process
group beside the controller (``group=`` collectives, the parallel modes,
ZeRO and FSDP run on it), so this is one of the two places the two
launchers differ. ``--spmd`` exports the store's address only: no
controller starts, and every collective runs on the process group.

The other is the teardown of a fixed-size job after a rank fails. The
JAX launcher terminates the other ranks at once, which can kill a
survivor while it writes its flight-recorder postmortem (the survivor
sees the failure on its wire, aborts and dumps). The port's launcher
gives them :data:`TEARDOWN_GRACE_S` to exit on their own and then
terminates those still running.

Eager mode also exports the native ring data plane's per-rank addresses
(``HOROVOD_RING_ADDRS``) and, for layouts of several equal host groups,
the hierarchical pair (``HOROVOD_LOCAL_RING_ADDRS`` /
``HOROVOD_CROSS_RING_ADDRS``), exactly as the JAX launcher does:
``init()`` then starts the native engine unless ``HOROVOD_ENGINE=python``
or ``HOROVOD_CPU_OPS=star`` asks otherwise.

Local ranks are direct children; remote hosts (``-H host:slots``) fan out
over ssh with the env inlined. ``--bind-chips`` gives each local rank
its own card through ``CUDA_VISIBLE_DEVICES`` (the rank then binds
``cuda:0``).

``--elastic`` (with ``--min-ranks``, ``--max-ranks``,
``--elastic-respawns``), as in the JAX launcher: every rank gets
``HOROVOD_ELASTIC=1`` and its bounds, the Python controller engine is
pinned and the three ring-address variables are scrubbed (the rings are
fixed-membership), and no process-group store is exported (an elastic
job builds no ``torch.distributed`` group). A dead worker's slot is
respawned as a joiner (``HOROVOD_ELASTIC_JOIN=1``) up to
``--elastic-respawns`` times, with the slot's assignment and the
launcher's environment; a worker that exits with 0 left on purpose and
is not respawned; the coordinator's exit ends the job.

``--trace DIR`` exports ``HOROVOD_TRACE_DIR=DIR`` to every rank: each
writes its collective spans there and rank 0 merges them at a clean
shutdown. A traced job keeps its engine (the native one by default), as
the JAX launcher's does. After the job :func:`_finish_trace` merges
whatever per-rank files exist when rank 0 did not (a crash, a kill) and
writes the straggler report; it never changes the exit code.

The launcher's own local ports (the rendezvous, the store, the rings)
are drawn at random below the kernel's ephemeral range
(``/proc/sys/net/ipv4/ip_local_port_range``) and checked free by a bind.
A port taken by binding to 0 comes from that range, where any process's
outgoing connection may take it before the rank binds it; a gloo group
opens many such connections.
"""

from __future__ import annotations

import argparse
import os
import random
import shlex
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..common import config as config_mod
from ..common.wire import make_secret
from .. import metrics

_m = None


def _launcher_metrics():
    global _m
    if _m is None:
        from types import SimpleNamespace

        _m = SimpleNamespace(restarts=metrics.counter(
            "hvd_launcher_restarts_total",
            "Supervised relaunches performed by horovodrun "
            "--max-restarts."))
    return _m


def parse_hosts(hosts: Optional[str], np_: int) -> List[Tuple[str, int]]:
    """Parse ``-H host1:2,host2:2`` (reference ``run/run.py:285-342``)."""
    if not hosts:
        return [("localhost", np_)]
    out = []
    for part in hosts.split(","):
        part = part.strip()
        if not part:
            continue
        host, _, slots = part.partition(":")
        out.append((host, int(slots) if slots else 1))
    total = sum(s for _, s in out)
    if total < np_:
        raise ValueError(
            f"-np {np_} exceeds total slots {total} in -H {hosts!r}")
    return out


# The lowest port the launcher hands out, and the ports it handed out
# (one process never gives one twice).
# Seconds a fixed-size job's ranks get to exit on their own after a rank
# fails, before they are terminated.
TEARDOWN_GRACE_S = 5.0

_PORT_FLOOR = 10000
_ports_given: set = set()


def _ephemeral_floor() -> int:
    """The first port of the kernel's ephemeral range (32768 when it
    cannot be read)."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 32768


def _bindable(port: int) -> bool:
    with socket.socket() as s:
        try:
            s.bind(("", port))
        except OSError:
            return False
    return True


def _free_port() -> int:
    """A local port that is free now, drawn at random below the
    ephemeral range (see the module docstring); a bind to port 0 only if
    that range has no room."""
    top = _ephemeral_floor()
    rng = random.SystemRandom()
    if top - _PORT_FLOOR >= 1024:
        for _ in range(200):
            port = rng.randrange(_PORT_FLOOR, top)
            if port not in _ports_given and _bindable(port):
                _ports_given.add(port)
                return port
    with socket.socket() as s:
        s.bind(("", 0))
        port = s.getsockname()[1]
    _ports_given.add(port)
    return port


def _derived_port(base: int, offset: int) -> int:
    """Map a base+offset onto a valid port regardless of where the ephemeral
    base landed (remote-host heuristic; override env vars if it clashes)."""
    return 20000 + (base + offset) % 40000


def _is_local(host: str) -> bool:
    return host in ("localhost", "127.0.0.1", socket.gethostname())


def build_rank_env(base: Dict[str, str], rank: int, size: int,
                   local_rank: int, local_size: int, cross_rank: int,
                   cross_size: int, controller_addr: str, secret: str,
                   bind_chips: bool, spmd: bool = False,
                   restart_epoch: int = 0,
                   spmd_addr: Optional[str] = None, elastic: bool = False,
                   min_ranks: int = 1, max_ranks: int = 0,
                   elastic_join: bool = False) -> Dict[str, str]:
    """One rank's environment. Eager mode: ``controller_addr`` is the
    controller's star and ``spmd_addr`` the process group's store;
    ``spmd``: ``controller_addr`` is the store's address (as the JAX
    launcher's single coordinator address) and no star is exported.
    ``elastic``: the elastic knobs, the Python engine pinned, the ring
    addresses scrubbed, and ``HOROVOD_ELASTIC_JOIN`` for a respawned
    slot (``elastic_join``) only."""
    env = dict(base)
    env.update({
        "HOROVOD_RANK": str(rank),
        "HOROVOD_SIZE": str(size),
        "HOROVOD_LOCAL_RANK": str(local_rank),
        "HOROVOD_LOCAL_SIZE": str(local_size),
        "HOROVOD_CROSS_RANK": str(cross_rank),
        "HOROVOD_CROSS_SIZE": str(cross_size),
        "HOROVOD_SECRET_KEY": secret,
        # Supervision attempt number (--max-restarts): training scripts
        # key restart-vs-fresh on this (utils.checkpoint.restart_epoch()).
        "HOROVOD_RESTART_EPOCH": str(restart_epoch),
    })
    if elastic:
        env.update({
            "HOROVOD_ELASTIC": "1",
            "HOROVOD_ELASTIC_MIN_RANKS": str(min_ranks),
            "HOROVOD_ELASTIC_MAX_RANKS": str(max_ranks),
            "HOROVOD_ENGINE": "python",
        })
        for var in ("HOROVOD_RING_ADDRS", "HOROVOD_LOCAL_RING_ADDRS",
                    "HOROVOD_CROSS_RING_ADDRS"):
            env.pop(var, None)
        if elastic_join:
            env["HOROVOD_ELASTIC_JOIN"] = "1"
        else:
            # A rendezvous rank must not inherit a stale join flag from
            # the launcher's own environment.
            env.pop("HOROVOD_ELASTIC_JOIN", None)
    else:
        env.pop("HOROVOD_ELASTIC", None)
        env.pop("HOROVOD_ELASTIC_JOIN", None)
    # Ranks we spawn watch their parent and die when orphaned (local: this
    # launcher; remote: the ssh session's shell). HOROVOD_PARENT_WATCHDOG=0
    # in the launcher's env opts out and is inherited via `base`.
    env.setdefault("HOROVOD_PARENT_WATCHDOG", "1")
    if spmd:
        # Process-group mode: no controller. Scrub any eager-tier
        # endpoints inherited from the launcher's own environment.
        for var in ("HOROVOD_CONTROLLER_ADDR", "HOROVOD_RING_ADDRS",
                    "HOROVOD_LOCAL_RING_ADDRS", "HOROVOD_CROSS_RING_ADDRS",
                    "HOROVOD_ENGINE"):
            env.pop(var, None)
        env["HOROVOD_SPMD_COORDINATOR"] = controller_addr
    else:
        env["HOROVOD_CONTROLLER_ADDR"] = controller_addr
        if spmd_addr:
            env["HOROVOD_SPMD_COORDINATOR"] = spmd_addr
    if bind_chips:
        env["CUDA_VISIBLE_DEVICES"] = str(local_rank)
    return env


_SSH_CACHE = os.path.expanduser("~/.horovod_tpu_torch/ssh_preflight.json")
_SSH_CACHE_TTL_S = 300.0


def _boot_id() -> str:
    """Scope for on-disk monotonic stamps: CLOCK_MONOTONIC is only
    comparable within one boot, so the cache records which boot wrote it
    and entries from any other boot are discarded wholesale."""
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            return f.read().strip()
    except OSError:
        return "unknown-boot"


def ssh_preflight(hosts: List[str], ssh_port: int = 22,
                  use_cache: bool = True, timeout: float = 10.0) -> None:
    """Verify passwordless ssh to every remote host before fanning out
    (reference ``run/run.py:46-102``: threaded check with an on-disk cache
    so repeated launches skip it). Raises RuntimeError listing unreachable
    hosts; successes are cached for five minutes."""
    import json

    cache: Dict[str, float] = {}
    # Monotonic, not wall clock: an NTP step mid-TTL would expire (or
    # revive) entries spuriously. CLOCK_MONOTONIC is boot-relative and
    # only comparable within one boot, so the file carries the writing
    # boot's id and a mismatch discards it entirely (a pre-reboot stamp
    # can otherwise look in-TTL once uptime catches up). The 0 <= age
    # guard additionally drops stamps from the future within a boot.
    now = time.monotonic()
    boot = _boot_id()
    if use_cache:
        try:
            with open(_SSH_CACHE) as f:
                data = json.load(f)
            entries = (data.get("entries", {})
                       if data.get("boot_id") == boot else {})
            # Pre-boot_id cache files (a bare dict) hold wall-clock or
            # foreign-boot stamps: treat as empty, it's a 5-minute cache.
            cache = {h: t for h, t in entries.items()
                     if 0 <= now - t < _SSH_CACHE_TTL_S}
        except (OSError, ValueError, AttributeError):
            cache = {}

    # Cache key includes the port: success on 22 says nothing about 2222.
    def key(h):
        return f"{h}:{ssh_port}"

    to_check = [h for h in hosts if not _is_local(h) and key(h) not in cache]
    failures: Dict[str, str] = {}
    lock = threading.Lock()

    def check(host):
        try:
            res = subprocess.run(
                ["ssh", "-o", "StrictHostKeyChecking=no", "-o",
                 "BatchMode=yes", "-o", f"ConnectTimeout={int(timeout)}",
                 "-p", str(ssh_port), host, "true"],
                capture_output=True, text=True, timeout=timeout + 5)
            ok, msg = res.returncode == 0, (res.stderr or res.stdout).strip()
        except Exception as exc:  # missing ssh binary, subprocess timeout
            ok, msg = False, str(exc)
        with lock:
            if ok:
                cache[key(host)] = now
            else:
                failures[host] = msg

    # daemon=False on purpose: the preflight's join IS the launch gate.
    threads = [threading.Thread(target=check, args=(h,),
                                name=f"hvd-ssh-preflight-{h}", daemon=False)
               for h in to_check]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    if use_cache and cache:
        try:
            os.makedirs(os.path.dirname(_SSH_CACHE), exist_ok=True)
            with open(_SSH_CACHE, "w") as f:
                json.dump({"boot_id": boot, "entries": cache}, f)
        except OSError:
            pass
    if failures:
        detail = "; ".join(f"{h}: {msg or 'ssh failed'}"
                           for h, msg in sorted(failures.items()))
        raise RuntimeError(
            f"ssh preflight failed for {sorted(failures)} — passwordless "
            f"ssh is required for remote hosts ({detail})")


def discover_routable_addrs(hosts: List[str], ssh_port: int, secret: str,
                            timeout: float = 60.0) -> Optional[Dict[str, str]]:
    """Ring-probe every host's interfaces and return {host: routable_ip}
    (reference NIC discovery, ``run/run.py:105-256``): a probe task runs on
    each host (ssh for remote, a thread locally), dials every advertised
    interface of the next host, and the driver keeps, per host, an address
    its predecessor proved reachable. Returns None if discovery can't
    complete — callers fall back to the ``-H`` names."""
    from . import task_fn as task_fn_module
    from .nic_discovery import NICDriverService, list_interfaces, \
        run_probe_task

    if len(hosts) < 2:
        return None
    driver = NICDriverService(len(hosts), timeout=timeout)
    # Remote tasks dial every candidate concurrently; loopback is useless to
    # them (and could even connect to the WRONG host's bound port).
    candidates = [ip for _, ip in list_interfaces()
                  if not ip.startswith("127.")] \
        or [ip for _, ip in list_interfaces()]
    driver_addrs = ",".join(f"{ip}:{driver.port}" for ip in candidates)
    procs: List[Tuple[str, subprocess.Popen, List[str]]] = []
    threads: List[threading.Thread] = []
    thread_errors: List[str] = []
    try:
        for i, host in enumerate(hosts):
            if _is_local(host):
                def _local_probe(idx=i):
                    try:
                        run_probe_task(idx, f"127.0.0.1:{driver.port}")
                    except Exception as exc:  # checked by the poll loop
                        thread_errors.append(f"local probe {idx}: {exc}")

                t = threading.Thread(target=_local_probe,
                                     name=f"hvd-nic-probe-{i}", daemon=True)
                t.start()
                threads.append(t)
            else:
                # The standalone probe script rides ssh stdin (python -):
                # the remote host needs no checkout and pays no package
                # import to enumerate its NICs.
                remote = (f"env HOROVOD_SECRET_KEY={shlex.quote(secret)} "
                          f"python3 - {i} {driver_addrs}")
                # close the script handle once Popen has dup'd it into the
                # child — otherwise one fd leaks per remote host per run.
                with open(task_fn_module.__file__) as script:
                    p = subprocess.Popen(
                        ["ssh", "-o", "StrictHostKeyChecking=no",
                         "-p", str(ssh_port), host, remote],
                        stdin=script,
                        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                        text=True)
                # Drain stderr continuously: a chatty remote interpreter
                # must not wedge on a full pipe mid-protocol.
                buf: List[str] = []
                threading.Thread(target=lambda p=p, b=buf: b.extend(
                    iter(p.stderr.readline, "")),
                    name=f"hvd-nic-stderr-{host}", daemon=True).start()
                procs.append((host, p, buf))
        # Poll instead of blocking: a probe that dies instantly (no remote
        # python3, auth failure) should fail the discovery now, with its
        # stderr, not after the full timeout.
        deadline = time.monotonic() + timeout
        while not driver.done():
            if thread_errors:
                sys.stderr.write(
                    f"horovodrun: NIC {thread_errors[0]}; falling back to "
                    "-H host names\n")
                return None
            for host, p, buf in procs:
                if p.poll() not in (None, 0):
                    err = "".join(buf).strip()
                    sys.stderr.write(
                        f"horovodrun: NIC probe on {host} exited with code "
                        f"{p.returncode}"
                        + (f": {err}" if err else "")
                        + "; falling back to -H host names\n")
                    return None
            if time.monotonic() > deadline:
                sys.stderr.write(
                    "horovodrun: NIC discovery timed out; falling back to "
                    "-H host names (override with --controller-addr / "
                    "HOROVOD_RING_ADDRS if unroutable)\n")
                return None
            time.sleep(0.1)
        routable = driver.routable_addrs()
        return {host: routable[i] for i, host in enumerate(hosts)
                if i in routable}
    finally:
        driver.close()
        for _, p, _ in procs:
            if p.poll() is None:
                p.terminate()


def _stream(prefix: str, pipe, out) -> None:
    for line in iter(pipe.readline, ""):
        out.write(f"{prefix}{line}")
        out.flush()
    pipe.close()


def run(args: argparse.Namespace) -> int:
    """Supervised launch: run the job, and on a non-zero exit tear it down,
    back off, and relaunch up to ``--max-restarts`` times with
    ``HOROVOD_RESTART_EPOCH`` bumped (training scripts resume from their
    latest ``utils/checkpoint.py`` checkpoint)."""
    max_restarts = getattr(args, "max_restarts", 0)
    backoff = max(0.0, getattr(args, "restart_backoff", 1.0))
    epoch = 0
    interrupted = threading.Event()

    def _exit(code: int) -> int:
        # The supervisor's registry and ring live in this process. A
        # supervised run that restarted dumps its own flight recorder so
        # the restart history survives the terminal; the launcher has no
        # HOROVOD_RANK, so the dump lands on the bare path (or "{rank}"
        # expands to "launcher"), never on a rank's postmortem.
        if epoch > 0:
            metrics.record_event("launcher_exit", exit_code=code,
                                 restarts=epoch)
            metrics.dump_flight_recorder("launcher_exit")
        return code

    while True:
        code = _run_attempt(args, restart_epoch=epoch,
                            interrupted=interrupted)
        if interrupted.is_set():
            # Operator-initiated teardown (SIGINT/SIGTERM) is not a fault;
            # never auto-restart over the operator's intent.
            return _exit(_finish_trace(args, code))
        if code == 0 or epoch >= max_restarts:
            if code != 0 and max_restarts > 0:
                sys.stderr.write(
                    f"horovodrun: giving up after {epoch} restart(s); "
                    f"final exit code {code}\n")
            return _exit(_finish_trace(args, code))
        epoch += 1
        delay = min(30.0, backoff * (2.0 ** (epoch - 1)))
        sys.stderr.write(
            f"horovodrun: job failed with exit code {code}; restarting "
            f"(attempt {epoch}/{max_restarts}) in {delay:.1f}s with "
            f"HOROVOD_RESTART_EPOCH={epoch}\n")
        # Event.wait, not time.sleep: a SIGINT during the backoff must
        # cancel the relaunch.
        if interrupted.wait(delay):
            epoch -= 1  # cancelled during backoff: this restart never ran
            return _exit(_finish_trace(args, code))
        # Counted only once the backoff survives: a restart cancelled
        # mid-backoff must not appear in the restart history.
        if metrics.on():
            _launcher_metrics().restarts.inc()
            metrics.record_event("launcher_restart", epoch=epoch,
                                 exit_code=code)


def _finish_trace(args: argparse.Namespace, code: int) -> int:
    """After a ``--trace`` job: rank 0 merged at a clean shutdown; after a
    crash or a kill the per-rank files are still there, so merge what
    exists, write the straggler report if it is missing, and name the
    artifacts. Never changes the exit code."""
    trace_dir = getattr(args, "trace", None)
    if not trace_dir:
        return code
    from .. import trace as trace_mod

    merged = os.path.join(trace_dir, trace_mod.MERGED_TRACE_FILE)
    report = os.path.join(trace_dir, trace_mod.REPORT_FILE)
    try:
        if not os.path.exists(merged):
            if not trace_mod.rank_trace_files(trace_dir):
                sys.stderr.write(f"horovodrun: no per-rank traces under "
                                 f"{trace_dir} to merge\n")
                return code
            trace_mod.merge_trace_dir(trace_dir)
        if not os.path.exists(report):
            trace_mod.write_report(trace_dir, feed=False)
    except (OSError, ValueError) as exc:
        sys.stderr.write(f"horovodrun: trace merge failed: {exc}\n")
        return code
    sys.stderr.write(f"horovodrun: merged trace at {merged}; straggler "
                     f"report at {report}\n")
    return code


def _run_attempt(args: argparse.Namespace, restart_epoch: int = 0,
                 interrupted: Optional[threading.Event] = None) -> int:
    hosts = parse_hosts(args.hosts, args.np)
    if getattr(args, "trace", None):
        # Every rank writes its spans under the shared directory and rank
        # 0 merges them at shutdown; both engines emit them, so the job
        # keeps its engine.
        os.makedirs(args.trace, exist_ok=True)
        os.environ["HOROVOD_TRACE_DIR"] = args.trace
        if args.spmd:
            sys.stderr.write(
                "horovodrun: WARNING --trace has no span source under "
                "--spmd: collective spans come from the eager controllers; "
                "expect no trace.rank*.json files\n")
    size = args.np
    secret = config_mod.secret_key_hex() or make_secret()
    coord_host = hosts[0][0]
    any_remote_host = any(not _is_local(h) for h, _ in hosts)
    host_ip: Dict[str, str] = {}
    if any_remote_host:
        ssh_preflight([h for h, _ in hosts], ssh_port=args.ssh_port,
                      use_cache=not args.disable_cache)
        # The probe's one consumer is the rendezvous host; skip it when the
        # operator gave the address.
        if not args.disable_nic_discovery and not args.controller_addr:
            # Probe tasks and the driver authenticate with the job secret.
            os.environ["HOROVOD_SECRET_KEY"] = secret
            host_ip = discover_routable_addrs(
                [h for h, _ in hosts], args.ssh_port, secret) or {}

    def _public_host(host: str) -> str:
        """Address other hosts should dial for `host`: the ring-probed
        routable IP when discovery ran, else the -H name; local entries in
        mixed jobs need a reachable name, not loopback."""
        if _is_local(host):
            return (host_ip.get(host) or socket.gethostname()
                    if any_remote_host else "127.0.0.1")
        return host_ip.get(host, host)

    coord_host = _public_host(coord_host)
    coord_addr = args.controller_addr or f"{coord_host}:{_free_port()}"
    elastic = bool(getattr(args, "elastic", False))
    # Eager mode: the process group's store listens on a port of its own
    # on the same host (none under --elastic: no group is built).
    store_addr = (None if args.spmd or elastic
                  else f"{coord_host}:{_free_port()}")

    assignments = []  # (rank, host, local_rank, local_size, cross_rank)
    rank = 0
    for cross_rank, (host, slots) in enumerate(hosts):
        local = min(slots, size - rank)
        for lr in range(local):
            assignments.append((rank, host, lr, local, cross_rank))
            rank += 1
        if rank >= size:
            break
    # cross_size counts populated groups: with -np smaller than the total
    # slots, trailing -H entries receive no ranks and must not count.
    cross_size = len({a[4] for a in assignments})

    # Per-rank addresses of the native ring data plane (eager mode only).
    # Local entries bind loopback on verified-free ports; remote ones
    # derive a port from a common base (override: HOROVOD_RING_ADDRS).
    ring_addrs_env = None
    ring_base = _free_port()
    if not args.spmd and not elastic:
        ring_addrs_env = config_mod.ring_addrs() or ",".join(
            f"{_public_host(host)}:{_free_port()}" if _is_local(host)
            else f"{_public_host(host)}:{_derived_port(ring_base, r)}"
            for r, host, _, _, _ in assignments)

    # The hierarchical plane's rings: one inside each host entry plus a
    # ring of the entries' first ranks, exported only for homogeneous
    # layouts (every populated group the same size, > 1) — with mixed
    # sizes the per-rank gates would diverge and the lockstep data phases
    # deadlock. Remote ports sit in disjoint bands of ring_base: flat
    # [0, size), local [size, 2*size), cross [2*size, 3*size).
    local_ring_by_rank: Dict[int, str] = {}
    cross_ring_env = None
    groups: Dict[int, list] = {}
    for a in assignments:
        groups.setdefault(a[4], []).append(a)
    group_sizes = {len(m) for m in groups.values()}
    if not args.spmd and not elastic and len(groups) > 1 \
            and len(group_sizes) == 1 and max(group_sizes) > 1:

        def _group_addr(host, offset):
            if _is_local(host):
                return f"{_public_host(host)}:{_free_port()}"
            return f"{_public_host(host)}:{_derived_port(ring_base, offset)}"

        cross_addrs = []
        for cr in sorted(groups):
            members = groups[cr]
            addrs = ",".join(_group_addr(host, size + r)
                             for r, host, _, _, _ in members)
            for r, _, _, _, _ in members:
                local_ring_by_rank[r] = addrs
            root_r, root_host = members[0][0], members[0][1]
            cross_addrs.append(_group_addr(root_host, 2 * size + root_r))
        cross_ring_env = ",".join(cross_addrs)
        if ("HOROVOD_LOCAL_RING_ADDRS" in os.environ) != \
                ("HOROVOD_CROSS_RING_ADDRS" in os.environ):
            sys.stderr.write(
                "horovodrun: only one of HOROVOD_LOCAL_RING_ADDRS/"
                "HOROVOD_CROSS_RING_ADDRS is set; ignoring it in favor of "
                "the launcher-computed hierarchical rings (set both to "
                "override)\n")

    procs: List[subprocess.Popen] = []
    threads = []

    def spawn(rank, host, local_rank, local_size, cross_rank, join=False):
        env = build_rank_env(
            dict(os.environ), rank, size, local_rank, local_size,
            cross_rank, cross_size, coord_addr, secret, args.bind_chips,
            spmd=args.spmd, restart_epoch=restart_epoch,
            spmd_addr=store_addr, elastic=elastic,
            min_ranks=getattr(args, "min_ranks", 1),
            max_ranks=getattr(args, "max_ranks", 0), elastic_join=join)
        env["HOROVOD_START_TIMEOUT"] = str(args.start_timeout)
        if ring_addrs_env is not None:
            env["HOROVOD_RING_ADDRS"] = ring_addrs_env
            # A complete user-set hierarchical pair wins (inherited with
            # the base env); anything less gets the computed pair, since
            # both consumers need both.
            if rank in local_ring_by_rank and not (
                    "HOROVOD_LOCAL_RING_ADDRS" in os.environ
                    and "HOROVOD_CROSS_RING_ADDRS" in os.environ):
                env["HOROVOD_LOCAL_RING_ADDRS"] = local_ring_by_rank[rank]
                env["HOROVOD_CROSS_RING_ADDRS"] = cross_ring_env
        if _is_local(host):
            cmd = args.command
        else:
            # ssh fan-out with env inlined (reference run/run.py:462-485 via
            # mpirun -x); ranks connect straight back to the rendezvous.
            exports = " ".join(
                f"{k}={shlex.quote(v)}" for k, v in env.items()
                if k.startswith(("HOROVOD_", "CUDA_", "NCCL_",
                                 "PYTHONPATH")))
            remote = f"cd {shlex.quote(os.getcwd())} && env {exports} " + \
                " ".join(shlex.quote(c) for c in args.command)
            cmd = ["ssh", "-o", "StrictHostKeyChecking=no",
                   "-p", str(args.ssh_port), host, remote]
            env = dict(os.environ)
        proc = subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, bufsize=1)
        procs.append(proc)
        t = threading.Thread(
            target=_stream, args=(f"[{rank}]: " if size > 1 else "",
                                  proc.stdout, sys.stdout),
            name=f"hvd-rank-stream-{rank}", daemon=True)
        t.start()
        threads.append(t)
        return proc

    def _terminate_all(signum=None, frame=None):
        if signum is not None and interrupted is not None:
            interrupted.set()  # operator signal: suppress supervised restart
        for p in procs:
            if p.poll() is None:
                p.terminate()

    previous = {sig: signal.signal(sig, _terminate_all)
                for sig in (signal.SIGINT, signal.SIGTERM)}
    exit_code = 0
    assignment_by_rank = {a[0]: a for a in assignments}
    # Elastic: a dead worker is respawned on its own as a joiner, up to
    # --elastic-respawns times a slot; the job ends with the coordinator.
    respawns_left = {a[0]: getattr(args, "elastic_respawns", 0)
                     for a in assignments if a[0] != 0}
    try:
        for a in assignments:
            spawn(*a)
        pending = [(a[0], procs[i]) for i, a in enumerate(assignments)]
        done = False
        teardown_at = None
        while pending and not done:
            if teardown_at is not None and time.monotonic() >= teardown_at:
                teardown_at = None
                _terminate_all()
            for rank_id, p in list(pending):
                rc = p.poll()
                if rc is None:
                    continue
                pending.remove((rank_id, p))
                if not elastic:
                    if rc != 0 and exit_code == 0:
                        exit_code = rc
                        sys.stderr.write(
                            f"horovodrun: rank {rank_id} exited with code "
                            f"{rc}; terminating remaining ranks that have "
                            f"not exited in {TEARDOWN_GRACE_S:g} s\n")
                        teardown_at = time.monotonic() + TEARDOWN_GRACE_S
                    continue
                if rank_id == 0:
                    # The coordinator is the job in elastic mode: its
                    # exit, clean or not, ends the run.
                    exit_code = rc
                    done = True
                    _terminate_all()
                    break
                if rc == 0 or (interrupted is not None
                               and interrupted.is_set()):
                    continue  # graceful leave or operator teardown
                if respawns_left.get(rank_id, 0) > 0:
                    respawns_left[rank_id] -= 1
                    sys.stderr.write(
                        f"horovodrun: rank {rank_id} exited with code {rc}; "
                        "respawning its slot as an elastic joiner "
                        f"({respawns_left[rank_id]} respawn(s) left)\n")
                    pending.append((rank_id, spawn(
                        *assignment_by_rank[rank_id], join=True)))
                else:
                    sys.stderr.write(
                        f"horovodrun: rank {rank_id} exited with code {rc}; "
                        "elastic respawn budget exhausted — continuing with "
                        "the survivors\n")
            if pending and not done:
                time.sleep(0.05)
    finally:
        _terminate_all()
        for p in procs:
            try:
                p.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for t in threads:
            t.join(timeout=2.0)
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    return exit_code


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="horovodrun",
        description="Launch a horovod_tpu_torch job (one process per "
                    "card; no mpirun, no ssh preflight for local jobs).")
    from .. import __version__

    parser.add_argument("-np", "--num-proc", dest="np", type=int,
                        required=True,
                        help="total number of processes (ranks)")
    # argparse's version action exits during parse, before required-arg
    # validation, so plain `horovodrun -v` works.
    parser.add_argument("-v", "--version", action="version",
                        version=f"horovod_tpu_torch v{__version__}")
    parser.add_argument("-H", "--hosts", "--host", default=None,
                        help="host1:slots,host2:slots (default: all local)")
    parser.add_argument("--controller-addr", default=None,
                        help="rendezvous bind address host:port: the "
                             "controller's star, or the process group's "
                             "store under --spmd (default: auto on the "
                             "rank-0 host)")
    parser.add_argument("--bind-chips", action="store_true",
                        help="give each local rank its own card through "
                             "CUDA_VISIBLE_DEVICES (it then binds cuda:0)")
    parser.add_argument("--spmd", action="store_true",
                        help="process-group mode: no controller starts; "
                             "every collective runs on the "
                             "torch.distributed group (NCCL on a card)")
    parser.add_argument("-p", "--ssh-port", type=int, default=22,
                        help="ssh port for remote hosts (reference "
                             "horovodrun -p)")
    parser.add_argument("--start-timeout", type=int, default=600,
                        help="seconds to wait for all ranks to start and "
                             "rendezvous before aborting (reference "
                             "horovodrun --start-timeout)")
    parser.add_argument("--elastic", action="store_true",
                        help="elastic membership: a dead rank re-forms the "
                             "job with the survivors at a bumped membership "
                             "epoch instead of aborting it, dead worker "
                             "slots are respawned one by one as joiners, "
                             "and late workers are admitted at epoch "
                             "boundaries; pins the python controller "
                             "engine and builds no process group")
    parser.add_argument("--min-ranks", type=int, default=1,
                        help="elastic: abort (like a static job) if a "
                             "reshape would drop below this world size "
                             "(default 1)")
    parser.add_argument("--max-ranks", type=int, default=0,
                        help="elastic: park joiners beyond this world size "
                             "until a slot frees (default 0 = unbounded)")
    parser.add_argument("--elastic-respawns", type=int, default=3,
                        help="elastic: times each dead worker slot is "
                             "respawned as a joiner before the job simply "
                             "continues with the survivors (default 3)")
    parser.add_argument("--max-restarts", type=int, default=0,
                        help="on a non-zero rank exit, tear the job down "
                             "and relaunch up to N times with exponential "
                             "backoff and HOROVOD_RESTART_EPOCH bumped "
                             "(default 0 = no restarts)")
    parser.add_argument("--restart-backoff", type=float, default=1.0,
                        help="base seconds for the exponential restart "
                             "backoff (doubles per restart, capped at 30s)")
    parser.add_argument("--disable-cache", action="store_true",
                        help="skip the ssh-preflight result cache "
                             "(reference horovodrun --disable-cache)")
    parser.add_argument("--disable-nic-discovery", action="store_true",
                        help="skip the interface ring-probe on multi-host "
                             "launches and dial the -H names directly")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--trace", metavar="DIR", default=None,
                        help="cluster tracing: every rank writes "
                             "clock-anchored phase spans under DIR "
                             "(HOROVOD_TRACE_DIR), under either engine; "
                             "rank 0 merges them into "
                             "DIR/merged_trace.json with a straggler "
                             "report at shutdown")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="training command")
    args = parser.parse_args(argv)
    if not args.command:
        parser.error("no command given")
    if args.spmd and args.elastic:
        parser.error("--spmd and --elastic conflict: the torch.distributed "
                     "process group is a static world; elastic membership "
                     "lives in the eager controller tier")
    if args.elastic and args.min_ranks > args.np:
        parser.error(f"--min-ranks {args.min_ranks} exceeds -np {args.np}")
    if args.command[0] == "--":
        args.command = args.command[1:]
    return run(args)


if __name__ == "__main__":
    sys.exit(main())
