"""Parent-death watchdog for launcher-spawned ranks — the port's copy of
``horovod_tpu/run/watchdog.py``.

Reference: ``spark/task/mpirun_exec_fn.py:25-35`` — an orphaned rank
(its parent launcher died) kills itself instead of living on, holding
the coordinator's port and its card until some peer timeout fires. The
contract covers ``horovodrun``'s local children and ssh-fanned remote
ranks (their watched parent is the ssh session's shell — the session
tears down when the launcher side goes away).

Two layers, both armed by :func:`install`:

* ``prctl(PR_SET_PDEATHSIG, SIGTERM)`` (Linux): the kernel delivers
  SIGTERM the instant the parent dies — no polling latency.
* A daemon thread polling ``os.getppid()``: catches the cases prctl
  can't (non-Linux, or the exec'd interpreter re-parented between fork
  and install) by noticing the re-parent to init/subreaper. It sends
  SIGTERM to let ``hvd.shutdown``/atexit run, then escalates to
  ``os._exit`` after a grace period in case the engine is wedged on the
  very sockets the dead launcher held open.

Ranks opt in via ``HOROVOD_PARENT_WATCHDOG=1``, which the launcher
exports; standalone processes calling
``hvd.init()`` from a user's shell are never watched (their parent
dying — the shell exiting — must not kill training).
"""

from __future__ import annotations

import os
import signal
import sys
import threading
import time

_POLL_INTERVAL_S = 1.0
_GRACE_S = 5.0

_lock = threading.Lock()
# Keyed on the installing pid, not a bare bool: after a fork the child
# inherits the module state but NOT the watchdog thread (threads don't
# survive fork), so a bool would leave forked ranks unwatched while
# install() refuses to re-arm.
_installed_pid: "int | None" = None


def _set_pdeathsig(signum: int) -> bool:
    """Best-effort ``prctl(PR_SET_PDEATHSIG, signum)`` (Linux only)."""
    try:
        import ctypes

        libc = ctypes.CDLL(None, use_errno=True)
        PR_SET_PDEATHSIG = 1
        return libc.prctl(PR_SET_PDEATHSIG, signum, 0, 0, 0) == 0
    except Exception:
        return False


def install(poll_interval: float = _POLL_INTERVAL_S,
            grace: float = _GRACE_S) -> bool:
    """Arm the watchdog against the CURRENT parent. Idempotent per
    process (a forked child re-arms against ITS parent); returns whether
    a watchdog is armed. No-op (False) when already orphaned at install
    time — with the original parent unknowable, killing would be a
    guess."""
    global _installed_pid
    with _lock:
        if _installed_pid == os.getpid():
            return True
        parent = os.getppid()
        if parent <= 1:
            return False
        _set_pdeathsig(signal.SIGTERM)

        def _watch():
            from ..common.config import env_rank

            while True:
                time.sleep(poll_interval)
                if os.getppid() != parent:
                    rank = env_rank()
                    try:
                        # Best-effort: stderr may BE a pipe to the dead
                        # parent — a BrokenPipeError here must not stop
                        # the reaping below.
                        sys.stderr.write(
                            f"horovod_tpu_torch: parent {parent} died; "
                            "terminating orphaned rank "
                            f"{'?' if rank is None else rank}\n")
                        sys.stderr.flush()
                    except Exception:
                        pass
                    os.kill(os.getpid(), signal.SIGTERM)
                    time.sleep(grace)
                    os._exit(signal.SIGTERM + 128)

        threading.Thread(target=_watch, name="hvd-parent-watchdog",
                         daemon=True).start()
        _installed_pid = os.getpid()
        return True


def maybe_install_from_env() -> bool:
    """Arm iff the launcher asked for it (``HOROVOD_PARENT_WATCHDOG``).
    Called from ``hvd.init()``; safe to call any number of times."""
    from ..common.config import _env_bool

    if not _env_bool("HOROVOD_PARENT_WATCHDOG"):
        return False
    return install()
