"""SimCluster: a 64–256-logical-rank world in one process.

Rank 0 is the REAL coordinator — an unmodified
:class:`~horovod_tpu_torch.controller.controller.Controller` (negotiation,
Tensor Fusion, stall checks, elastic ``reform()``, doctor sweep) over the
real :class:`CoordinatorService` — and ranks 1..N-1 are
:class:`~horovod_tpu_torch.sim.worker.SimWorker` state machines multiplexed
onto the calling thread, each holding a real loopback-TCP wire. The
whole protocol surface (frames, HMAC, deadlines, heartbeats, membership
epochs, protocol monitors) is the production code; only the worker-side
*process* is simulated.

Driving model — strict lockstep re-created by phases:

* :meth:`step` runs one collective step: enqueue on rank 0, send every
  logical rank's tick, receive the fanned-out reply, walk each
  response's data exchange in the identical global order. A step spans
  a couple of controller cycles (the coordinator builds its own tick
  before it blocks on worker ticks, so rank 0's requests ride the
  *next* cycle — exactly as on real hardware, where enqueues race the
  cycle loop).
* A membership change (a killed rank, an admitted joiner) tears the
  step exactly as it tears real in-flight work: the driver acks the
  RESHAPE per worker, services joiner admissions, clears the reshape
  fence, and retries — the ``hvd.elastic.run`` loop, inlined.
* ``driver_threads > 1`` lifts the single-thread multiplexing ceiling
  for thousand-rank worlds: each lockstep *phase* (tick fanout, reply
  fanout, each response's send half, then its recv half) is sharded
  across a small named pool (``hvd-sim-shard-N``) with a barrier
  between phases, so the global phase order — the thing the protocol
  monitors check — is preserved while the O(ranks) per-phase walk
  parallelizes. Any given wire is touched by exactly one thread at a
  time (a rank stays on its shard for the whole phase), so per-wire
  protocheck/HMAC state needs no extra locking.

Environment: the harness owns the process env for its lifetime (the
controller reads ``HOROVOD_*`` at init and during reshapes) and restores
every key it touched at :meth:`stop`. The response cache is
ON by default (``cache_capacity``): sim workers replicate the bitmask
machinery (``sim/worker.py``), so cache-on negotiation simulates
faithfully; pass ``cache_capacity=0`` to force every cycle down the
full negotiation path when that is the path being measured
(``sim/measure.py`` uses unique tensor names instead, so its rows
exercise full negotiation either way; the JAX package's
docs/simcluster.md lists the remaining caveats).
"""

from __future__ import annotations

import dataclasses
import os
import queue
import socket
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import fault
from .. import metrics
from ..analysis import protocol
from ..analysis.lockorder import make_lock
from ..common.config import DEFAULT_CACHE_CAPACITY, Config
from ..common.topology import Topology
from ..common.wire import RanksChangedError
from ..controller.controller import Controller
from .worker import SimOp, SimWorker

# Keys the harness force-clears so an ambient launcher/test environment
# cannot leak a data plane, a fault plan, or a trace dir into the sim.
_SCRUB_KEYS = (
    "HOROVOD_FAULT_PLAN", "HOROVOD_RING_ADDRS", "HOROVOD_LOCAL_RING_ADDRS",
    "HOROVOD_CROSS_RING_ADDRS", "HOROVOD_TRACE_DIR", "HOROVOD_TIMELINE",
    "HOROVOD_ELASTIC_JOIN", "HOROVOD_AUTOTUNE", "HOROVOD_METRICS_PORT",
    "HOROVOD_FLIGHT_RECORDER", "HOROVOD_HIERARCHICAL_ALLREDUCE",
    "HOROVOD_HIERARCHICAL_ALLGATHER", "HOROVOD_CPU_OPS",
    "HOROVOD_BUCKET_BYTES",
)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# Lazy per-module metric namespace (the package convention;
# metrics.reset_for_tests drops it between clusters).
_m = None


def _sim_metrics():
    global _m
    if _m is None:
        from types import SimpleNamespace

        _m = SimpleNamespace(
            logical_ranks=metrics.gauge(
                "hvd_sim_logical_ranks",
                "Logical world size this simcluster multiplexes"),
            driver_threads=metrics.gauge(
                "hvd_sim_driver_threads",
                "Shard threads the lockstep driver fans phases across"))
    return _m


class _DriverPool:
    """The shard pool behind ``driver_threads``: one task queue per named
    worker thread plus a shared completion queue. :meth:`run_phase` is a
    barrier — it returns (re-raising the first shard failure) only after
    every shard finished, which is exactly the lockstep guarantee the
    single-threaded driver gave for free. The pool is created and fed by
    ONE driver thread, so the only shared mutable state is the closed
    flag (guarded by a tracked lock, the JAX package's docs/locking.md)."""

    def __init__(self, threads: int):
        self.threads = threads
        self._lock = make_lock("sim.driver_pool")
        self._closed = False
        self._tasks: List[queue.Queue] = [queue.Queue()
                                          for _ in range(threads)]
        self._done: queue.Queue = queue.Queue()
        self._threads = []
        for i in range(threads):
            t = threading.Thread(target=self._run, args=(i,),
                                 name=f"hvd-sim-shard-{i}", daemon=True)
            t.start()
            self._threads.append(t)

    def _run(self, i: int) -> None:
        while True:
            fn = self._tasks[i].get()
            if fn is None:
                return
            try:
                fn()
            except BaseException as exc:  # relayed to the driver thread
                self._done.put(exc)
            else:
                self._done.put(None)

    def run_phase(self, fns: Sequence[Callable[[], None]]) -> None:
        """Run one lockstep phase: every callable executes on its shard
        thread; block until all completed (the phase barrier); re-raise
        the first failure after the barrier so a dead logical rank
        surfaces exactly like it does on the serial driver."""
        with self._lock:
            closed = self._closed
        if closed:
            raise RuntimeError("simcluster driver pool is closed")
        for i, fn in enumerate(fns):
            self._tasks[i % self.threads].put(fn)
        first: Optional[BaseException] = None
        for _ in fns:
            exc = self._done.get()
            if exc is not None and first is None:
                first = exc
        if first is not None:
            raise first

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        for q in self._tasks:
            q.put(None)
        for t in self._threads:
            t.join(timeout=5.0)


class SimStepTorn(RuntimeError):
    """A step kept tearing past the retry budget — the membership never
    settled (more concurrent churn than the scenario scripted?)."""


@dataclasses.dataclass
class StepSpec:
    """One collective every rank submits this step. ``make(rank)`` builds
    the logical rank's contribution (rank 0 = the real controller)."""

    kind: str
    name: str
    make: Callable[[int], np.ndarray]
    root_rank: int = -1


def allreduce_spec(name: str, make: Callable[[int], np.ndarray]) -> StepSpec:
    return StepSpec("allreduce", name, make)


@dataclasses.dataclass
class StepResult:
    torn: bool = False            # membership changed mid-step; retry
    aborted: bool = False         # coordinated abort reached the workers
    shutdown: bool = False        # the reply echoed the shutdown flag
    cycles: int = 0               # controller cycles this step consumed
    results0: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    error0: Optional[BaseException] = None  # rank 0 handle failure


class SimCluster:
    """N logical ranks: 1 real coordinator + N-1 multiplexed workers."""

    # A step that needs more cycles than this never completes (a rank
    # stopped participating without the coordinator noticing — a harness
    # bug, not a scenario outcome); fail loudly instead of hanging.
    MAX_CYCLES_PER_STEP = 64

    def __init__(self, ranks: int, elastic: bool = True,
                 protocheck: bool = True, enable_metrics: bool = True,
                 min_ranks: int = 1, max_ranks: int = 0,
                 comm_timeout: Optional[float] = None,
                 env: Optional[Dict[str, str]] = None,
                 driver_threads: int = 1,
                 cache_capacity: Optional[int] = None):
        if ranks < 2:
            raise ValueError("SimCluster needs >= 2 logical ranks")
        self.ranks = ranks
        self.elastic = elastic
        self.protocheck = protocheck
        self.enable_metrics = enable_metrics
        self.min_ranks = min_ranks
        self.max_ranks = max_ranks
        self.comm_timeout = comm_timeout
        self.driver_threads = max(1, int(driver_threads))
        self.cache_capacity = (DEFAULT_CACHE_CAPACITY if cache_capacity
                               is None else max(0, int(cache_capacity)))
        self.extra_env = dict(env or {})
        self.addr = f"127.0.0.1:{_free_port()}"
        self.controller: Optional[Controller] = None
        self.workers: Dict[int, SimWorker] = {}
        self.pending_joiners: List[SimWorker] = []
        self.step_index = 0
        self.protocheck_report: Optional[dict] = None
        self.final_metrics: Optional[dict] = None
        self._touched_env: set = set()
        self._env_snapshot: Dict[str, str] = {}
        self._connect_error: Optional[BaseException] = None
        self._pool: Optional[_DriverPool] = None
        self._stopped = False

    # ------------------------------------------------------------ lifecycle

    def __enter__(self) -> "SimCluster":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def start(self) -> "SimCluster":
        self._apply_env()
        fault.reset()  # a prior test's cached plan must not leak in
        if self.protocheck:
            protocol.refresh_mode()
            protocol.recorder().clear()
        if self.enable_metrics:
            metrics.enable()
        if self.driver_threads > 1:
            self._pool = _DriverPool(self.driver_threads)

        def _dial(rank: int) -> None:
            self.workers[rank] = SimWorker(
                self.addr, rank, self.ranks,
                comm_timeout=self.comm_timeout,
                cache_capacity=self.cache_capacity)

        def _connect() -> None:
            try:
                # Sharded dialing through the same pool the phases use:
                # at 1024 logical ranks the serial connect handshake walk
                # alone would dominate start().
                self._fanout(range(1, self.ranks), _dial)
            except BaseException as exc:  # surfaced by start() below
                self._connect_error = exc

        connector = threading.Thread(
            target=_connect, name="hvd-sim-connect", daemon=True)
        connector.start()
        topo = Topology(rank=0, size=self.ranks, local_rank=0, local_size=1,
                        cross_rank=0, cross_size=self.ranks)
        try:
            try:
                self.controller = Controller(Config.from_env(), topo)
            finally:
                connector.join(timeout=30.0)
            if self._connect_error is not None:
                raise RuntimeError("simcluster: worker connect failed"
                                   ) from self._connect_error
        except BaseException:
            # A failed start must not leak its process-wide state (env
            # overrides, protocheck mode, half-connected wires) into the
            # rest of the test session.
            self.stop()
            raise
        if self.enable_metrics and metrics.on():
            m = _sim_metrics()
            m.logical_ranks.set(float(self.ranks))
            m.driver_threads.set(float(self.driver_threads))
        return self

    def stop(self) -> None:
        if self._stopped:
            return
        self._stopped = True
        try:
            if (self.controller is not None
                    and not self.controller._closed.is_set()):
                try:
                    # A boundary reshape (e.g. a still-parked joiner
                    # being absorbed) can tear the shutdown step; retry
                    # so the cooperative teardown actually lands.
                    for _ in range(3):
                        res = self.step([], shutdown=True)
                        if not res.torn:
                            break
                except Exception:
                    pass  # a dying cluster still tears down below
            if self.controller is not None:
                self.controller.shutdown()
        finally:
            if self.protocheck:
                self.protocheck_report = protocol.recorder().report()
            if self.enable_metrics:
                self.final_metrics = metrics.snapshot()
            for rank in sorted(self.workers):
                self.workers[rank].close()
            for joiner in self.pending_joiners:
                joiner.close()
            if self.enable_metrics:
                metrics.reset_for_tests()
            if self._pool is not None:
                self._pool.close()
                self._pool = None
            self._restore_env()
            fault.reset()
            if self.protocheck:
                protocol.refresh_mode()
                protocol.recorder().clear()

    # -------------------------------------------------------------- env ctx

    def _apply_env(self) -> None:
        self._env_snapshot = dict(os.environ)
        overrides = {
            "HOROVOD_RANK": "0",
            "HOROVOD_SIZE": str(self.ranks),
            "HOROVOD_LOCAL_RANK": "0",
            "HOROVOD_LOCAL_SIZE": "1",
            "HOROVOD_CONTROLLER_ADDR": self.addr,
            "HOROVOD_ENGINE": "python",
            "HOROVOD_CYCLE_TIME": "1",
            "HOROVOD_CACHE_CAPACITY": str(self.cache_capacity),
        }
        if self.elastic:
            overrides["HOROVOD_ELASTIC"] = "1"
            overrides["HOROVOD_ELASTIC_MIN_RANKS"] = str(self.min_ranks)
            overrides["HOROVOD_ELASTIC_MAX_RANKS"] = str(self.max_ranks)
        if self.comm_timeout is not None:
            overrides["HOROVOD_COMM_TIMEOUT_SECONDS"] = str(self.comm_timeout)
        if self.protocheck:
            overrides["HOROVOD_PROTOCHECK"] = "1"
        overrides.update(self.extra_env)
        for key in _SCRUB_KEYS:
            if key not in overrides and key in os.environ:
                self._touched_env.add(key)
                del os.environ[key]
        if not self.elastic:
            for key in ("HOROVOD_ELASTIC", "HOROVOD_ELASTIC_MIN_RANKS",
                        "HOROVOD_ELASTIC_MAX_RANKS"):
                if key in os.environ:
                    self._touched_env.add(key)
                    del os.environ[key]
        if not self.protocheck and "HOROVOD_PROTOCHECK" in os.environ:
            self._touched_env.add("HOROVOD_PROTOCHECK")
            del os.environ["HOROVOD_PROTOCHECK"]
        for key in sorted(overrides):
            self._touched_env.add(key)
            os.environ[key] = overrides[key]

    def _restore_env(self) -> None:
        for key in sorted(self._touched_env):
            if key in self._env_snapshot:
                os.environ[key] = self._env_snapshot[key]
            else:
                os.environ.pop(key, None)
        self._touched_env.clear()

    # ---------------------------------------------------------- phase fanout

    def _fanout(self, items: Sequence, fn: Callable) -> None:
        """Run ``fn(item)`` for every item — one lockstep phase. With a
        driver pool armed the items shard round-robin across the named
        threads (each item stays on one thread for the whole phase, so
        per-wire monitor state is single-threaded) and this blocks until
        every shard finished: the phase barrier. Serial otherwise —
        identical call order, identical failure surface."""
        items = list(items)
        if self._pool is None or len(items) <= 1:
            for item in items:
                fn(item)
            return
        shards = [items[i::self._pool.threads]
                  for i in range(self._pool.threads)]

        def _make(shard):
            def _run():
                for item in shard:
                    fn(item)
            return _run

        self._pool.run_phase([_make(s) for s in shards if s])

    # ------------------------------------------------------------ membership

    @property
    def alive_worker_ranks(self) -> List[int]:
        return sorted(r for r, w in sorted(self.workers.items()) if w.alive)

    @property
    def size(self) -> int:
        """Current world size as the driver believes it (1 + alive
        logical workers); the coordinator's own view is
        ``controller.topo.size``."""
        return 1 + len(self.alive_worker_ranks)

    @property
    def epoch(self) -> int:
        return self.controller.membership_epoch

    def kill(self, rank: int) -> None:
        """Crash a logical rank (socket closes with no farewell — what a
        SIGKILLed process looks like from the coordinator's wire)."""
        self.workers[rank].kill()

    def leave(self, rank: int) -> None:
        """Graceful departure; wire-identical to :meth:`kill` (the exit
        code distinction is a process-tier concept)."""
        self.workers[rank].close()

    def spawn_joiner(self, timeout: float = 10.0) -> SimWorker:
        """Dial a new logical rank into the live job as an elastic
        joiner and wait until the coordinator has parked it (so the next
        epoch boundary deterministically sees it)."""
        service = self.controller._service
        before = service.parked_joiner_count()
        joiner = SimWorker(self.addr, 0, self.size, join=True,
                           comm_timeout=self.comm_timeout,
                           cache_capacity=self.cache_capacity)
        deadline = time.monotonic() + timeout
        while service.parked_joiner_count() <= before:
            if time.monotonic() > deadline:
                joiner.close()
                raise TimeoutError(
                    "simcluster: joiner was not parked within "
                    f"{timeout}s (join listener dead?)")
            time.sleep(0.002)
        self.pending_joiners.append(joiner)
        return joiner

    # ------------------------------------------------------------- stepping

    def _enqueue_rank0(self, specs: Sequence[StepSpec]) -> List[Tuple[
            StepSpec, object]]:
        handles = []
        for spec in specs:
            arr = torch.from_numpy(np.ascontiguousarray(spec.make(0)))
            if spec.kind == "allreduce":
                h = self.controller.allreduce_async(arr, average=False,
                                                    name=spec.name)
            elif spec.kind == "allgather":
                h = self.controller.allgather_async(arr, name=spec.name)
            elif spec.kind == "broadcast":
                h = self.controller.broadcast_async(arr, spec.root_rank,
                                                    name=spec.name)
            else:
                raise ValueError(f"unknown step kind {spec.kind!r}")
            handles.append((spec, h))
        return handles

    def step(self, specs: Sequence[StepSpec],
             delays: Optional[Dict[int, float]] = None,
             skip_ticks: Optional[set] = None,
             shutdown: bool = False) -> StepResult:
        """Drive one collective step across every alive logical rank.

        ``delays`` injects per-rank tick lateness (the flapping-NIC /
        straggler seam: the named rank's tick is sent that many seconds
        after everyone else's, which the coordinator measures and
        charges exactly as it would a slow host). ``skip_ticks`` ranks
        stay silent this step (a dropped tick: the coordinator's recv
        deadline — not this driver — must diagnose them)."""
        self.step_index += 1
        res = StepResult()
        delays = delays or {}
        skip = skip_ticks or set()
        handles = self._enqueue_rank0(specs)
        for spec, handle in handles:
            # Fast-fail: an enqueue rejected at the door (reshape fence,
            # shutdown, duplicate name) never negotiates — ticking the
            # workers for it would stall the whole step.
            if handle.done():
                try:
                    res.results0[spec.name] = handle.wait().numpy()
                except RanksChangedError as exc:
                    res.torn = True
                    res.error0 = exc
                except RuntimeError as exc:
                    res.error0 = exc
        if res.torn or res.error0 is not None:
            if res.torn:
                self._settle_membership()
            return res
        expected = {spec.name for spec in specs}
        # The completion probe below compares against THIS step's
        # executions; a tensor name re-used across steps (the cache-hit
        # workload shape) must not satisfy the probe with last step's
        # execution.
        for r in self.alive_worker_ranks:
            self.workers[r].executed.clear()
        ops_by_rank = {
            r: [SimOp(spec.kind, spec.name, np.asarray(spec.make(r)),
                      spec.root_rank) for spec in specs]
            for r in self.alive_worker_ranks}

        first_cycle = True
        while res.cycles < self.MAX_CYCLES_PER_STEP:
            res.cycles += 1
            alive = self.alive_worker_ranks
            if not alive:
                # Every logical worker is gone. Elastic: the coordinator
                # re-forms down to a size-1 world (fence tears this
                # step; the retry executes rank 0's collectives alone).
                # Non-elastic: _fail_all resolves the handles with the
                # abort diagnosis. Either way the handles settle — wait
                # on them instead of abandoning them unresolved.
                try:
                    for spec, handle in handles:
                        res.results0[spec.name] = handle.wait().numpy()
                except RanksChangedError as exc:
                    res.torn = True
                    res.error0 = exc
                except RuntimeError as exc:
                    res.error0 = exc
                break
            # -- tick fanout: on-time ranks first (sharded across the
            # driver pool when armed), then injected stragglers in delay
            # order — delayed ticks stay on the driver thread, where the
            # cumulative sleeps keep their relative lateness exact (the
            # coordinator's tick-lateness accounting sees them).
            on_time = [r for r in alive
                       if r in skip or not (first_cycle and r in delays)]
            fc = first_cycle

            def _tick(rank):
                self.workers[rank].send_tick(
                    ops_by_rank.get(rank) if fc else None,
                    shutdown=shutdown)

            self._fanout([r for r in on_time if r not in skip], _tick)
            slept = 0.0
            for rank in sorted((r for r in alive
                                if first_cycle and r in delays
                                and r not in skip),
                               key=lambda r: (delays[r], r)):
                pause = delays[rank] - slept
                if pause > 0:
                    time.sleep(pause)
                    slept = delays[rank]
                self.workers[rank].send_tick(ops_by_rank.get(rank),
                                             shutdown=shutdown)
            first_cycle = False
            # -- reply fanout (statuses land keyed by rank; dict writes
            # from shard threads hit distinct keys, GIL-atomic)
            statuses: Dict[int, Tuple[str, Optional[dict]]] = {}

            def _recv(rank):
                statuses[rank] = self.workers[rank].recv_reply()

            self._fanout([r for r in alive if r not in skip], _recv)
            replies = {}
            for rank in sorted(statuses):
                status, reply = statuses[rank]
                if status == "reshape":
                    res.torn = True
                elif status == "abort":
                    res.aborted = True
                else:
                    replies[rank] = reply
            if res.torn or res.aborted:
                break
            # -- data phases, identical global order on every rank:
            # cache-bypass responses first (the order _process_reply
            # executes them on rank 0), then the negotiated responses.
            # Every rank pops its own bypass list (the cache mutation);
            # the lists agree by cache coherence, so the lowest rank's
            # copy drives the walk like `reply` does for responses.
            reply = replies[min(replies)] if replies else None
            if reply is None:
                break
            ranks = sorted(replies)
            bypass: List = []
            for rank in ranks:
                popped = self.workers[rank].take_bypass(replies[rank])
                if rank == ranks[0]:
                    bypass = popped
            for response in bypass:
                self._fanout(ranks, lambda rank, r=response:
                             self.workers[rank].data_send(r))
                self._fanout(ranks, lambda rank, r=response:
                             self.workers[rank].data_recv(
                                 r, cache_put=False))
            responses = reply["responses"].responses
            for response in responses:
                self._fanout(ranks, lambda rank, r=response:
                             self.workers[rank].data_send(r))
                self._fanout(ranks, lambda rank, r=response:
                             self.workers[rank].data_recv(r))
            if reply["responses"].shutdown:
                res.shutdown = True
                for rank in sorted(replies):
                    self.workers[rank].close()
                break
            # -- completion: every expected tensor executed somewhere
            if not expected:
                break
            probe = self.workers[min(replies)]
            if expected <= probe.executed:
                try:
                    for spec, handle in handles:
                        res.results0[spec.name] = handle.wait().numpy()
                except RanksChangedError as exc:
                    res.torn = True
                    res.error0 = exc
                except RuntimeError as exc:
                    res.error0 = exc
                break
        else:
            raise SimStepTorn(
                f"step {self.step_index}: {len(expected)} collectives not "
                f"executed after {self.MAX_CYCLES_PER_STEP} cycles")
        if res.torn:
            self._settle_membership()
        return res

    def run_step(self, specs: Sequence[StepSpec],
                 retries: int = 8, **kw) -> StepResult:
        """:meth:`step` with the ``hvd.elastic.run`` retry contract: a
        torn step (membership changed under it) is retried at the new
        epoch until it completes or the budget runs out."""
        for _ in range(retries):
            res = self.step(specs, **kw)
            if not res.torn:
                return res
            kw.pop("delays", None)  # injected lateness fired already
        raise SimStepTorn(
            f"step kept tearing through {retries} retries "
            f"(epoch {self.epoch})")

    # -- reshape settling ----------------------------------------------------

    def _settle_membership(self) -> None:
        """After a torn step: drive the logical ranks through however
        many reform attempts the coordinator needs (a correlated
        group-kill makes ``reform()`` drop dead members mid-handshake
        and retry at fresh epochs), service joiner admissions, then —
        once the coordinator's epoch drain has fenced — adopt the final
        membership and clear the fence (the user-level acknowledgement
        ``hvd.elastic.run`` performs).

        Event-driven off the coordinator's own state, never off frame
        peeking: a reform attempt in flight is visible as
        ``service.epoch`` beyond every survivor's adopted epoch (each
        attempt bumps it before sending assignments), and an absorbed
        joiner is visible as the parked count dropping (reform pops
        parked wires into its member list before the handshake) — both
        deterministic signals that the matching frames are already
        committed to the sockets, so the blocking drives below cannot
        hang."""
        survivors = [w for _, w in sorted(self.workers.items()) if w.alive]
        service = self.controller._service
        deadline = time.monotonic() + 30.0
        while (self.controller._reshape_fence is None
               and not self.controller._closed.is_set()):
            if time.monotonic() > deadline:
                raise TimeoutError(
                    "simcluster: coordinator never finished the epoch "
                    "drain (no reshape fence within 30s)")
            absorbed = (len(self.pending_joiners)
                        - service.parked_joiner_count())
            for _ in range(max(0, absorbed)):
                joiner = self.pending_joiners.pop(0)
                joiner.await_admission()
                survivors.append(joiner)
            adopted = max((w.epoch for w in survivors if w.alive),
                          default=0)
            if survivors and service.epoch > adopted:
                # A further reform attempt is in flight: every alive
                # member's RESHAPE is already (or about to be) in its
                # socket — drive each one through ack. The empty tick
                # is dead-epoch traffic the coordinator's drain
                # discards; if the reform completed in the meantime the
                # tick simply becomes the new epoch's first (empty)
                # cycle and the recv returns its reply.
                self._fanout([w for w in survivors if w.alive],
                             lambda w: w.send_tick([]))
                self._fanout([w for w in survivors if w.alive],
                             lambda w: w.recv_reply())
            else:
                time.sleep(0.0005)
        survivors = [w for w in survivors if w.alive]
        self.workers = {w.rank: w for w in survivors}
        if len(self.workers) != len(survivors):
            raise RuntimeError(
                "simcluster: duplicate ranks after reshape "
                f"({sorted(w.rank for w in survivors)})")
        self.controller.clear_reshape_fence()

    # ---------------------------------------------------------- measurement

    def measure_heartbeat_fanout(self, repeats: int = 5) -> float:
        """Median wall time of one full coordinator heartbeat sweep over
        every connected wire — the O(N) liveness cost the scaling model
        calibrates (``utils/scaling_model.py``)."""
        service = self.controller._service
        samples = []
        for _ in range(repeats):
            wires = service._hb_wires()
            t0 = time.perf_counter()
            for wire in wires:
                wire.try_send_heartbeat()
            samples.append(time.perf_counter() - t0)
        return float(np.median(samples))

    def reshape_seconds_observed(self) -> List[float]:
        """Coordinator-measured elastic reshape durations so far (the
        ``hvd_elastic_reshape_seconds`` histogram's samples are bucketed;
        this returns mean-preserving values: total seconds / count)."""
        snap = metrics.snapshot()
        entry = snap.get("hvd_elastic_reshape_seconds")
        if not entry or entry.get("type") != "histogram":
            return []
        out = []
        for _, val in sorted(entry.get("values", [])):
            count = int(val.get("count", 0))
            if count:
                out.extend([float(val.get("sum", 0.0)) / count] * count)
        return out

    def roll_window(self) -> Optional[dict]:
        """Close one telemetry window deterministically (the rank-0
        roller's ``roll_now``): tests and the
        measurement harness roll at step boundaries instead of waiting
        out HOROVOD_METRICS_WINDOW_SECONDS. The real coordinator already
        started the roller and registered the live-calibration observer
        at init (both idempotent — re-arming here only covers a cluster
        whose controller predates the roller). None with metrics off."""
        if not (self.enable_metrics and metrics.on()):
            return None
        from ..utils import live_calibration

        roller = metrics.start_window_roller()
        roller.add_observer(live_calibration.on_window)
        return roller.roll_now()

    def doctor_report(self) -> dict:
        """The live cluster doctor over this process's registry — the
        same Evidence path the rank-0 periodic sweep and /doctor use."""
        from .. import doctor

        return doctor.report()
