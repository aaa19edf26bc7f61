"""Fleet router: N data-parallel serving replicas behind one ``submit``
— the port of ``horovod_tpu/serving/router.py``.

One :class:`~horovod_tpu_torch.serving.engine.ServingEngine` is one
replica, so "more traffic" scales by replication, and something has to
spread requests, watch liveness and absorb replica churn. A replica
dying or joining is a **reshape** of the fleet (epoch bump, placement
set changes), never an outage.

Placement is **prefix-affinity-then-least-loaded**: a request whose
first whole page matches a prefix the router recently placed follows it
to the same replica, whose prefix cache holds the shared prompt's pages
warm. Everything else (and every affinity miss, or an affinity target
whose queue is at half its bound, or dead) goes to the replica with the
least queued + running work, read from ``engine.stats()``.

Failure handling rides the engines' own recompute discipline:

* a **dead replica** (engine shut down, or its loop died) is marked
  departed on discovery — at placement time, or when a request handle
  surfaces the failure; queued requests it held were failed by the
  engine and **re-route** on their next ``result()``/``stream()`` poll;
* **in-flight** requests replay on a surviving replica: resubmit the
  ORIGINAL prompt and, greedy decoding being deterministic, skip the
  tokens already streamed.

The router is plain Python over the engines' public API (``submit``,
``stats``, ``closed``, ``shutdown``) and serializes its own bookkeeping
under one lock, always taken strictly before any engine lock it reaches
into (never while holding one). All replicas of ``serving.fleet`` share
one model, so its weights sit on the card once.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..analysis.lockorder import make_lock
from .. import metrics
from ..common import config as hvd_config
from ..common import hvd_logging as logging
from .prefix_cache import page_hashes
from .scheduler import CancelledError, RejectedError, zero_stats

_m = None

#: Most first-page digests the affinity map remembers (LRU beyond it).
#: High-cardinality traffic would otherwise grow the map for the
#: process lifetime; the per-replica PrefixCache it mirrors is bounded
#: (capacity knob / pool pressure), so remembering more routes than the
#: caches can hold warm buys nothing.
AFFINITY_CAPACITY = 4096


def _router_metrics():
    """Lazy registration (never at import time); one owner per
    ``hvd_router_*`` series, with the JAX router's names and help."""
    global _m
    if _m is None:
        from types import SimpleNamespace

        _m = SimpleNamespace(
            replicas=metrics.gauge(
                "hvd_router_replicas",
                "Live serving replicas in the fleet."),
            epoch=metrics.gauge(
                "hvd_router_epoch",
                "Fleet membership epoch (bumped by every replica "
                "departure or join — the serving twin of "
                "hvd_membership_epoch)."),
            requests=metrics.counter(
                "hvd_router_requests_total",
                "Requests placed, by replica id.", ("replica",)),
            reroutes=metrics.counter(
                "hvd_router_reroutes_total",
                "Requests replayed on another replica after their "
                "serving replica died (router-level recompute)."),
            departures=metrics.counter(
                "hvd_router_replica_departures_total",
                "Replica departures (death or scale-down), by replica "
                "id — the fleet-flapping signal.", ("replica",)),
            joins=metrics.counter(
                "hvd_router_replica_joins_total",
                "Replicas joined after fleet creation."),
            affinity_hits=metrics.counter(
                "hvd_router_affinity_hits_total",
                "Placements that followed a warm prefix to its "
                "replica."),
        )
    return _m


@dataclasses.dataclass
class RouterConfig:
    """Router knobs. ``from_env`` reads the ``HOROVOD_ROUTER_*``
    variables through the ``common/config.py`` accessors; explicit
    constructor arguments override the environment."""

    replicas: int = 2       # fleet size when the caller names no count
    affinity: bool = True   # prefix-affinity placement (else least-loaded)
    retries: int = 2        # replays per request after replica death

    @staticmethod
    def from_env() -> "RouterConfig":
        return RouterConfig(
            replicas=hvd_config.router_replicas(),
            affinity=hvd_config.router_affinity(),
            retries=hvd_config.router_retries(),
        )


@dataclasses.dataclass
class _Replica:
    rid: int
    engine: object
    alive: bool = True


class FleetHandle:
    """Caller's view of one routed request. Mirrors
    :class:`~horovod_tpu_torch.serving.engine.RequestHandle` (``result`` /
    ``stream`` / ``cancel``), plus transparent replay: a replica dying
    under the request re-routes it instead of failing it."""

    def __init__(self, router: "Router", prompt: np.ndarray,
                 max_new_tokens: int, temperature: float,
                 replica: _Replica, handle):
        self._router = router
        self._prompt = prompt
        self._max_new_tokens = max_new_tokens
        self._temperature = temperature
        self._replica = replica
        self._handle = handle
        self._delivered = 0
        self.replays = 0
        self._cancelled = False

    @property
    def replica_id(self) -> int:
        """Which replica currently serves this request."""
        return self._replica.rid

    @property
    def state(self) -> str:
        return self._handle.state

    @property
    def warm_pages(self) -> int:
        return self._handle.warm_pages

    def ttft_seconds(self) -> Optional[float]:
        """Submit-to-first-token on the CURRENT serving replica (a
        replayed request reports its replay's latency — the price the
        caller actually paid is visible in ``replays``)."""
        return self._handle.ttft_seconds()

    def result(self, timeout: Optional[float] = None) -> List[int]:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            try:
                return self._handle.result(timeout=remaining)
            except (CancelledError, TimeoutError):
                raise
            except RuntimeError as exc:
                self._reroute(exc)

    def stream(self, timeout: Optional[float] = None) -> Iterator[int]:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            try:
                seen = 0
                for token in self._handle.stream(timeout=remaining):
                    seen += 1
                    if seen > self._delivered:
                        self._delivered += 1
                        yield token
                return
            except (CancelledError, TimeoutError):
                raise
            except RuntimeError as exc:
                self._reroute(exc)

    def cancel(self) -> None:
        self._cancelled = True
        self._handle.cancel()

    def _reroute(self, exc: RuntimeError) -> None:
        """The serving replica failed this request (engine shutdown or
        loop death): mark it departed and resubmit the original prompt
        elsewhere. Greedy decoding replays bit-identical tokens, so
        ``stream`` consumers see an uninterrupted sequence. A SAMPLED
        request (temperature > 0) that already delivered tokens cannot
        replay coherently — the replay draws a different sequence, and
        splicing its tail onto the delivered prefix would hand the
        consumer a frankensequence — so it fails loudly instead (a
        sampled request with nothing delivered yet replays fine: a
        fresh draw is a valid response)."""
        self._router._note_replica_failure(self._replica)
        if self._cancelled:
            raise CancelledError(
                "request was cancelled during replica failover") from exc
        if self._temperature > 0.0 and self._delivered > 0:
            raise RuntimeError(
                "replica died mid-stream of a sampled (temperature > 0) "
                "request; a replay would draw a different sequence and "
                "cannot splice onto the tokens already delivered — "
                "resubmit") from exc
        if self.replays >= self._router.config.retries:
            raise RuntimeError(
                f"request failed on {self.replays + 1} replica(s); "
                f"last error: {exc}") from exc
        self.replays += 1
        self._replica, self._handle = self._router._place(
            self._prompt, self._max_new_tokens, self._temperature,
            exclude={self._replica.rid})
        self._router._count_reroute()


class Router:
    """See module docstring. ``engines`` is a non-empty list of
    :class:`~horovod_tpu_torch.serving.engine.ServingEngine` replicas (usually
    built by :func:`horovod_tpu_torch.serving.fleet`)."""

    def __init__(self, engines, config: Optional[RouterConfig] = None):
        if not engines:
            raise ValueError("a fleet needs at least one replica")
        self.config = config if config is not None else (
            RouterConfig.from_env())
        self._lock = make_lock("serving.router")
        self._replicas: List[_Replica] = [
            _Replica(rid=i, engine=e) for i, e in enumerate(engines)]
        self._next_rid = len(engines)
        self._epoch = 0
        self._requests = 0
        self._reroutes = 0
        self._affinity_hits = 0
        self._departures: Dict[int, int] = {}
        self._joins = 0
        # First-whole-page digest -> rid of the replica whose prefix
        # cache is warm for it (block size is uniform across the
        # fleet). LRU-bounded at AFFINITY_CAPACITY.
        self._affinity: "OrderedDict[bytes, int]" = OrderedDict()
        self._block_size = engines[0].config.block_size
        self._update_gauges()

    # -- submission ---------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               temperature: float = 0.0) -> FleetHandle:
        """Place one request on the fleet. Raises
        :class:`~horovod_tpu_torch.serving.RejectedError` when EVERY live
        replica's admission control refuses, ``RuntimeError`` when no
        replica is alive."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        replica, handle = self._place(prompt, int(max_new_tokens),
                                      float(temperature), exclude=set())
        return FleetHandle(self, prompt, int(max_new_tokens),
                           float(temperature), replica, handle)

    def _place(self, prompt: np.ndarray, max_new_tokens: int,
               temperature: float, exclude: set) -> Tuple[_Replica, object]:
        """Affinity-then-least-loaded placement with failure discovery:
        dead engines found along the way are marked departed, rejecting
        replicas are skipped, and the request lands on the first replica
        that admits it."""
        key = None
        if self.config.affinity:
            digests = page_hashes(prompt, self._block_size)
            key = digests[0] if digests else None
        last_reject: Optional[RejectedError] = None
        for replica, via_affinity in self._candidates(key, exclude):
            if replica.engine.closed:
                self._note_replica_failure(replica)
                continue
            try:
                handle = replica.engine.submit(
                    prompt, max_new_tokens, temperature=temperature)
            except RejectedError as exc:
                last_reject = exc
                continue
            except RuntimeError:
                self._note_replica_failure(replica)
                continue
            with self._lock:
                self._requests += 1
                if key is not None:
                    if via_affinity:
                        self._affinity_hits += 1
                    self._affinity[key] = replica.rid
                    self._affinity.move_to_end(key)
                    while len(self._affinity) > AFFINITY_CAPACITY:
                        self._affinity.popitem(last=False)
            if metrics.on():
                m = _router_metrics()
                m.requests.labels(str(replica.rid)).inc()
                if via_affinity:
                    m.affinity_hits.inc()
            return replica, handle
        if last_reject is not None:
            raise RejectedError(
                f"every live replica rejected the request "
                f"({last_reject})")
        raise RuntimeError("no live serving replica in the fleet")

    def _candidates(self, key: Optional[bytes], exclude: set):
        """(replica, via_affinity) in placement order: the affinity
        target first — unless its queue already sits at half its bound
        (a warm cache does not pay for queueing behind a saturated
        replica) — then the rest by least queued + running work."""
        with self._lock:
            alive = [r for r in self._replicas
                     if r.alive and r.rid not in exclude]
            affinity_rid = self._affinity.get(key) if key is not None \
                else None
        first: List[Tuple[_Replica, bool]] = []
        rest: List[_Replica] = []
        for replica in alive:
            if replica.rid == affinity_rid:
                try:
                    s = replica.engine.stats()
                    saturated = (s["queue_depth"]
                                 >= max(1, s["queue_limit"] // 2))
                except Exception:
                    saturated = True
                if saturated:
                    rest.append(replica)
                else:
                    first.append((replica, True))
            else:
                rest.append(replica)

        def load(replica: _Replica) -> float:
            try:
                s = replica.engine.stats()
            except Exception:
                return float("inf")
            return s["queue_depth"] + s["active_sequences"]

        yield from first
        for replica in sorted(rest, key=load):
            yield (replica, False)

    # -- membership ---------------------------------------------------------

    def add_replica(self, engine) -> int:
        """A joiner: the fleet grows at the next epoch — new placements
        see it immediately (the least-loaded rule naturally drains the
        backlog onto it)."""
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            self._replicas.append(_Replica(rid=rid, engine=engine))
            self._epoch += 1
            self._joins += 1
        logging.info("router: replica %d joined the fleet (epoch %d)",
                     rid, self._epoch)
        if metrics.on():
            _router_metrics().joins.inc()
        self._update_gauges()
        return rid

    def remove_replica(self, rid: int) -> None:
        """Scale-down: shut the replica's engine down (its queued and
        running requests fail there and re-route through their handles)
        and record the departure."""
        with self._lock:
            replica = next((r for r in self._replicas if r.rid == rid),
                           None)
        if replica is None:
            raise ValueError(f"no replica {rid} in the fleet")
        replica.engine.shutdown()
        self._note_replica_failure(replica)

    def _note_replica_failure(self, replica: _Replica) -> None:
        """Reshape, not outage: record the departure once, bump the
        epoch, and keep serving on the survivors."""
        with self._lock:
            if not replica.alive:
                return
            replica.alive = False
            self._epoch += 1
            self._departures[replica.rid] = (
                self._departures.get(replica.rid, 0) + 1)
            # Warm prefixes on a dead replica are gone with its pools.
            self._affinity = OrderedDict(
                (k, rid) for k, rid in self._affinity.items()
                if rid != replica.rid)
        logging.warning(
            "router: replica %d left the fleet (epoch %d); re-routing "
            "its requests to the survivors", replica.rid, self._epoch)
        if metrics.on():
            _router_metrics().departures.labels(str(replica.rid)).inc()
        self._update_gauges()

    def _count_reroute(self) -> None:
        with self._lock:
            self._reroutes += 1
        if metrics.on():
            _router_metrics().reroutes.inc()

    # -- views --------------------------------------------------------------

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def replicas(self) -> List[int]:
        """Live replica ids."""
        with self._lock:
            return [r.rid for r in self._replicas if r.alive]

    def engines(self) -> List[object]:
        """Live replica engines (chaos harnesses kill these directly;
        the router discovers the death like any other)."""
        with self._lock:
            return [r.engine for r in self._replicas if r.alive]

    def engine(self, rid: int):
        """The engine behind replica ``rid`` (dead or alive)."""
        with self._lock:
            for replica in self._replicas:
                if replica.rid == rid:
                    return replica.engine
        raise ValueError(f"no replica {rid} in the fleet")

    def health(self) -> Dict[int, dict]:
        """Per-replica liveness + load, from the replicas' own stats
        endpoints (dead replicas report ``alive: False`` only)."""
        with self._lock:
            replicas = list(self._replicas)
        out: Dict[int, dict] = {}
        for replica in replicas:
            entry = {"alive": replica.alive and not replica.engine.closed}
            if entry["alive"]:
                s = replica.engine.stats()
                entry.update(
                    queue_depth=s["queue_depth"],
                    active_sequences=s["active_sequences"],
                    blocks_in_use=s["blocks_in_use"],
                    requests_finished=s["requests_finished"])
            out[replica.rid] = entry
        return out

    def router_stats(self) -> Dict[str, float]:
        """The four ``router_*`` fields of the serving stats catalog."""
        with self._lock:
            return {
                "router_replicas": sum(
                    1 for r in self._replicas if r.alive),
                "router_requests": self._requests,
                "router_reroutes": self._reroutes,
                "router_replica_departures": sum(
                    self._departures.values()),
            }

    def stats(self) -> Dict[str, float]:
        """Fleet-aggregate serving stats in the ``zero_stats()`` shape:
        counters sum across live replicas, gauges sum (the fleet's pool
        is the union of the replicas' pools), latency percentiles take
        the worst replica (a fleet is as slow as where your request
        landed), and the ``router_*`` fields are live."""
        agg = zero_stats()
        with self._lock:
            engines = [r.engine for r in self._replicas if r.alive]
        worst = ("ttft_p50_seconds", "ttft_p99_seconds",
                 "tpot_p50_seconds", "tpot_p99_seconds")
        for engine in engines:
            s = engine.stats()
            for k, v in s.items():
                if k in worst:
                    agg[k] = max(agg[k], v)
                else:
                    agg[k] = agg.get(k, 0) + v
        # Ratios re-derive from the fleet sums — max() would report the
        # BEST replica's hit rate and mask a cold replica's collapse.
        prefix_total = agg["prefix_hits"] + agg["prefix_misses"]
        agg["prefix_hit_rate"] = (
            round(agg["prefix_hits"] / prefix_total, 4)
            if prefix_total else 0.0)
        agg["block_utilization"] = (
            round(agg["blocks_in_use"] / agg["blocks_total"], 4)
            if agg["blocks_total"] else 0.0)
        agg.update(self.router_stats())
        return agg

    def shutdown(self, timeout: float = 10.0) -> None:
        """Stop every replica engine (intentional teardown: no
        departure is recorded). Idempotent."""
        with self._lock:
            replicas = list(self._replicas)
        for replica in replicas:
            replica.engine.shutdown(timeout=timeout)
        with self._lock:
            for replica in replicas:
                replica.alive = False
        self._update_gauges()

    def _update_gauges(self) -> None:
        if not metrics.on():
            return
        m = _router_metrics()
        with self._lock:
            m.replicas.set(sum(1 for r in self._replicas if r.alive))
            m.epoch.set(self._epoch)
