"""The serving engine: continuous batching over the paged decode path —
the port of ``horovod_tpu/serving/engine.py``.

One :class:`ServingEngine` owns (a) the physical paged KV pools (one
``(num_blocks + 1, block_size, Hkv*head_dim)`` tensor pair per layer on
the model's device — block 0 is the null block), (b) the
:class:`~horovod_tpu_torch.serving.scheduler.Scheduler` bookkeeping, and
(c) the device programs, plain functions that update the pools in place:

* ``_paged_prefill`` — one request's (re-)prefill: the prompt runs the
  model's contiguous prefill (the computation ``generate()`` performs),
  the produced KV rows land in the request's blocks as whole pages, and
  the first new token is picked from the final logits.
* ``_paged_warm_prefill`` — the same for a prefix-cache hit: only the
  cold tail runs, attending the warm pages gathered from the pool.
* ``_copy_blocks`` — copy-on-write page copies.
* ``_paged_step`` — ONE decode step for the whole slot batch: every
  running sequence advances one token through the paged decode kernel
  (``ops.decode_attention.paged_decode_attention``).

On a card, and with no tensor-parallel lockstep, the engine captures
``_paged_step`` at ``max_batch`` as one CUDA graph per ``all_greedy``
value when it is built (:class:`_DecodeGraph`) — the counterpart of the
JAX engine compiling ``_paged_step`` once per engine, static in
``all_greedy`` — and each decode step copies its slot arrays into the
graph's input buffers and replays it: one launch from the host instead
of every kernel of the step. Prefill and copy-on-write stay eager (their
shapes vary). The tensor-parallel engine stays eager by design: its
steps hold gloo collectives and the ``_agree`` digests, which a graph
cannot capture; so does the CPU. A capture or replay that fails raises;
nothing falls back to the eager step.

Between them sits iteration-level scheduling: sequences join and leave
the decode batch at step boundaries.

Threading: driven synchronously (``run_until_idle()`` — deterministic,
what the tests use) or by its own daemon loop (``start()``; thread named
``hvd-serving-engine``). All state lives under one lock; device work
runs outside it so ``submit``/``stream`` never block on a decode step.

Telemetry, as in the JAX engine: the ``hvd_serving_*`` metrics (when
``metrics.on()``; registered at first use, never at import), whose
unlabelled gauges describe the whole process (the sum over every live
engine, so N fleet replicas in one process publish the fleet), and the
``schedule`` / ``prefill`` / ``decode`` spans under ``HOROVOD_TRACE_DIR``
(``trace.serving.rank<N>.json``, written at ``shutdown()``).

Tensor parallelism: a ``LlamaLM(mesh=...)`` sharded over a TP axis is
served by one engine per rank of the axis, each holding a pool of its
Hkv/tp K/V heads, its decode steps on the ``kernel_tp`` path (the
classifier's verdict, as in ``generate()``). The model's forward runs
collectives over the axis, so the ranks' engines must run in lockstep:
every scheduling decision the same on every rank. That is settled by
giving every rank the same submissions, in the same order, and driving
each engine synchronously (``step()`` / ``run_until_idle()``); the
scheduler, the block pool and the prefix cache are deterministic, and
the gathered logits are the same bytes on every rank, so greedy picks
and seeded samples agree. ``start()`` (whose loop would see
submissions at different times on different ranks) is refused under
TP, and each step checks the ranks' plans agree (a digest of the
admitted requests, then of the decode batch, gathered over the axis)
before running work that holds collectives, so a divergence raises
instead of hanging.
"""

from __future__ import annotations

import contextlib
import hashlib
import itertools
import math
import os
import threading
import time
import weakref
from collections import deque
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..analysis.lockorder import make_lock
from .. import metrics
from ..common import config as hvd_config
from ..common import hvd_logging as logging
from ..common.profiler import named_scope
from ..ops import decode_attention as decode_ops
from ..models.llama import (
    DecodePath,
    _decode_kernel_on,
    classify_decode_sharding,
    decode_path_context,
    pick_tokens,
)
from ..trace import TraceWriter
from ..trace.tracer import SERVING_TRACE_FILE_FMT
from .kv_blocks import BlockPool, padded_table
from .prefix_cache import PrefixCache
from .scheduler import (
    CANCELLED,
    FAILED,
    FINISHED,
    REJECTED,
    RUNNING,
    TERMINAL_STATES,
    WAITING,
    CancelledError,
    RejectedError,
    Request,
    Scheduler,
    ServingConfig,
    zero_stats,
)

_m = None

# Every live engine in this process (a fleet runs several): the
# unlabelled hvd_serving_* gauges describe the PROCESS, so each sweep
# publishes the sum over live engines' latest per-engine snapshots.
_LIVE_ENGINES: "weakref.WeakSet" = weakref.WeakSet()


def _serving_metrics():
    """Lazy registration (never at import time); one owner per
    ``hvd_serving_*`` series, with the JAX engine's names and help."""
    global _m
    if _m is None:
        from types import SimpleNamespace

        _m = SimpleNamespace(
            queue_depth=metrics.gauge(
                "hvd_serving_queue_depth",
                "Requests waiting for a decode slot."),
            queue_limit=metrics.gauge(
                "hvd_serving_queue_limit",
                "Admission bound on the waiting queue "
                "(HOROVOD_SERVING_QUEUE_DEPTH)."),
            active=metrics.gauge(
                "hvd_serving_active_sequences",
                "Sequences in the decode batch right now."),
            blocks_in_use=metrics.gauge(
                "hvd_serving_blocks_in_use",
                "Allocated KV-cache blocks."),
            blocks_total=metrics.gauge(
                "hvd_serving_blocks_total",
                "KV-cache pool capacity in blocks (null block excluded)."),
            block_util=metrics.gauge(
                "hvd_serving_block_utilization",
                "blocks_in_use / blocks_total, 0..1."),
            requests=metrics.counter(
                "hvd_serving_requests_total",
                "Serving requests by terminal outcome.", ("outcome",)),
            preemptions=metrics.counter(
                "hvd_serving_preemptions_total",
                "Sequences preempted (blocks dropped, recompute queued) "
                "because the block pool ran dry."),
            tokens=metrics.counter(
                "hvd_serving_tokens_generated_total",
                "Tokens produced across all requests."),
            steps=metrics.counter(
                "hvd_serving_steps_total",
                "Continuous-batching decode steps executed."),
            ttft=metrics.histogram(
                "hvd_serving_ttft_seconds",
                "Submit-to-first-token latency per request."),
            tpot=metrics.histogram(
                "hvd_serving_tpot_seconds",
                "Inter-token latency per generated token (decode steps "
                "plus any scheduling/preemption stall between them)."),
            prefix_hits=metrics.counter(
                "hvd_serving_prefix_hits_total",
                "Whole KV pages admitted warm (mapped copy-free onto "
                "blocks the prefix index already held)."),
            prefix_misses=metrics.counter(
                "hvd_serving_prefix_misses_total",
                "Whole KV pages that had to prefill cold."),
            prefix_cached=metrics.gauge(
                "hvd_serving_prefix_cached_blocks",
                "Blocks currently referenced by the prefix index."),
            prefix_evictions=metrics.counter(
                "hvd_serving_prefix_evictions_total",
                "Prefix-index entries dropped (pool pressure or "
                "capacity LRU)."),
            blocks_shared=metrics.gauge(
                "hvd_serving_blocks_shared",
                "Blocks with more than one live reference right now."),
            cow=metrics.counter(
                "hvd_serving_cow_copies_total",
                "Copy-on-write page copies (a sequence about to write "
                "into a shared page got a private copy first)."),
        )
    return _m


def _count_outcome(outcome: str) -> None:
    if metrics.on():
        _serving_metrics().requests.labels(outcome).inc()


# ---------------------------------------------------------------------------
# Device programs. Each updates the pools IN PLACE (the JAX programs
# donate the pools for the same effect) and runs under inference mode.


def _paged_prefill(model, pools, prompt, plen: int, table_row,
                   temperature: float, generator) -> int:
    """(Re-)prefill ONE request into its blocks; returns its first
    token. ``prompt`` (1, window) arrives PADDED to whole pages (``plen``
    real tokens); the pad rows are causally inert — the picked logit at
    ``plen - 1`` attends only positions below it, and the pad KV rows in
    the last page sit above every later causal bound until the decode
    loop overwrites them. The prompt runs the model's contiguous prefill
    on a scratch cache, then each layer's KV rows land in the pool as
    whole pages."""
    first = next(iter(pools.values()))["k"]
    f = first.shape[2]
    block_size = first.shape[1]
    window = prompt.shape[1]
    scratch = {
        layer: {"k": torch.zeros((1, window, f), dtype=first.dtype,
                                 device=first.device),
                "v": torch.zeros((1, window, f), dtype=first.dtype,
                                 device=first.device)}
        for layer in pools
    }
    logits, scratch = model(prompt, cache=scratch, cache_index=0)
    nb = window // block_size
    for layer in pools:
        pools[layer]["k"][table_row] = scratch[layer]["k"][0].view(
            nb, block_size, f)
        pools[layer]["v"][table_row] = scratch[layer]["v"][0].view(
            nb, block_size, f)
    return int(pick_tokens(logits[:, plen - 1], temperature, generator)[0])


def _paged_warm_prefill(model, pools, tail, plen: int, warm_table,
                        cold_table, warm_pages: int, total_pages: int,
                        temperature: float, generator) -> int:
    """Prefill of a request whose first ``warm_pages`` whole pages are
    already in the pool (prefix-cache hit): gather the warm pages into
    the scratch cache's leading rows, run the model over ONLY the cold
    tail at ``cache_index = warm_len`` (the general masked-einsum path),
    write the cold pages to ``cold_table``, and pick the first token from
    the logits at global position ``plen - 1``. The scratch window is the
    same ``total_pages * block_size`` rows as a cold prefill's, and rows
    past the valid window are zeros whose masked logits contribute exact
    zeros."""
    first = next(iter(pools.values()))["k"]
    f = first.shape[2]
    block_size = first.shape[1]
    window = total_pages * block_size
    warm_len = warm_pages * block_size
    scratch = {}
    for layer in pools:
        entry = {}
        for name in ("k", "v"):
            buf = torch.zeros((1, window, f), dtype=first.dtype,
                              device=first.device)
            buf[0, :warm_len] = pools[layer][name][warm_table].reshape(
                warm_len, f)
            entry[name] = buf
        scratch[layer] = entry
    logits, scratch = model(tail, cache=scratch, cache_index=warm_len)
    nb_cold = total_pages - warm_pages
    for layer in pools:
        for name in ("k", "v"):
            pools[layer][name][cold_table] = scratch[layer][name][
                0, warm_len:].reshape(nb_cold, block_size, f)
    return int(pick_tokens(logits[:, plen - 1 - warm_len], temperature,
                           generator)[0])


def _copy_blocks(pools, src, dst) -> None:
    """Copy-on-write: duplicate whole pages ``src[i] -> dst[i]`` in every
    layer's pools (the right-hand gather copies before the write)."""
    for layer in pools:
        for name in ("k", "v"):
            pool = pools[layer][name]
            pool[dst] = pool[src]


def _paged_step(model, pools, tokens, lens, tables, temps,
                all_greedy: bool, generator):
    """One continuous-batching decode step over the whole slot batch:
    every slot's incoming token (position ``lens[i]``) writes its KV row
    into its block and attends its own window. Inactive slots point at
    the null block with lens 0 — their lane computes garbage that the
    host discards. Returns the (max_batch,) next tokens."""
    cache = {layer: {"k": pools[layer]["k"], "v": pools[layer]["v"],
                     "tables": tables}
             for layer in pools}
    logits, _ = model(tokens[:, None], cache=cache, cache_index=lens)
    last = logits[:, -1].float()
    next_tokens = torch.argmax(last, dim=-1)
    if not all_greedy:
        probs = torch.softmax(last / temps.clamp_min(1e-6)[:, None], dim=-1)
        sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
        next_tokens = torch.where(temps > 0.0, sampled, next_tokens)
    return next_tokens


# The eager decode step, for comparisons only: engines built while this
# is False run ``_paged_step`` from Python on the card too
# (:func:`_eager_decode`; the CUDA tests and ``chip_smoke.py`` use it).
_DECODE_GRAPHS = True


@contextlib.contextmanager
def _eager_decode():
    """Engines built inside run the eager decode step (private: for
    holding the captured step against it)."""
    global _DECODE_GRAPHS
    prev, _DECODE_GRAPHS = _DECODE_GRAPHS, False
    try:
        yield
    finally:
        _DECODE_GRAPHS = prev


class _DecodeGraph:
    """``_paged_step`` at the engine's ``max_batch`` captured as one CUDA
    graph, for one ``all_greedy`` value. Its inputs are static buffers
    each step copies into (tokens, lens, tables, temps); the pools stay
    where they are, and the next tokens are read from the graph's static
    output. The sampled graph registers the engine's generator, so a
    replay draws from the same stream of random numbers an eager step
    would. The kernel launches the capture recorded are counted at each
    replay (``decode_ops.count_replay``)."""

    def __init__(self, engine: "ServingEngine", all_greedy: bool,
                 stream: "torch.cuda.Stream"):
        dev = engine._device
        size, slots = engine._config.max_batch, engine._table_slots
        self.tokens = torch.zeros((size,), dtype=torch.int64, device=dev)
        self.lens = torch.zeros((size,), dtype=torch.int32, device=dev)
        self.tables = torch.zeros((size, slots), dtype=torch.int32,
                                  device=dev)
        self.temps = torch.zeros((size,), dtype=torch.float32, device=dev)
        self.graph = torch.cuda.CUDAGraph()
        if not all_greedy:
            self.graph.register_generator_state(engine._generator)
        with torch.inference_mode(), \
                decode_path_context(engine._path.path), \
                decode_ops.recording_launches() as self.launches, \
                torch.cuda.graph(self.graph, stream=stream,
                                 capture_error_mode="thread_local"):
            self.out = _paged_step(engine._model, engine._pools, self.tokens,
                                   self.lens, self.tables, self.temps,
                                   all_greedy, engine._generator)

    def replay(self, tokens, lens, tables, temps) -> torch.Tensor:
        """One decode step: the slot arrays (numpy) in, the next tokens
        (the graph's output buffer, valid until the next replay) out."""
        for buf, arr in ((self.tokens, tokens), (self.lens, lens),
                         (self.tables, tables), (self.temps, temps)):
            buf.copy_(torch.from_numpy(arr))
        self.graph.replay()
        decode_ops.count_replay(self.launches)
        return self.out


def _capture_decode_graphs(
        engine: "ServingEngine") -> Dict[bool, _DecodeGraph]:
    """Both of an engine's decode graphs. One greedy step runs first on
    the capture stream (on the null block: every slot's lens is 0), so
    that lazy state (library handles, cached tables) is made outside the
    graphs; it draws no random number."""
    dev = engine._device
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    size, slots = engine._config.max_batch, engine._table_slots
    with torch.cuda.stream(stream), torch.inference_mode(), \
            decode_path_context(engine._path.path):
        _paged_step(engine._model, engine._pools,
                    torch.zeros((size,), dtype=torch.int64, device=dev),
                    torch.zeros((size,), dtype=torch.int32, device=dev),
                    torch.zeros((size, slots), dtype=torch.int32,
                                device=dev),
                    torch.zeros((size,), dtype=torch.float32, device=dev),
                    True, engine._generator)
    graphs = {flag: _DecodeGraph(engine, flag, stream)
              for flag in (True, False)}
    torch.cuda.current_stream(dev).wait_stream(stream)
    return graphs


class RequestHandle:
    """Caller's view of one submitted request: block on the result,
    stream tokens as they are produced, or cancel."""

    def __init__(self, engine: "ServingEngine", req: Request):
        self._engine = engine
        self._req = req

    @property
    def rid(self) -> int:
        return self._req.rid

    @property
    def state(self) -> str:
        with self._engine._cond:
            return self._req.state

    @property
    def warm_pages(self) -> int:
        """Whole pages this request's last admission mapped warm from
        the prefix cache (0 = fully cold)."""
        with self._engine._cond:
            return self._req.warm_pages

    def ttft_seconds(self) -> Optional[float]:
        """Submit-to-first-token latency, or None before the first
        token."""
        with self._engine._cond:
            if self._req.first_token_t is None:
                return None
            return self._req.first_token_t - self._req.submit_t

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Generated token ids (prompt excluded). Raises
        :class:`CancelledError` on cancellation, ``RuntimeError`` on
        engine failure, ``TimeoutError`` on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._engine._cond:
            while self._req.state not in TERMINAL_STATES:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(
                            f"request {self._req.rid} still "
                            f"{self._req.state} after {timeout}s")
                self._engine._cond.wait(remaining)
            return self._finish_locked()

    def _finish_locked(self) -> List[int]:
        if self._req.state == FINISHED:
            return list(self._req.tokens)
        if self._req.state == CANCELLED:
            raise CancelledError(f"request {self._req.rid} was cancelled")
        raise RuntimeError(
            f"request {self._req.rid} {self._req.state}: "
            f"{self._req.error}")

    def stream(self, timeout: Optional[float] = None) -> Iterator[int]:
        """Yield generated token ids as they are produced. The lock is
        dropped while the consumer runs, so slow consumers never stall
        the engine loop."""
        sent = 0
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._engine._cond:
                while (len(self._req.tokens) <= sent
                       and self._req.state not in TERMINAL_STATES):
                    remaining = None
                    if deadline is not None:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            raise TimeoutError(
                                f"request {self._req.rid} produced no "
                                f"token within {timeout}s")
                    self._engine._cond.wait(remaining)
                chunk = self._req.tokens[sent:]
                state = self._req.state
            for token in chunk:
                yield token
            sent += len(chunk)
            if state in TERMINAL_STATES and not chunk:
                if state != FINISHED:
                    with self._engine._cond:
                        self._finish_locked()
                return

    def cancel(self) -> None:
        """Cancel: a waiting request leaves the queue immediately, a
        running one is evicted (blocks freed) at the next step
        boundary."""
        self._engine._cancel(self._req)


class ServingEngine:
    """See module docstring. ``model``: any causal LM of the port with
    the cache call contract (``LlamaLM``, ``MoeLM``; it owns its weights
    and device); ``config``: the engine knobs (default
    ``ServingConfig.from_env()``); ``seed``: the engine's sampling
    ``torch.Generator``. A model whose config declares no
    ``max_seq_len`` (``MoeConfig``) needs ``ServingConfig.max_seq_len``."""

    def __init__(self, model, config: Optional[ServingConfig] = None,
                 seed: int = 0):
        self._model = model
        self._device = model.device
        cfg = config if config is not None else ServingConfig.from_env()
        mcfg = model.config
        model_max = int(getattr(mcfg, "max_seq_len", 0) or 0)
        max_seq = cfg.max_seq_len or model_max
        if not max_seq:
            raise ValueError(
                "the model declares no max_seq_len; set "
                "ServingConfig.max_seq_len (HOROVOD_SERVING_MAX_SEQ_LEN)")
        if model_max:
            max_seq = min(max_seq, model_max)
        self._config = cfg = ServingConfig(
            max_batch=cfg.max_batch, block_size=cfg.block_size,
            num_blocks=cfg.num_blocks, queue_depth=cfg.queue_depth,
            max_seq_len=max_seq, prefix_cache=cfg.prefix_cache,
            prefix_capacity=cfg.prefix_capacity)
        self._table_slots = (max_seq + cfg.block_size - 1) // cfg.block_size
        num_blocks = cfg.num_blocks or cfg.max_batch * self._table_slots
        pool = BlockPool(num_blocks, cfg.block_size)
        self._prefix = (PrefixCache(pool, cfg.prefix_capacity)
                        if cfg.prefix_cache else None)
        self._sched = Scheduler(pool, cfg.max_batch, cfg.queue_depth,
                                max_seq, prefix_cache=self._prefix)
        # The decode-path verdict the engine's programs run under, fixed
        # at construction (as the JAX engine classifies once, from the
        # model's sharding).
        self._path = classify_decode_sharding(
            model, np.zeros((cfg.max_batch, 1), np.int64),
            mcfg.num_kv_heads)
        if not _decode_kernel_on():
            self._path = DecodePath("einsum", "decode_kernel_disabled()")
        # A tensor-parallel model: the engines of its axis run in
        # lockstep (module doc).
        tp = getattr(model, "tp", None)
        self._tp = tp if tp is not None and tp.size > 1 else None

        head_dim = mcfg.dim // mcfg.num_heads
        shape = (num_blocks + 1, cfg.block_size,
                 model.kv_heads * head_dim)
        self._pools = {
            f"layer_{i}": {
                "k": torch.zeros(shape, dtype=mcfg.dtype,
                                 device=self._device),
                "v": torch.zeros(shape, dtype=mcfg.dtype,
                                 device=self._device)}
            for i in range(mcfg.num_layers)
        }

        self._lock = make_lock("serving.engine")
        self._cond = threading.Condition(self._lock)
        self._generator = torch.Generator(device=self._device)
        self._generator.manual_seed(seed)
        self._rid = itertools.count()
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._closed = False
        self._submitted = 0
        self._finished = 0
        self._cancelled = 0
        self._tokens_generated = 0
        self._steps = 0
        # Sliding latency windows: bounded memory on a long-lived engine.
        self._ttfts: deque = deque(maxlen=4096)
        self._tpots: deque = deque(maxlen=4096)
        self._live_peak = 0
        self._prefix_published: Dict[str, int] = {}
        # Latest per-engine gauge numbers (the whole dict swapped under
        # the GIL; peers read it without this engine's lock when summing
        # the process-wide gauges, see _publish_gauge_totals).
        self._gauge_snapshot: Dict[str, float] = {}
        _LIVE_ENGINES.add(self)
        self._tracer: Optional[TraceWriter] = None
        self._trace_checked = False
        self._graphs: Optional[Dict[bool, _DecodeGraph]] = None
        if (_DECODE_GRAPHS and self._device.type == "cuda"
                and self._tp is None):
            self._graphs = _capture_decode_graphs(self)

    # -- public API ---------------------------------------------------------

    @property
    def config(self) -> ServingConfig:
        return self._config

    @property
    def decode_path(self):
        """The :class:`~horovod_tpu_torch.models.llama.DecodePath` the
        engine's programs run under."""
        return self._path

    @property
    def closed(self) -> bool:
        """True once the engine can no longer serve (shutdown, or its
        loop died)."""
        with self._cond:
            return self._closed

    def submit(self, prompt, max_new_tokens: int,
               temperature: float = 0.0) -> RequestHandle:
        """Admit one generation request. Raises
        :class:`~horovod_tpu_torch.serving.RejectedError` when admission
        control refuses (queue at bound / request can never fit), and
        ``ValueError`` on malformed arguments."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        with self._cond:
            if self._closed:
                raise RuntimeError("engine is shut down")
            try:
                self._sched.check_admissible(prompt.shape[0],
                                             int(max_new_tokens))
            except RejectedError:
                if metrics.on():
                    m = _serving_metrics()
                    m.requests.labels(REJECTED).inc()
                    # Publish the queue gauges here too (an engine whose
                    # every submission is rejected would never set them).
                    # The engine lock is held, so refresh this engine's
                    # snapshot directly and publish the lock-free sum.
                    snap = dict(self._gauge_snapshot)
                    snap["queue_depth"] = self._sched.queue_depth_now()
                    snap["queue_limit"] = self._sched.queue_depth
                    self._gauge_snapshot = snap
                    _publish_gauge_totals(m)
                raise
            req = Request(rid=next(self._rid), prompt=prompt,
                          max_new_tokens=int(max_new_tokens),
                          temperature=float(temperature),
                          submit_t=time.monotonic())
            self._sched.enqueue(req)
            self._submitted += 1
            self._cond.notify_all()
        self._update_gauges()
        return RequestHandle(self, req)

    def step(self) -> bool:
        """One engine iteration: retire cancellations, admit + prefill
        joiners, top up block tables (preempting on exhaustion), run one
        batched decode step. Returns whether work remains. Only ONE
        driver may call it (the loop thread, or the caller in
        synchronous mode)."""
        t_sched = time.monotonic()
        with self._cond:
            for req in list(self._sched.running.values()):
                if req.cancel_requested:
                    self._sched.retire(req, CANCELLED)
                    self._cancelled += 1
                    _count_outcome(CANCELLED)
                    self._cond.notify_all()
            # A cancel that landed while the request sat RUNNING may have
            # been overtaken by a preemption; purge those here so admit()
            # does not pay a recompute prefill for a retired request.
            for req in [r for r in self._sched.waiting
                        if r.cancel_requested]:
                self._sched.cancel_waiting(req)
                self._cancelled += 1
                _count_outcome(CANCELLED)
                self._cond.notify_all()
            admitted = self._sched.admit()
            self._note_live_blocks()
            running = len(self._sched.running)
            plan = [(r.rid, len(r.current_prompt()), list(r.blocks))
                    for r in admitted] if self._tp is not None else None
        self._agree("admission", lambda: (plan, running))
        tracer = self._maybe_tracer()
        if tracer is not None:
            tracer.span("schedule", t_sched, time.monotonic(),
                        admitted=len(admitted), running=running)

        for req in admitted:
            self._prefill(req)

        with self._cond:
            preempted = self._sched.ensure_decode_capacity()
            copies = self._sched.pending_copies
            self._sched.pending_copies = []
            if preempted and metrics.on():
                _serving_metrics().preemptions.inc(len(preempted))
            self._note_live_blocks()
            batch = self._sched.active()
            arrays = self._build_batch(batch) if batch else None
        if preempted:
            logging.warning(
                "serving: block pool exhausted — preempted %d sequence(s) "
                "for recompute (%s)", len(preempted),
                ", ".join(f"rid {r.rid}" for r in preempted))
        if copies:
            # Copy-on-write: duplicate the shared pages into the fresh
            # private blocks BEFORE the decode step writes into them.
            src = self._to_device([s for s, _ in copies])
            dst = self._to_device([d for _, d in copies])
            with torch.inference_mode():
                _copy_blocks(self._pools, src, dst)
            if metrics.on():
                _serving_metrics().cow.inc(len(copies))

        self._agree("decode batch", lambda: (
            copies, None if arrays is None else
            [a.tobytes() for a in arrays]))
        if arrays is not None:
            t_dec = time.monotonic()
            tokens, lens, tables, temps = arrays
            all_greedy = bool((temps <= 0.0).all())
            if self._graphs is not None:
                with named_scope("decode_step"):
                    out_host = self._graphs[all_greedy].replay(
                        tokens, lens, tables, temps).cpu().numpy()
            else:
                with torch.inference_mode(), named_scope("decode_step"), \
                        decode_path_context(self._path.path):
                    out_host = _paged_step(
                        self._model, self._pools,
                        self._to_device(tokens, torch.int64),
                        self._to_device(lens), self._to_device(tables),
                        self._to_device(temps, torch.float32),
                        all_greedy, self._generator).cpu().numpy()
            with self._cond:
                for req in batch:
                    if req.state == RUNNING and req.slot is not None:
                        self._append_token(req, int(out_host[req.slot]))
                self._steps += 1
            if metrics.on():
                _serving_metrics().steps.inc()
            if tracer is not None:
                tracer.span("decode", t_dec, time.monotonic(),
                            batch=len(batch))
        self._update_gauges()
        with self._cond:
            return self._sched.has_work()

    def run_until_idle(self, max_steps: int = 100000) -> None:
        """Drive the engine synchronously until no request is waiting or
        running (tests, benches: fully deterministic scheduling)."""
        for _ in range(max_steps):
            if not self.step():
                return
        raise RuntimeError(f"engine still busy after {max_steps} steps")

    def start(self) -> "ServingEngine":
        """Spawn the background loop (daemon thread). Idempotent.
        Refused for a tensor-parallel model, whose engines must be
        driven in lockstep (module doc)."""
        if self._tp is not None:
            raise RuntimeError(
                "a tensor-parallel engine runs in lockstep with the other "
                "ranks of its axis: give every rank the same submissions "
                "and drive each with step() / run_until_idle()")
        with self._cond:
            if self._closed:
                raise RuntimeError("engine is shut down")
            if self._thread is not None:
                return self
            self._stop = False
            self._thread = threading.Thread(
                target=self._run_loop, name="hvd-serving-engine",
                daemon=True)
            self._thread.start()
        return self

    def shutdown(self, timeout: float = 10.0) -> None:
        """Stop the loop, fail whatever is still queued or running, and
        close the trace file. Idempotent."""
        with self._cond:
            self._stop = True
            self._closed = True
            thread = self._thread
            self._thread = None
            self._cond.notify_all()
        if thread is not None:
            thread.join(timeout)
        with self._cond:
            self._fail_all_locked("engine shut down")
        if self._tracer is not None:
            self._tracer.close()

    def stats(self) -> Dict[str, float]:
        """Serving stats snapshot — ``zero_stats()`` shape, every key
        always present."""
        with self._cond:
            s = zero_stats()
            pool = self._sched.pool
            s.update({
                "queue_depth": self._sched.queue_depth_now(),
                "queue_limit": self._sched.queue_depth,
                "active_sequences": len(self._sched.running),
                "blocks_total": pool.num_blocks,
                "blocks_in_use": pool.blocks_in_use,
                "blocks_peak": pool.peak_in_use,
                "block_utilization": round(pool.utilization(), 4),
                "requests_submitted": self._submitted,
                "requests_finished": self._finished,
                "requests_rejected": self._sched.rejected,
                "requests_cancelled": self._cancelled,
                "preemptions": self._sched.preempted,
                "tokens_generated": self._tokens_generated,
                "steps": self._steps,
                "ttft_p50_seconds": _quantile(self._ttfts, 0.5),
                "ttft_p99_seconds": _quantile(self._ttfts, 0.99),
                "tpot_p50_seconds": _quantile(self._tpots, 0.5),
                "tpot_p99_seconds": _quantile(self._tpots, 0.99),
                "blocks_shared": pool.blocks_shared,
                "cow_copies": self._sched.cow_copies,
                "blocks_live": self._live_blocks(),
                "blocks_live_peak": self._live_peak,
            })
            if self._prefix is not None:
                s.update(self._prefix.stats())
            return s

    # -- internals ----------------------------------------------------------

    def _agree(self, what: str, plan) -> None:
        """Under tensor parallelism, check that every rank of the axis
        took the same decision ``plan()`` (a digest gathered over the
        axis); raise, naming the step's phase, if they differ."""
        if self._tp is None:
            return
        digest = int.from_bytes(hashlib.blake2b(
            repr(plan()).encode(), digest_size=8).digest(), "little",
            signed=True)
        mine = torch.tensor([digest], dtype=torch.int64,
                            device=self._device)
        parts = [torch.empty_like(mine) for _ in range(self._tp.size)]
        dist.all_gather(parts, mine, group=self._tp.group)
        if len({int(p) for p in parts}) != 1:
            raise RuntimeError(
                f"serving engine: the tensor-parallel ranks diverged at "
                f"the {what} (rank {self._tp.rank}); give every rank the "
                "same submissions in the same order")

    def _to_device(self, values, dtype=torch.int32):
        return torch.as_tensor(np.asarray(values), dtype=dtype).to(
            self._device)

    def _fail_all_locked(self, error: str) -> None:
        """Caller holds the lock: every queued or running request fails,
        and the prefix index drops its block references."""
        for req in list(self._sched.waiting) + list(
                self._sched.running.values()):
            if req.state not in TERMINAL_STATES:
                self._sched.cancel_waiting(req)
                self._sched.retire(req, FAILED, error)
                _count_outcome(FAILED)
        self._sched.waiting.clear()
        if self._prefix is not None:
            self._prefix.clear()
        self._cond.notify_all()

    def _run_loop(self) -> None:
        while True:
            with self._cond:
                while not self._stop and not self._sched.has_work():
                    self._cond.wait(0.05)
                if self._stop:
                    return
            try:
                self.step()
            except Exception as exc:  # the loop must fail LOUDLY
                logging.error("serving engine loop died: %s", exc)
                with self._cond:
                    # Dead, not idle: later submit() raises instead of
                    # queueing requests no loop will process.
                    self._closed = True
                    self._stop = True
                    self._thread = None
                    self._fail_all_locked(str(exc))
                return

    def _cancel(self, req: Request) -> None:
        with self._cond:
            if req.state in TERMINAL_STATES:
                return
            if req.state == WAITING:
                self._sched.cancel_waiting(req)
                self._cancelled += 1
                _count_outcome(CANCELLED)
            else:
                req.cancel_requested = True
            self._cond.notify_all()
        self._update_gauges()

    def _prefill(self, req: Request) -> None:
        t0 = time.monotonic()
        prompt = req.current_prompt()
        plen = int(prompt.shape[0])
        nb = self._sched.pool.blocks_for(plen)
        window = nb * self._config.block_size
        warm = min(req.warm_pages, max(0, nb - 1))
        # Pad to the page boundary (see _paged_prefill).
        padded = np.zeros((1, window), np.int64)
        padded[0, :plen] = prompt
        with torch.inference_mode(), named_scope("prefill"), \
                decode_path_context(self._path.path):
            if warm:
                # Prefix-cache hit: the warm pages' KV already sits in
                # the pool — only the cold tail runs through the model.
                warm_len = warm * self._config.block_size
                token = _paged_warm_prefill(
                    self._model, self._pools,
                    self._to_device(padded[:, warm_len:], torch.int64),
                    plen, self._to_device(req.blocks[:warm]),
                    self._to_device(req.blocks[warm:nb]), warm, nb,
                    req.temperature, self._generator)
            else:
                token = _paged_prefill(
                    self._model, self._pools,
                    self._to_device(padded, torch.int64), plen,
                    self._to_device(req.blocks[:nb]), req.temperature,
                    self._generator)
        with self._cond:
            if req.state == RUNNING:       # not cancelled mid-prefill
                self._register_prefix(req, plen)
                self._append_token(req, token)
        tracer = self._maybe_tracer()
        if tracer is not None:
            tracer.span("prefill", t0, time.monotonic(), rid=req.rid,
                        len=plen, warm_pages=warm,
                        recompute=req.preemptions)

    def _register_prefix(self, req: Request, plen: int) -> None:
        """Caller holds the lock, right after a successful prefill:
        every whole page of the (re-)prefilled prompt enters the prefix
        index keyed by its chained digest (warm pages merely refresh
        their LRU position)."""
        if self._prefix is None:
            return
        for i in range(min(plen // self._config.block_size,
                           len(req.page_hashes))):
            self._prefix.insert(req.page_hashes[i], req.blocks[i])

    def _append_token(self, req: Request, token: int) -> None:
        """Caller holds the lock."""
        now = time.monotonic()
        on = metrics.on()
        req.tokens.append(token)
        self._tokens_generated += 1
        if on:
            _serving_metrics().tokens.inc()
        if req.first_token_t is None:
            req.first_token_t = now
            ttft = now - req.submit_t
            self._ttfts.append(ttft)
            if on:
                _serving_metrics().ttft.observe(ttft)
        elif req.last_token_t is not None:
            tpot = now - req.last_token_t
            self._tpots.append(tpot)
            if on:
                _serving_metrics().tpot.observe(tpot)
        req.last_token_t = now
        if req.is_done():
            self._sched.retire(req, FINISHED)
            self._finished += 1
            _count_outcome(FINISHED)
        self._cond.notify_all()

    def _build_batch(self, batch: List[Request]):
        """Caller holds the lock. Slot arrays for one decode step."""
        size = self._config.max_batch
        tokens = np.zeros((size,), np.int64)
        lens = np.zeros((size,), np.int32)
        tables = np.zeros((size, self._table_slots), np.int32)
        temps = np.zeros((size,), np.float32)
        for req in batch:
            slot = req.slot
            tokens[slot] = req.tokens[-1]
            lens[slot] = req.position_of_last_token()
            tables[slot] = padded_table(req.blocks, self._table_slots)
            temps[slot] = req.temperature
        return tokens, lens, tables, temps

    def _live_blocks(self) -> int:
        """Caller holds the lock. Blocks live sequences actually pin:
        in-use minus pages only the prefix index holds."""
        cache_only = (self._prefix.cache_only_blocks()
                      if self._prefix is not None else 0)
        return self._sched.pool.blocks_in_use - cache_only

    def _note_live_blocks(self) -> None:
        """Caller holds the lock; called right after each allocation
        site so ``blocks_live_peak`` is the true high-water mark."""
        live = self._live_blocks()
        if live > self._live_peak:
            self._live_peak = live

    def _update_gauges(self) -> None:
        """Refresh this engine's gauge snapshot, publish the prefix
        cache's counters as deltas since the last sweep, and publish the
        process-wide gauge sums."""
        if not metrics.on():
            return
        m = _serving_metrics()
        with self._cond:
            pool = self._sched.pool
            self._gauge_snapshot = {
                "queue_depth": self._sched.queue_depth_now(),
                "queue_limit": self._sched.queue_depth,
                "active": len(self._sched.running),
                "blocks_in_use": pool.blocks_in_use,
                "blocks_total": pool.num_blocks,
                "blocks_shared": pool.blocks_shared,
                "prefix_cached": (self._prefix.cached_blocks
                                  if self._prefix is not None else 0),
            }
            if self._prefix is not None:
                for attr, counter in (("hits", m.prefix_hits),
                                      ("misses", m.prefix_misses),
                                      ("evictions", m.prefix_evictions)):
                    total = getattr(self._prefix, attr)
                    seen = self._prefix_published.get(attr, 0)
                    if total > seen:
                        counter.inc(total - seen)
                        self._prefix_published[attr] = total
        _publish_gauge_totals(m)

    def _maybe_tracer(self) -> Optional[TraceWriter]:
        """The engine's span writer under ``HOROVOD_TRACE_DIR`` (opened
        at first use), or None."""
        if not self._trace_checked:
            self._trace_checked = True
            tdir = hvd_config.trace_dir()
            if tdir:
                os.makedirs(tdir, exist_ok=True)
                rank = hvd_config.env_rank() or 0
                self._tracer = TraceWriter(
                    os.path.join(tdir,
                                 SERVING_TRACE_FILE_FMT.format(rank=rank)),
                    rank)
        return self._tracer


def _publish_gauge_totals(m) -> None:
    """Process-wide gauges = the sum over LIVE engines' latest snapshots
    (read lock-free: each snapshot dict is swapped whole). A closed
    engine drops out of the sum, so a replica kill shows in the
    gauges."""
    totals: Dict[str, float] = {}
    for engine in list(_LIVE_ENGINES):
        if engine._closed:
            continue
        for key, value in engine._gauge_snapshot.items():
            totals[key] = totals.get(key, 0) + value
    m.queue_depth.set(totals.get("queue_depth", 0))
    m.queue_limit.set(totals.get("queue_limit", 0))
    m.active.set(totals.get("active", 0))
    m.blocks_in_use.set(totals.get("blocks_in_use", 0))
    m.blocks_total.set(totals.get("blocks_total", 0))
    m.block_util.set(
        totals.get("blocks_in_use", 0) / totals["blocks_total"]
        if totals.get("blocks_total") else 0.0)
    m.blocks_shared.set(totals.get("blocks_shared", 0))
    m.prefix_cached.set(totals.get("prefix_cached", 0))


def _pctl(sorted_vals: List[float], q: float) -> Optional[float]:
    """Exact-list percentile (the JAX package's straggler-report
    convention: one definition of 'p99' across the repo)."""
    if not sorted_vals:
        return None
    idx = max(0, min(len(sorted_vals) - 1,
                     int(math.ceil(q * len(sorted_vals))) - 1))
    return sorted_vals[idx]


def _quantile(values, q: float) -> float:
    est = _pctl(sorted(values), q)
    return round(est, 6) if est is not None else 0.0
