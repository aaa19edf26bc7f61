"""Iteration-level request scheduling for the serving engine — the
port's own copy of ``horovod_tpu/serving/scheduler.py``.

The continuous-batching core (Orca's insight): scheduling decisions are
made **between decode steps**, never inside one. Each engine iteration
the scheduler (1) retires finished/cancelled sequences and frees their
blocks, (2) admits waiting requests into free decode slots while the
block pool can hold their prompts, and (3) tops up every running
sequence's block table for the next token — preempting the youngest
sequence (free its blocks, push it back to the FRONT of the queue)
when the pool runs dry. A preempted sequence resumes by **recompute**:
its prompt plus everything it already generated is re-prefilled on
readmission, which re-creates bit-equal KV rows — so preemption costs
work, never correctness.

Everything here is plain-Python bookkeeping over
:class:`~horovod_tpu_torch.serving.kv_blocks.BlockPool` — no torch, no
clocks beyond ``time.monotonic`` stamps — so admission, eviction, and
preemption policy are unit-testable without a device. The engine owns
the lock; every method below assumes the caller holds it.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from ..common import config as hvd_config
from .kv_blocks import BlockPool, OutOfBlocks
from .prefix_cache import PrefixCache

# Request lifecycle. WAITING -> RUNNING -> FINISHED is the happy path;
# RUNNING -> WAITING is preemption-by-recompute; CANCELLED/FAILED are
# terminal from either live state; REJECTED never enters the queue.
WAITING = "waiting"
RUNNING = "running"
FINISHED = "finished"
CANCELLED = "cancelled"
FAILED = "failed"
REJECTED = "rejected"

TERMINAL_STATES = (FINISHED, CANCELLED, FAILED, REJECTED)


class RejectedError(RuntimeError):
    """Admission control refused the request (queue at its bound, or the
    request could never fit the block pool). Callers shed load or retry
    elsewhere — the engine never queues without bound."""


class CancelledError(RuntimeError):
    """The request was cancelled before it finished."""


@dataclasses.dataclass
class ServingConfig:
    """Engine knobs. ``from_env`` reads the ``HOROVOD_SERVING_*``
    variables through the ``common/config.py`` accessors; explicit
    constructor arguments (tests, benches) override the environment."""

    max_batch: int = 8          # decode slots per step
    block_size: int = 16        # KV page size, token positions
    num_blocks: int = 0         # pool capacity; 0 = fully provisioned
    queue_depth: int = 128      # admission bound on WAITING requests
    max_seq_len: int = 0        # position budget; 0 = model's max
    prefix_cache: bool = True   # warm-prefix sharing
    prefix_capacity: int = 0    # cache-held block bound; 0 = pressure-only

    @staticmethod
    def from_env() -> "ServingConfig":
        return ServingConfig(
            max_batch=hvd_config.serving_max_batch(),
            block_size=hvd_config.serving_block_size(),
            num_blocks=hvd_config.serving_num_blocks(),
            queue_depth=hvd_config.serving_queue_depth(),
            max_seq_len=hvd_config.serving_max_seq_len(),
            prefix_cache=hvd_config.serving_prefix_cache(),
            prefix_capacity=hvd_config.serving_prefix_capacity(),
        )


@dataclasses.dataclass
class Request:
    """One in-flight generation request and its full accounting."""

    rid: int
    prompt: np.ndarray                  # (S,) int32, the ORIGINAL prompt
    max_new_tokens: int
    temperature: float = 0.0
    state: str = WAITING
    tokens: List[int] = dataclasses.field(default_factory=list)
    blocks: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    # Prefix sharing (set by admit()): how many leading whole pages of
    # current_prompt() were mapped onto existing blocks copy-free, and
    # the chained digests of ALL its whole pages (the engine's insert
    # keys once the prefill writes the cold ones).
    warm_pages: int = 0
    page_hashes: List[bytes] = dataclasses.field(default_factory=list)
    preemptions: int = 0
    cancel_requested: bool = False
    error: Optional[str] = None
    # time.monotonic() stamps (durations only — never wall anchors).
    submit_t: float = 0.0
    first_token_t: Optional[float] = None
    last_token_t: Optional[float] = None
    finish_t: Optional[float] = None

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def generated(self) -> int:
        return len(self.tokens)

    def current_prompt(self) -> np.ndarray:
        """What a (re-)prefill must process: the original prompt plus
        every already-generated token (preemption-by-recompute replays
        the generated suffix to rebuild its KV rows)."""
        if not self.tokens:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.tokens, self.prompt.dtype)])

    def position_of_last_token(self) -> int:
        """Global position of the newest generated token — the decode
        step's per-sequence ``cache_index`` (the token's KV row is
        written there; attention spans positions <= it). Generated token
        j (1-based) sits at position ``prompt_len + j - 1`` whether it
        was produced by decode or replayed by a recompute prefill."""
        return self.prompt_len + self.generated - 1

    def total_len(self) -> int:
        return self.prompt_len + self.generated

    def is_done(self) -> bool:
        return self.generated >= self.max_new_tokens


def zero_stats() -> Dict[str, float]:
    """The serving stats dict with every key present and zero — what
    ``serving.stats()`` returns before any engine exists (the
    ``controller_health()`` zero-state convention: downstream consumers
    index and chart without None-guards)."""
    return {
        "queue_depth": 0,
        "queue_limit": 0,
        "active_sequences": 0,
        "blocks_total": 0,
        "blocks_in_use": 0,
        "blocks_peak": 0,
        "block_utilization": 0.0,
        "requests_submitted": 0,
        "requests_finished": 0,
        "requests_rejected": 0,
        "requests_cancelled": 0,
        "preemptions": 0,
        "tokens_generated": 0,
        "steps": 0,
        "ttft_p50_seconds": 0.0,
        "ttft_p99_seconds": 0.0,
        "tpot_p50_seconds": 0.0,
        "tpot_p99_seconds": 0.0,
        # Prefix sharing (zeros when the cache is disabled).
        # blocks_live excludes pages only the prefix index holds —
        # reclaimable on demand, so they are warm spare capacity, not
        # footprint; blocks_live_peak is ITS high-water mark (sampled at
        # step boundaries, where all allocation happens).
        "blocks_live": 0,
        "blocks_live_peak": 0,
        "blocks_shared": 0,
        "cow_copies": 0,
        "prefix_hits": 0,
        "prefix_misses": 0,
        "prefix_hit_rate": 0.0,
        "prefix_cached_blocks": 0,
        "prefix_inserts": 0,
        "prefix_evictions": 0,
        # Fleet router: zeros, kept so the catalog matches the JAX
        # package's (the port has no router yet).
        "router_replicas": 0,
        "router_requests": 0,
        "router_reroutes": 0,
        "router_replica_departures": 0,
    }


class Scheduler:
    """Admission queue + decode-slot/block-table bookkeeping.

    Owns the WAITING deque (bounded by ``queue_depth``), the slot map,
    and the :class:`BlockPool`. The engine calls, between decode steps::

        retire(...)            # free finished/cancelled sequences
        admitted = admit()     # new sequences to prefill, in FIFO order
        preempted = ensure_decode_capacity()

    and builds its decode batch from ``running`` afterwards.
    """

    def __init__(self, pool: BlockPool, max_batch: int, queue_depth: int,
                 max_seq_len: int,
                 prefix_cache: Optional[PrefixCache] = None):
        self.pool = pool
        self.max_batch = int(max_batch)
        self.queue_depth = int(queue_depth)
        self.max_seq_len = int(max_seq_len)
        self.prefix_cache = prefix_cache
        self.waiting: Deque[Request] = deque()
        self.running: Dict[int, Request] = {}      # slot -> Request
        self._free_slots: List[int] = list(range(self.max_batch - 1, -1, -1))
        self.rejected = 0
        self.preempted = 0
        self.cow_copies = 0
        # (src, dst) block copies the engine must perform on-device
        # BEFORE the next decode step (copy-on-write: a sequence about to
        # write into a shared page got a private block instead).
        self.pending_copies: List[Tuple[int, int]] = []

    # -- admission ----------------------------------------------------------

    def check_admissible(self, prompt_len: int, max_new_tokens: int) -> None:
        """Reject-before-queue checks: a request whose full window can
        never fit (position budget or whole pool) would deadlock the
        queue behind it — refuse it at the door, loudly."""
        total = prompt_len + max_new_tokens
        if prompt_len < 1 or max_new_tokens < 1:
            raise ValueError(
                f"need a non-empty prompt ({prompt_len}) and "
                f"max_new_tokens >= 1 ({max_new_tokens})")
        if total > self.max_seq_len:
            self.rejected += 1
            raise RejectedError(
                f"prompt ({prompt_len}) + max_new_tokens "
                f"({max_new_tokens}) exceeds the serving window "
                f"max_seq_len={self.max_seq_len}")
        if self.pool.blocks_for(total) > self.pool.num_blocks:
            self.rejected += 1
            raise RejectedError(
                f"request needs {self.pool.blocks_for(total)} KV blocks "
                f"at full length; the pool holds {self.pool.num_blocks} "
                "(raise HOROVOD_SERVING_NUM_BLOCKS)")
        if len(self.waiting) >= self.queue_depth:
            self.rejected += 1
            raise RejectedError(
                f"serving queue is full ({len(self.waiting)}/"
                f"{self.queue_depth} waiting); shed load or raise "
                "HOROVOD_SERVING_QUEUE_DEPTH")

    def enqueue(self, req: Request) -> None:
        """Append an admissible request (``check_admissible`` first)."""
        req.state = WAITING
        self.waiting.append(req)

    def requeue_front(self, req: Request) -> None:
        """A preempted sequence goes back to the FRONT: it has already
        consumed service, and FIFO fairness for the others is preserved
        by finishing it first once capacity returns."""
        req.state = WAITING
        self.waiting.appendleft(req)

    def admit(self) -> List[Request]:
        """Move waiting requests into free decode slots while the pool
        can hold their (re-)prefill blocks. FIFO — the head blocks the
        tail, which keeps TTFT honest (no starvation of long prompts).
        Admitted requests come back with blocks + slot assigned, ready
        for the engine's prefill.

        With a prefix cache, a request's leading whole pages that the
        index already holds are mapped onto the existing blocks
        **copy-free** (one shared reference each) — only the cold tail
        pages allocate, so a warm prompt admits at a fraction of its
        cold block cost and its prefill recomputes only the tail."""
        admitted: List[Request] = []
        while self.waiting and self._free_slots:
            req = self.waiting[0]
            need = self.pool.blocks_for(req.total_len())
            warm: List[int] = []
            hashes: List[bytes] = []
            if self.prefix_cache is not None:
                warm, hashes = self.prefix_cache.lookup(
                    req.current_prompt())
                for block in warm:
                    self.pool.share(block)
            if not self._ensure_free(need - len(warm)):
                if warm:
                    self.pool.free(warm)    # un-map; retry next step
                break
            self.waiting.popleft()
            req.blocks = list(warm) + self.pool.alloc_many(
                need - len(warm))
            req.warm_pages = len(warm)
            req.page_hashes = hashes
            if self.prefix_cache is not None:
                # Hit accounting on ADMISSION only — a request parked by
                # a full pool re-probes the index every step and would
                # otherwise inflate both counters.
                self.prefix_cache.hits += len(warm)
                self.prefix_cache.misses += len(hashes) - len(warm)
            req.slot = self._free_slots.pop()
            req.state = RUNNING
            self.running[req.slot] = req
            admitted.append(req)
        return admitted

    def _ensure_free(self, blocks: int) -> bool:
        """True once ``blocks`` are allocatable, releasing cold prefix-
        cache entries (cache-only references, LRU-first) to get there —
        warm pages nobody is using are the cheapest capacity on the
        machine, and evicting them beats preempting live work."""
        if self.pool.can_fit(blocks):
            return True
        if self.prefix_cache is not None:
            self.prefix_cache.release(blocks - self.pool.free_blocks)
        return self.pool.can_fit(blocks)

    # -- retirement ---------------------------------------------------------

    def _drop_pending_copies(self, req: Request) -> None:
        """A request leaving the batch must take its queued COW copies
        with it: its destination blocks return to the pool and could be
        re-handed out before the engine drains the copy list."""
        if self.pending_copies:
            mine = set(req.blocks)
            self.pending_copies = [
                (src, dst) for src, dst in self.pending_copies
                if dst not in mine]

    def retire(self, req: Request, state: str,
               error: Optional[str] = None) -> None:
        """Terminal transition: free blocks and slot, record state.
        ``free`` releases one reference per block — pages the prefix
        index (or another sequence) still holds stay live."""
        if req.blocks:
            self._drop_pending_copies(req)
            self.pool.free(req.blocks)
            req.blocks = []
        if req.slot is not None:
            self.running.pop(req.slot, None)
            self._free_slots.append(req.slot)
            req.slot = None
        req.state = state
        req.error = error
        if req.finish_t is None:
            req.finish_t = time.monotonic()

    def cancel_waiting(self, req: Request) -> None:
        """Remove a still-queued request (cancel before admission)."""
        try:
            self.waiting.remove(req)
        except ValueError:
            return
        req.state = CANCELLED

    # -- per-step capacity --------------------------------------------------

    def preempt(self, req: Request) -> None:
        """Preemption-by-recompute: drop the sequence's blocks and park
        it at the queue front; its generated tokens ride along and are
        replayed by the readmission prefill. Shared pages survive the
        free (the prefix index / other holders keep them), so a
        preempted warm request usually readmits warm again."""
        self._drop_pending_copies(req)
        self.pool.free(req.blocks)
        req.blocks = []
        if req.slot is not None:
            self.running.pop(req.slot, None)
            self._free_slots.append(req.slot)
            req.slot = None
        req.preemptions += 1
        self.preempted += 1
        self.requeue_front(req)

    def _grow_block(self, req: Request,
                    preempted: List[Request]) -> Optional[int]:
        """One block for ``req``, by whatever it takes: allocate,
        release cold prefix-cache entries, then preempt the YOUNGEST
        running sequence (most recently admitted — least sunk work to
        replay) and retry. Returns None when ``req`` itself became the
        victim."""
        while True:
            if not self.pool.free_blocks and self.prefix_cache is not None:
                self.prefix_cache.release(1)
            try:
                return self.pool.alloc()
            except OutOfBlocks:
                victim = max(self.running.values(), key=lambda r: r.rid)
                self.preempt(victim)
                preempted.append(victim)
                if victim is req:
                    return None

    def ensure_decode_capacity(self) -> List[Request]:
        """Before a decode step: every running sequence needs the block
        holding its next write position — and needs it PRIVATE. Allocate
        missing blocks oldest sequence first (cache relief before
        preemption, see :meth:`_grow_block`); then, if the write-target
        block is shared (another sequence or the prefix index holds it),
        schedule a **copy-on-write**: a fresh private block replaces it
        in this sequence's table, the page contents are queued on
        ``pending_copies`` for the engine to copy on-device before the
        step, and this sequence's reference on the shared original is
        released. Returns the preempted requests (already requeued). A
        lone running sequence can always grow: admission rejected
        anything whose full window exceeds the pool, and cache-only
        references always yield to a live sequence."""
        preempted: List[Request] = []
        survivors = sorted(self.running.values(), key=lambda r: r.rid)
        for req in survivors:
            if req.slot is None:
                continue                       # preempted this pass
            # The step writes the incoming token's KV row at position
            # total_len() - 1; the table must cover it.
            need = self.pool.blocks_for(req.total_len())
            while req.slot is not None and len(req.blocks) < need:
                block = self._grow_block(req, preempted)
                if block is not None:
                    req.blocks.append(block)
            if req.slot is None:
                continue
            widx = (req.total_len() - 1) // self.pool.block_size
            if self.pool.is_shared(req.blocks[widx]):
                fresh = self._grow_block(req, preempted)
                if fresh is None:
                    continue
                src = req.blocks[widx]
                req.blocks[widx] = fresh
                self.pending_copies.append((src, fresh))
                self.pool.free([src])          # our reference only
                self.cow_copies += 1
        return preempted

    # -- views --------------------------------------------------------------

    def active(self) -> List[Request]:
        """Running requests in slot order (the decode-batch layout)."""
        return [self.running[slot] for slot in sorted(self.running)]

    def queue_depth_now(self) -> int:
        return len(self.waiting)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)
