"""Prefix index over the paged KV pool: warm prompts admit copy-free —
the port's own copy of ``horovod_tpu/serving/prefix_cache.py``.

The dominant traffic shape at scale is K shared system prompts × unique
user tails. The block-table indirection already makes KV pages
position-independent *in storage* (``ops.decode_attention``), and a KV
row's *content* is fully determined by the token prefix up to it (causal
attention + absolute-position RoPE), so a whole page whose tokens —
and every token before them — match a page already in the pool holds
byte-identical KV. This module owns that mapping: a chained digest of
whole-page token prefixes → the physical block that already holds the
page's KV rows.

Keying is by **chained** hash (digest *i* commits to tokens
``0..(i+1)*block_size``), never by the page's own tokens alone: two
prompts sharing page *i*'s tokens but diverging earlier would collide
under a per-page key, and their KV rows genuinely differ (attention saw
different histories). The chain makes a hit a proof that the whole
prefix matches.

Reference discipline: the cache is a first-class holder — ``insert``
takes one :class:`~horovod_tpu_torch.serving.kv_blocks.BlockPool`
reference per entry, so a donor sequence finishing (or being preempted, or
evicted) does NOT return its shared pages to the pool; they stay warm
for the next request. Under pool pressure the scheduler calls
:meth:`PrefixCache.release`, which drops least-recently-used entries
whose block the cache is the *only* holder of — entries still backing a
live sequence are skipped (releasing them frees nothing). Plain Python,
no torch: every invariant is unit-testable without a device.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .kv_blocks import BlockPool


def page_hashes(tokens: Sequence[int], block_size: int) -> List[bytes]:
    """Chained digests for every WHOLE page of ``tokens``: digest ``i``
    commits to tokens ``0..(i+1)*block_size`` (16-byte blake2b over the
    previous digest plus the page's int32 bytes). A partial trailing
    page gets no digest — only full pages are ever shared."""
    arr = np.ascontiguousarray(np.asarray(tokens, np.int32).reshape(-1))
    out: List[bytes] = []
    prev = b""
    for i in range(arr.shape[0] // block_size):
        h = hashlib.blake2b(digest_size=16)
        h.update(prev)
        h.update(arr[i * block_size:(i + 1) * block_size].tobytes())
        prev = h.digest()
        out.append(prev)
    return out


class PrefixCache:
    """LRU index ``chained page digest -> physical block id``.

    ``capacity_blocks`` bounds how many blocks the cache may hold
    references to (0 = bounded only by pool pressure via
    :meth:`release`). The caller (scheduler/engine, under the engine
    lock) owns mutation ordering; the cache itself is not thread-safe.
    """

    def __init__(self, pool: BlockPool, capacity_blocks: int = 0):
        self.pool = pool
        self.block_size = pool.block_size
        self.capacity = max(0, int(capacity_blocks))
        # LRU: oldest entry first; move_to_end on every hit/refresh.
        self._index: "OrderedDict[bytes, int]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._index)

    @property
    def cached_blocks(self) -> int:
        return len(self._index)

    def cache_only_blocks(self) -> int:
        """Blocks whose ONLY holder is the index — reclaimable on
        demand, so they are warm spare capacity rather than live
        footprint (the ``blocks_live`` accounting subtracts them)."""
        return sum(1 for block in self._index.values()
                   if self.pool.refcount(block) == 1)

    # -- lookup -------------------------------------------------------------

    def lookup(self, tokens: Sequence[int]
               ) -> Tuple[List[int], List[bytes]]:
        """Longest warm run of whole-page prefixes for ``tokens``.

        Returns ``(warm_blocks, hashes)``: ``warm_blocks`` are the
        physical blocks backing pages ``0..len(warm_blocks)-1``
        (matching stops at the first cold page — a later isolated hit is
        useless, its KV assumes a different history), and ``hashes`` are
        the chained digests of ALL full pages (the insert keys after the
        prefill writes the cold ones).

        The warm run is capped at ``floor((len-1)/block_size)`` pages:
        the prefill must run at least one real token to produce the
        next-token logits, so a fully-page-aligned, fully-warm prompt
        recomputes exactly its last page.

        Hit/miss accounting is the CALLER's (the scheduler counts once
        per admission — a request parked by a full pool re-probes every
        step and must not inflate the rate)."""
        hashes = page_hashes(tokens, self.block_size)
        n = int(np.asarray(tokens).reshape(-1).shape[0])
        cap = max(0, n - 1) // self.block_size
        warm: List[int] = []
        for digest in hashes[:cap]:
            block = self._index.get(digest)
            if block is None:
                break
            self._index.move_to_end(digest)
            warm.append(block)
        return warm, hashes

    # -- insert / evict -----------------------------------------------------

    def insert(self, digest: bytes, block: int) -> bool:
        """Register ``digest -> block``, taking one pool reference. An
        already-present digest only refreshes its LRU position (the
        existing block keeps serving — re-registering under a different
        block would strand the old entry's reference). Returns whether a
        new entry was created."""
        if digest in self._index:
            self._index.move_to_end(digest)
            return False
        if self.capacity and len(self._index) >= self.capacity:
            # Make room from the cold end; a full cache of entries all
            # pinned by live sequences declines the insert instead of
            # growing past its bound.
            self.release(1, for_capacity=True)
            if len(self._index) >= self.capacity:
                return False
        self.pool.share(block)
        self._index[digest] = block
        self.inserts += 1
        return True

    def release(self, need_blocks: int, for_capacity: bool = False) -> int:
        """Drop least-recently-used entries until ``need_blocks`` blocks
        returned to the pool (pool pressure: the scheduler calls this
        before resorting to preemption). Entries whose block a live
        sequence still shares are skipped — dropping them frees nothing
        — unless ``for_capacity`` is set (capacity eviction counts index
        slots, not freed blocks). Returns how many entries were
        dropped."""
        dropped = 0
        if need_blocks <= 0:
            return 0
        for digest in list(self._index):
            if dropped >= need_blocks:
                break
            block = self._index[digest]
            if not for_capacity and self.pool.refcount(block) != 1:
                continue
            del self._index[digest]
            self.pool.free([block])
            self.evictions += 1
            dropped += 1
        return dropped

    def clear(self) -> None:
        """Release every cache-held reference (engine shutdown)."""
        while self._index:
            _, block = self._index.popitem(last=False)
            self.pool.free([block])
            self.evictions += 1

    # -- views --------------------------------------------------------------

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> Dict[str, float]:
        return {
            "prefix_hits": self.hits,
            "prefix_misses": self.misses,
            "prefix_hit_rate": round(self.hit_rate(), 4),
            "prefix_cached_blocks": self.cached_blocks,
            "prefix_inserts": self.inserts,
            "prefix_evictions": self.evictions,
        }
