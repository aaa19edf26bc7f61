"""Paged KV-cache block accounting for the serving tier — the port's
own copy of ``horovod_tpu/serving/kv_blocks.py``.

The physical cache is ONE pool of fixed-size blocks per layer
(``(num_blocks, block_size, Hkv*head_dim)`` device tensors owned by the
engine); this module owns the *bookkeeping*: which blocks are free,
which sequence holds which blocks, and the capacity numbers the
scheduler's admission/preemption decisions and the engine's stats read.
Keeping the accounting in plain Python (no torch) makes every invariant
unit-testable without a device.

Why paged at all: the contiguous decode cache allocates every sequence
its max-length window up front, so a batch of mixed-length requests
fragments device memory with slack nobody attends over. Fixed-size
blocks share one pool — a sequence holds exactly
``ceil(len / block_size)`` blocks, frees them on exit, and the freed
blocks are immediately reusable by any other sequence (the Orca/vLLM
design, on the row-flat GQA cache and the paged decode kernel — see
``ops.decode_attention.paged_decode_attention``).

Block id 0 is the reserved **null block**: never allocated. Block
tables pad with it (slots past a sequence's last block), and inactive
decode slots point every table entry at it, so their one-row decode
writes land there instead of corrupting live pages. Its CONTENT is
therefore garbage by design — every read of it sits above some
sequence's causal bound and is masked to an exact zero contribution.

Blocks are **ref-counted**: prefix caching maps a warm
prompt's pages onto blocks another sequence (or the prefix index
itself) already holds, so one physical page can back several logical
sequences. ``alloc`` hands a block out at refcount 1, ``share`` takes
one more reference, and ``free`` *releases one reference* — the block
returns to the free list only when the count hits zero. Over-release
(freeing a block nobody holds) and under-release (the loud invariants
below) stay bookkeeping bugs: a silently double-freed block would be
handed to two sequences and corrupt both.

The pool is NOT thread-safe by itself: the engine serializes access
under its scheduler lock (one mutator — the engine loop — plus
submit-time capacity checks).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

#: Reserved all-zero block every table pads with; never handed out.
NULL_BLOCK = 0


class OutOfBlocks(RuntimeError):
    """The pool has no free block. The scheduler's cue to preempt
    (preemption-by-recompute), never a user-facing
    error."""


class BlockPool:
    """Free-list allocator over ``num_blocks`` physical block ids.

    ``num_blocks`` counts usable blocks; the null block is extra, so
    the physical arrays hold ``num_blocks + 1`` blocks and valid ids
    are ``1..num_blocks``. Allocation order is deterministic (lowest
    free id first, frees reused LIFO-then-sorted is NOT guaranteed —
    only determinism for a fixed call sequence is), which keeps every
    scheduling trace reproducible for the seeded bench."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1:
            raise ValueError(f"need at least one block ({num_blocks})")
        if block_size < 1:
            raise ValueError(f"block_size must be positive ({block_size})")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        # Stack of free ids; pop() hands out ascending ids from a fresh
        # pool, and freed blocks are reused most-recently-freed first
        # (their rows are the likeliest still warm in the L2 cache).
        self._free: List[int] = list(range(self.num_blocks, 0, -1))
        self._refs: Dict[int, int] = {}
        self._peak = 0
        self._allocs = 0
        self._frees = 0
        self._shares = 0

    # -- capacity arithmetic ------------------------------------------------

    def blocks_for(self, length: int) -> int:
        """Blocks covering ``length`` token positions."""
        return max(0, (int(length) + self.block_size - 1) // self.block_size)

    def can_fit(self, blocks: int) -> bool:
        return blocks <= len(self._free)

    # -- alloc/free ---------------------------------------------------------

    def alloc(self) -> int:
        if not self._free:
            raise OutOfBlocks(
                f"all {self.num_blocks} KV blocks are in use")
        block = self._free.pop()
        self._refs[block] = 1
        self._allocs += 1
        if len(self._refs) > self._peak:
            self._peak = len(self._refs)
        return block

    def alloc_many(self, n: int) -> List[int]:
        """All-or-nothing allocation of ``n`` blocks (admission must not
        half-admit a sequence and deadlock the pool)."""
        if not self.can_fit(n):
            raise OutOfBlocks(
                f"need {n} blocks, {len(self._free)} free "
                f"of {self.num_blocks}")
        return [self.alloc() for _ in range(n)]

    # -- sharing ------------------------------------------------------------

    def share(self, block: int) -> int:
        """Take one more reference on an already-held block (prefix-cache
        warm mapping: a new sequence's page lands on an existing block
        copy-free). Sharing the null block or a block nobody holds is a
        bookkeeping bug — warm mappings must come from live index
        entries, never stale ids."""
        block = int(block)
        if block == NULL_BLOCK:
            raise ValueError("the null block is never allocated")
        if block not in self._refs:
            raise ValueError(
                f"block {block} is not allocated — cannot share a block "
                "nobody holds (stale prefix-index entry?)")
        self._refs[block] += 1
        self._shares += 1
        return block

    def refcount(self, block: int) -> int:
        """Live reference count for ``block`` (0 = free)."""
        return self._refs.get(int(block), 0)

    def is_shared(self, block: int) -> bool:
        """More than one holder: a write into this block needs
        copy-on-write first (the sharing parity contract)."""
        return self._refs.get(int(block), 0) > 1

    def free(self, blocks: Sequence[int]) -> None:
        """Release one reference per listed block; a block returns to
        the pool only when its count hits zero (a donor freeing a shared
        page leaves the data live for the other holders). Freeing the
        null block, an unallocated id, or more times than it was
        alloc'd/shared is a bookkeeping bug — loud, because a silently
        over-released block would be handed to two sequences and corrupt
        both."""
        for block in blocks:
            block = int(block)
            if block == NULL_BLOCK:
                raise ValueError("the null block is never allocated")
            refs = self._refs.get(block, 0)
            if refs <= 0:
                raise ValueError(
                    f"block {block} is not allocated (double free?)")
            if refs == 1:
                del self._refs[block]
                self._free.append(block)
            else:
                self._refs[block] = refs - 1
            self._frees += 1

    # -- views --------------------------------------------------------------

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        return len(self._refs)

    @property
    def blocks_shared(self) -> int:
        """Blocks with more than one live reference right now."""
        return sum(1 for refs in self._refs.values() if refs > 1)

    @property
    def peak_in_use(self) -> int:
        return self._peak

    def utilization(self) -> float:
        return len(self._refs) / self.num_blocks if self.num_blocks else 0.0

    def stats(self) -> Dict[str, float]:
        """Accounting snapshot (JSON-clean) for ``engine.stats()`` and
        the block gauges."""
        return {
            "blocks_total": self.num_blocks,
            "blocks_in_use": self.blocks_in_use,
            "blocks_free": self.free_blocks,
            "blocks_peak": self.peak_in_use,
            "block_utilization": round(self.utilization(), 4),
            "blocks_shared": self.blocks_shared,
            "block_allocs": self._allocs,
            "block_frees": self._frees,
            "block_shares": self._shares,
        }


def padded_table(blocks: Sequence[int], slots: int) -> List[int]:
    """A sequence's block list padded to the static table width with the
    null block (the kernel's index_map needs a rectangular table)."""
    if len(blocks) > slots:
        raise ValueError(
            f"sequence holds {len(blocks)} blocks but the table has "
            f"{slots} slots — max_seq_len accounting is broken")
    return list(blocks) + [NULL_BLOCK] * (slots - len(blocks))
