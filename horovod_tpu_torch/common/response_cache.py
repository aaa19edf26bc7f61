"""Response cache: skip re-negotiating tensors seen before — the port's
copy of ``horovod_tpu/common/response_cache.py``.

Reference: ``horovod/common/response_cache.{h,cc}`` — an LRU of Responses
keyed by tensor name + parameters (dtype/shape/op/root), bit-indexed so that
per-cycle coordination is a single bitvector AND across ranks instead of
the full negotiation. A hit whose parameters changed invalidates the entry
(propagated with an OR pass).

Bitvectors are arbitrary-precision Python ints; the star control plane
ANDs/ORs them at the coordinator (``controller/controller.py``). Capacity
defaults to 1024; 0 disables caching. Bit assignment, the LRU touch, the
stale bit and eviction are the JAX package's.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Tuple

from .message import Request, RequestType, Response


def _params_of(req: Request) -> Tuple:
    return (req.request_type, req.tensor_dtype, req.tensor_shape, req.root_rank)


class ResponseCache:
    def __init__(self, capacity: int = 1024):
        self.capacity = capacity
        # name -> (bit position, params, response). Bit positions are stable
        # for an entry's lifetime (reference bit-indexed cache,
        # response_cache.h:43-92).
        self._entries: "OrderedDict[str, Tuple[int, Tuple, Response]]" = OrderedDict()
        self._free_bits: list[int] = list(range(capacity))
        self._by_bit: Dict[int, str] = {}

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, req: Request) -> Optional[int]:
        """Bit position on a parameter-exact hit; None on miss.

        Deliberately does NOT touch LRU order: cache state must evolve
        identically on every rank so bit positions stay coherent (the
        reference keeps coherence the same way — cache mutations happen only
        at points that occur in identical order on all ranks). Lookups happen
        in local-queue order, which may differ per rank; use ``touch`` at
        deterministic execution points instead."""
        entry = self._entries.get(req.tensor_name)
        if entry is None:
            return None
        bit, params, _ = entry
        if params != _params_of(req):
            return None
        return bit

    def touch(self, bit: int) -> None:
        """LRU-touch an entry. Only call at points ordered identically across
        ranks (bypass execution walks sorted agreed bits)."""
        name = self._by_bit.get(bit)
        if name is not None:
            self._entries.move_to_end(name)

    def stale_bit(self, req: Request) -> Optional[int]:
        """Bit of a same-name entry whose params no longer match (to be
        invalidated across ranks)."""
        entry = self._entries.get(req.tensor_name)
        if entry is None:
            return None
        bit, params, _ = entry
        return bit if params != _params_of(req) else None

    def get(self, bit: int) -> Tuple[str, Response]:
        name = self._by_bit[bit]
        _, _, response = self._entries[name]
        return name, response

    def request_of(self, bit: int) -> Optional[Request]:
        name = self._by_bit.get(bit)
        if name is None:
            return None
        _, params, _ = self._entries[name]
        rtype, dtype, shape, root = params
        return Request(request_rank=-1, request_type=rtype, tensor_name=name,
                       tensor_dtype=dtype, tensor_shape=shape, root_rank=root)

    def put(self, req: Request, response: Response) -> None:
        if self.capacity <= 0:
            return
        if req.tensor_name in self._entries:
            bit, _, _ = self._entries[req.tensor_name]
            self._entries[req.tensor_name] = (bit, _params_of(req), response)
            self._entries.move_to_end(req.tensor_name)
            return
        if not self._free_bits:
            # Evict LRU (reference evicts lowest-priority entry,
            # response_cache.cc put path).
            old_name, (old_bit, _, _) = next(iter(self._entries.items()))
            del self._entries[old_name]
            del self._by_bit[old_bit]
            self._free_bits.append(old_bit)
        bit = self._free_bits.pop(0)
        self._entries[req.tensor_name] = (bit, _params_of(req), response)
        self._by_bit[bit] = req.tensor_name

    def evict_bit(self, bit: int) -> None:
        name = self._by_bit.pop(bit, None)
        if name is not None:
            del self._entries[name]
            self._free_bits.append(bit)

    def evict_name(self, name: str) -> None:
        entry = self._entries.pop(name, None)
        if entry is not None:
            bit, _, _ = entry
            del self._by_bit[bit]
            self._free_bits.append(bit)

    def bits_to_mask(self, bits) -> int:
        mask = 0
        for b in bits:
            mask |= 1 << b
        return mask

    @staticmethod
    def mask_to_bits(mask: int) -> list[int]:
        bits = []
        i = 0
        while mask:
            if mask & 1:
                bits.append(i)
            mask >>= 1
            i += 1
        return bits
