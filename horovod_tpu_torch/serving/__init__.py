"""Serving for the port: continuous batching + paged KV cache over the
hand-written paged decode kernel — the counterpart of
``horovod_tpu/serving`` (the fleet ``Router`` waits for a later slice).

Quick start::

    from horovod_tpu_torch import serving
    from horovod_tpu_torch.models.llama import LLAMA_300M, LlamaLM

    engine = serving.serve(LlamaLM(LLAMA_300M))       # starts the loop
    handle = engine.submit(prompt_ids, max_new_tokens=128)
    for token in handle.stream():
        ...
    serving.stats()     # well-formed zeros before the first engine
"""

from __future__ import annotations

from typing import Optional

from .engine import RequestHandle, ServingEngine
from .kv_blocks import NULL_BLOCK, BlockPool, OutOfBlocks
from .prefix_cache import PrefixCache, page_hashes
from .scheduler import (
    CancelledError,
    RejectedError,
    Request,
    Scheduler,
    ServingConfig,
    zero_stats,
)

__all__ = [
    "BlockPool", "OutOfBlocks", "NULL_BLOCK", "PrefixCache",
    "page_hashes", "Request", "Scheduler", "ServingConfig",
    "RejectedError", "CancelledError", "ServingEngine", "RequestHandle",
    "serve", "default_engine", "stats", "zero_stats",
]

_default_engine: Optional[ServingEngine] = None


def serve(model, config: Optional[ServingConfig] = None, seed: int = 0,
          start: bool = True) -> ServingEngine:
    """Create a :class:`ServingEngine` over ``model`` (the port's
    ``LlamaLM``, on its own device), register it as the module default
    (``stats()`` reports it), and start its background loop (pass
    ``start=False`` to drive it synchronously)."""
    global _default_engine
    engine = ServingEngine(model, config=config, seed=seed)
    _default_engine = engine
    if start:
        engine.start()
    return engine


def default_engine() -> Optional[ServingEngine]:
    """The engine ``serve()`` registered, or None."""
    return _default_engine


def stats() -> dict:
    """The default engine's stats — or, before one exists, the same dict
    with every key present and zero."""
    if _default_engine is None:
        return zero_stats()
    return _default_engine.stats()
