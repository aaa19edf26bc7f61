"""Serving for the port: continuous batching + paged KV cache over the
hand-written paged decode kernel, and the fleet router over N engine
replicas — the counterpart of ``horovod_tpu/serving``.

Quick start::

    from horovod_tpu_torch import serving
    from horovod_tpu_torch.models.llama import LLAMA_300M, LlamaLM

    engine = serving.serve(LlamaLM(LLAMA_300M))       # starts the loop
    handle = engine.submit(prompt_ids, max_new_tokens=128)
    for token in handle.stream():
        ...
    serving.stats()     # well-formed zeros before the first engine

Fleet::

    router = serving.fleet(LlamaLM(LLAMA_300M), replicas=3)
    handle = router.submit(prompt_ids, max_new_tokens=128)
    handle.result()     # survives a replica dying mid-request
    router.health()     # per-replica liveness + load

The engine and the fleet take the port's ``LlamaLM`` (it owns its
weights and device), so the JAX package's ``variables`` argument has no
counterpart here.
"""

from __future__ import annotations

from typing import Optional

from .engine import RequestHandle, ServingEngine
from .kv_blocks import NULL_BLOCK, BlockPool, OutOfBlocks
from .prefix_cache import PrefixCache, page_hashes
from .router import FleetHandle, Router, RouterConfig
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
    "Router", "RouterConfig", "FleetHandle", "serve", "fleet",
    "default_engine", "default_router", "stats", "zero_stats",
]

_default_engine: Optional[ServingEngine] = None
_default_router: Optional[Router] = None


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


def fleet(model, replicas: Optional[int] = None,
          config: Optional[ServingConfig] = None,
          router_config: Optional[RouterConfig] = None,
          seed: int = 0, start: bool = True) -> Router:
    """Create ``replicas`` :class:`ServingEngine` replicas over ``model``
    (default ``HOROVOD_ROUTER_REPLICAS``) behind one :class:`Router`,
    register it as the module default (``stats()`` aggregates it), and
    start every replica loop (``start=False``: drive them by hand). The
    replicas share the one model, so its weights are held on the card
    once; each has its own KV pools. All share ``seed``: greedy decoding
    is then the same on every replica, which is what makes death-replay
    lossless."""
    global _default_router
    rcfg = (router_config if router_config is not None
            else RouterConfig.from_env())
    n = replicas if replicas is not None else rcfg.replicas
    if n < 1:
        raise ValueError(f"a fleet needs at least one replica ({n})")
    engines = [ServingEngine(model, config=config, seed=seed)
               for _ in range(n)]
    router = Router(engines, rcfg)
    _default_router = router
    if start:
        for engine in engines:
            engine.start()
    return router


def default_engine() -> Optional[ServingEngine]:
    """The engine ``serve()`` registered, or None."""
    return _default_engine


def default_router() -> Optional[Router]:
    """The router ``fleet()`` registered, or None."""
    return _default_router


def stats() -> dict:
    """The default fleet's aggregate stats (once ``fleet()`` ran), else
    the default engine's — or, before either exists, the same dict with
    every key present and zero."""
    if _default_router is not None:
        return _default_router.stats()
    if _default_engine is None:
        return zero_stats()
    return _default_engine.stats()
