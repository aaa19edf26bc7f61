"""Environment knobs the port reads — its own copy of the accessors in
``horovod_tpu/common/config.py`` that the serving and training slices
need (the port imports nothing of ``horovod_tpu``). Same variable names,
same parsing: unset/empty/garbage falls back to the default, one place
per knob. ``HOROVOD_RENDEZVOUS_FILE`` is the port's own: a FileStore
rendezvous for ``torch.distributed``."""

from __future__ import annotations

import os
from typing import Optional


def env_rank() -> Optional[int]:
    """``HOROVOD_RANK`` as Optional[int]; unset/empty/garbage -> None."""
    val = os.environ.get("HOROVOD_RANK")
    if val is None or not val.strip():
        return None
    try:
        return int(val)
    except ValueError:
        return None


def env_str(name: str, default: Optional[str] = None) -> Optional[str]:
    """Raw environment string, unset -> ``default``."""
    val = os.environ.get(name)
    return default if val is None else val


def log_level_name() -> str:
    """``HOROVOD_LOG_LEVEL`` lowercased, defaulting to "warning"."""
    return os.environ.get("HOROVOD_LOG_LEVEL", "warning").lower()


def serving_max_batch() -> int:
    """``HOROVOD_SERVING_MAX_BATCH``: decode-batch slots in the serving
    engine. Garbage/non-positive falls back to the default 8."""
    val = _env_int("HOROVOD_SERVING_MAX_BATCH", 8)
    return val if val > 0 else 8


def serving_block_size() -> int:
    """``HOROVOD_SERVING_BLOCK_SIZE``: KV-cache page size in token
    positions. Default 16."""
    val = _env_int("HOROVOD_SERVING_BLOCK_SIZE", 16)
    return val if val > 0 else 16


def serving_num_blocks() -> int:
    """``HOROVOD_SERVING_NUM_BLOCKS``: physical KV pool capacity in
    blocks (the null block is extra). 0 (default) = fully provisioned."""
    return max(0, _env_int("HOROVOD_SERVING_NUM_BLOCKS", 0))


def serving_queue_depth() -> int:
    """``HOROVOD_SERVING_QUEUE_DEPTH``: admission bound on WAITING
    requests; beyond it submissions are rejected loudly."""
    val = _env_int("HOROVOD_SERVING_QUEUE_DEPTH", 128)
    return val if val > 0 else 128


def serving_max_seq_len() -> int:
    """``HOROVOD_SERVING_MAX_SEQ_LEN``: per-sequence position budget
    (prompt + generated). 0 (default) = the model's own max_seq_len."""
    return max(0, _env_int("HOROVOD_SERVING_MAX_SEQ_LEN", 0))


def serving_prefix_cache() -> bool:
    """``HOROVOD_SERVING_PREFIX_CACHE``: copy-on-write prefix sharing on
    the paged KV pool. Default ON (tokens are identical on or off)."""
    return _env_bool("HOROVOD_SERVING_PREFIX_CACHE", True)


def serving_prefix_capacity() -> int:
    """``HOROVOD_SERVING_PREFIX_CAPACITY``: most blocks the prefix index
    may hold references to. 0 (default) = bounded by pool pressure."""
    return max(0, _env_int("HOROVOD_SERVING_PREFIX_CAPACITY", 0))


def _env_bool(name: str, default: bool = False) -> bool:
    val = os.environ.get(name)
    if val is None:
        return default
    return val.strip().lower() not in ("", "0", "false", "no", "off")


def _env_int(name: str, default: int) -> int:
    val = os.environ.get(name)
    if val is None or not val.strip():
        return default
    try:
        return int(val)
    except ValueError:
        return default


def controller_addr() -> Optional[str]:
    """``HOROVOD_CONTROLLER_ADDR``: ``host:port`` of the job's rendezvous
    (rank 0 listens there); None when unset. The port builds its
    ``torch.distributed`` process group on it."""
    return os.environ.get("HOROVOD_CONTROLLER_ADDR") or None


def rendezvous_file() -> Optional[str]:
    """``HOROVOD_RENDEZVOUS_FILE``: a shared file path for a
    ``torch.distributed.FileStore`` rendezvous instead of TCP (tests and
    single-host jobs that want no port); None when unset."""
    return os.environ.get("HOROVOD_RENDEZVOUS_FILE") or None
