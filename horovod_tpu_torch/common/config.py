"""Environment knobs the port reads — its own copy of the accessors in
``horovod_tpu/common/config.py`` that the serving, training and
controller slices need (the port imports nothing of ``horovod_tpu``).
Same variable names, same defaults, same parsing: unset/empty/garbage
falls back to the default, one place per knob. ``HOROVOD_RENDEZVOUS_FILE``
is the port's own: a FileStore rendezvous for ``torch.distributed``.
:class:`Config` is the snapshot of the knobs the eager-tier controller
reads, taken at ``init()``."""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

DEFAULT_FUSION_THRESHOLD_BYTES = 64 * 1024 * 1024
DEFAULT_CYCLE_TIME_MS = 5.0
DEFAULT_CACHE_CAPACITY = 1024
DEFAULT_STALL_CHECK_SECONDS = 60.0
DEFAULT_START_TIMEOUT_SECONDS = 120.0
# Liveness bound for the post-rendezvous control plane: a blocked recv that
# sees no frame (not even a heartbeat) for this long declares the peer dead.
DEFAULT_COMM_TIMEOUT_SECONDS = 120.0


def start_timeout_seconds(
        default: float = DEFAULT_START_TIMEOUT_SECONDS) -> float:
    """``HOROVOD_START_TIMEOUT`` (``horovodrun --start-timeout``): the
    rendezvous accept/connect window. Garbage and non-positive values fall
    back to ``default``."""
    try:
        val = float(os.environ.get("HOROVOD_START_TIMEOUT", ""))
    except (ValueError, OverflowError):
        return default
    return val if val > 0 else default


def comm_timeout_seconds() -> float:
    """``HOROVOD_COMM_TIMEOUT_SECONDS``: per-recv liveness deadline on the
    eager control plane. 0 (or negative) disables the deadline."""
    val = _env_float("HOROVOD_COMM_TIMEOUT_SECONDS",
                     DEFAULT_COMM_TIMEOUT_SECONDS)
    return val if val > 0 else 0.0


def heartbeat_interval_seconds() -> float:
    """``HOROVOD_HEARTBEAT_INTERVAL_SECONDS``: idle heartbeat frame period
    (0 disables). Defaults to a quarter of the comm timeout capped at 10 s;
    with the deadline disabled, heartbeats default off too."""
    timeout = comm_timeout_seconds()
    default = min(10.0, timeout / 4.0) if timeout else 0.0
    val = _env_float("HOROVOD_HEARTBEAT_INTERVAL_SECONDS", default)
    return val if val > 0 else 0.0


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


def router_replicas() -> int:
    """``HOROVOD_ROUTER_REPLICAS``: engine replicas ``serving.fleet``
    spins up when the caller does not pass an explicit count. Default 2
    (the smallest fleet where replica death is a reshape, not an
    outage)."""
    val = _env_int("HOROVOD_ROUTER_REPLICAS", 2)
    return val if val > 0 else 2


def router_affinity() -> bool:
    """``HOROVOD_ROUTER_AFFINITY``: prefix-affinity placement (requests
    whose first whole page matches a recently routed prefix follow it to
    that replica's warm cache). Default ON; off = pure least-loaded."""
    return _env_bool("HOROVOD_ROUTER_AFFINITY", True)


def router_retries() -> int:
    """``HOROVOD_ROUTER_RETRIES``: replays of one request on another
    replica after its serving replica died mid-flight. Default 2;
    negative clamps to 0."""
    return max(0, _env_int("HOROVOD_ROUTER_RETRIES", 2))


def metrics_enabled() -> bool:
    """The switch ``metrics.on()`` reads: ``HOROVOD_METRICS`` by the
    repo's boolean convention ("0"/"false"/"no"/"off"/"" are off), or a
    positive ``HOROVOD_METRICS_PORT``."""
    return (_env_bool("HOROVOD_METRICS")
            or _env_int("HOROVOD_METRICS_PORT", 0) > 0)


def trace_dir() -> Optional[str]:
    """``HOROVOD_TRACE_DIR``: where the serving engine writes its spans
    (``trace.serving.rank<N>.json``); None when unset or blank."""
    val = (os.environ.get("HOROVOD_TRACE_DIR") or "").strip()
    return val or None


def trace_max_events() -> int:
    """``HOROVOD_TRACE_MAX_EVENTS``: spans a trace file buffers before it
    drops (and counts) the rest. Default 2**20, at least 1024."""
    return max(1024, _env_int("HOROVOD_TRACE_MAX_EVENTS", 1 << 20))


def restart_epoch() -> int:
    """``HOROVOD_RESTART_EPOCH``: supervision attempt number, bumped by
    the launcher per relaunch. 0 on the first launch, outside the
    launcher, and for garbage values (a malformed relaunch env must look
    like a fresh start, not crash resume logic)."""
    try:
        return max(0, int(os.environ.get("HOROVOD_RESTART_EPOCH", "0")))
    except ValueError:
        return 0


def elastic_enabled() -> bool:
    """``HOROVOD_ELASTIC``: opt-in elastic membership. When set, a dead
    rank triggers a coordinator-led reshape (survivors re-form at a
    bumped membership epoch) instead of a job-wide abort, and late worker
    hellos are admitted at the next epoch boundary. The job then runs on
    the Python controller's TCP star and builds no ``torch.distributed``
    process group (a static world). Unset, behaviour is the static
    fault-tolerance contract."""
    return _env_bool("HOROVOD_ELASTIC")


def elastic_join() -> bool:
    """``HOROVOD_ELASTIC_JOIN``: this worker is a late joiner — it sends
    a JOIN hello to a live coordinator and waits for its (rank, size,
    epoch) assignment instead of taking part in the initial rendezvous.
    Exported by ``horovodrun --elastic`` when it respawns a dead worker
    slot."""
    return _env_bool("HOROVOD_ELASTIC_JOIN")


def elastic_min_ranks() -> int:
    """``HOROVOD_ELASTIC_MIN_RANKS``: smallest world size an elastic
    reshape may re-form (coordinator included). Below it the job aborts
    exactly like the non-elastic path. Default 1."""
    return max(1, _env_int("HOROVOD_ELASTIC_MIN_RANKS", 1))


def elastic_max_ranks() -> int:
    """``HOROVOD_ELASTIC_MAX_RANKS``: largest world size joiners may grow
    the job to; joiners beyond it stay parked until a slot frees. 0 (the
    default) means unbounded."""
    return max(0, _env_int("HOROVOD_ELASTIC_MAX_RANKS", 0))


def elastic_ckpt_dir() -> Optional[str]:
    """``HOROVOD_CKPT_DIR``: directory for the continuous async sharded
    checkpoints. When set, every ``elastic.State.commit()`` also hands
    this rank's shard of the committed tree to the background
    ``hvd-ckpt-writer`` thread. Unset (the default), commits stay
    in memory."""
    val = env_str("HOROVOD_CKPT_DIR")
    return val.strip() if val and val.strip() else None


def elastic_ckpt_keep() -> int:
    """``HOROVOD_CKPT_KEEP``: complete sharded-checkpoint steps the async
    writer keeps on disk. Minimum/default 2: the double buffer that
    leaves a complete previous step visible at any kill point."""
    return max(2, _env_int("HOROVOD_CKPT_KEEP", 2))


def elastic_restore_mode() -> str:
    """``HOROVOD_ELASTIC_RESTORE``: ``broadcast`` (rank 0 re-broadcasts
    the committed tree) or ``p2p`` (the default; digest-matched
    survivors keep their copies and only missing shards are fetched
    from peers). Garbage falls back to p2p."""
    val = (env_str("HOROVOD_ELASTIC_RESTORE") or "").strip().lower()
    return "broadcast" if val == "broadcast" else "p2p"


def fault_plan_raw() -> Optional[str]:
    """``HOROVOD_FAULT_PLAN``: inline JSON or ``@file`` reference for the
    deterministic fault-injection plan (``fault/plan.py``); None/blank
    disables."""
    val = os.environ.get("HOROVOD_FAULT_PLAN")
    if not val or not val.strip():
        return None
    return val


def init_retry_env() -> "tuple[int, float]":
    """(max attempts, base backoff seconds) for ``hvd.init``'s card
    acquisition and process-group join: ``HOROVOD_TPU_INIT_RETRIES``
    (default 3, at least 1) and ``HOROVOD_TPU_INIT_BACKOFF`` (default
    1.0 s), the JAX package's knobs."""
    attempts = max(1, _env_int("HOROVOD_TPU_INIT_RETRIES", 3))
    backoff = max(0.0, _env_float("HOROVOD_TPU_INIT_BACKOFF", 1.0))
    return attempts, backoff


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


def _env_float(name: str, default: float) -> float:
    val = os.environ.get(name)
    if val is None or not val.strip():
        return default
    try:
        return float(val)
    except ValueError:
        return default


def controller_addr() -> Optional[str]:
    """``HOROVOD_CONTROLLER_ADDR``: the coordinator's TCP star endpoint
    (``host:port``, rank 0 listens), exported by ``horovodrun`` in eager
    mode; None outside a launched eager job. ``init()`` starts the
    controller on it when the job has more than one rank."""
    return os.environ.get("HOROVOD_CONTROLLER_ADDR") or None


def spmd_coordinator() -> Optional[str]:
    """``HOROVOD_SPMD_COORDINATOR``: ``host:port`` of the device tier's
    rendezvous — the ``TCPStore`` the ``torch.distributed`` process group
    is built on (rank 0 listens); None when unset. ``horovodrun`` exports
    it in both modes, on a port of its own."""
    return os.environ.get("HOROVOD_SPMD_COORDINATOR") or None


def rendezvous_file() -> Optional[str]:
    """``HOROVOD_RENDEZVOUS_FILE``: a shared file path for a
    ``torch.distributed.FileStore`` rendezvous instead of TCP (tests and
    single-host jobs that want no port); None when unset."""
    return os.environ.get("HOROVOD_RENDEZVOUS_FILE") or None


def engine() -> Optional[str]:
    """``HOROVOD_ENGINE`` (native/python), None when the launcher left
    the choice to :func:`ring_data_plane_enabled`. Every rank derives the
    same answer from the same launcher-exported env."""
    return os.environ.get("HOROVOD_ENGINE") or None


def secret_key_hex() -> Optional[str]:
    """``HOROVOD_SECRET_KEY`` (hex), the per-job HMAC key minted by the
    launcher. None means the hermetic single-job default applies
    (``common/wire.job_secret``)."""
    return os.environ.get("HOROVOD_SECRET_KEY") or None


def ring_addrs() -> Optional[str]:
    """``HOROVOD_RING_ADDRS``: per-rank addresses for the native ring
    data plane (launcher-exported, identical on every rank)."""
    return os.environ.get("HOROVOD_RING_ADDRS") or None


def local_ring_addrs() -> Optional[str]:
    """``HOROVOD_LOCAL_RING_ADDRS``: the addresses of this rank's group
    ring (the hierarchical plane's intra-node hop)."""
    return os.environ.get("HOROVOD_LOCAL_RING_ADDRS") or None


def cross_ring_addrs() -> Optional[str]:
    """``HOROVOD_CROSS_RING_ADDRS``: the addresses of the local roots'
    ring (the hierarchical plane's inter-node hop)."""
    return os.environ.get("HOROVOD_CROSS_RING_ADDRS") or None


def cpu_ops() -> str:
    """``HOROVOD_CPU_OPS``: "star" forces the TCP star data plane under
    the Python controller; anything else (default "ring") allows the
    native rings."""
    return os.environ.get("HOROVOD_CPU_OPS", "ring")


def selected_engine() -> str:
    """The eager tier's engine, "native" or "python": ``HOROVOD_ENGINE``
    when set, else native whenever :func:`ring_data_plane_enabled`."""
    return engine() or ("native" if ring_data_plane_enabled() else "python")


def ring_data_plane_enabled() -> bool:
    """True when the launcher exported per-rank ring addresses and the
    operator did not force the star data plane. The one predicate for
    engine selection (``basics.init``) and the Python controller's ring
    construction: identical on every rank."""
    return bool(ring_addrs()) and cpu_ops() != "star"


# Wire dtypes the ring can put f32 allreduce payloads on the wire as;
# must match core.bindings.WIRE_DTYPE_CODES.
RING_WIRE_DTYPES = ("none", "bf16", "fp16", "int8")

# Default wire dtype per link class: fast intra-node/ICI links lose more
# to the casts than the saved bytes buy back; TCP/DCN-class links are
# where int8 with error feedback pays.
RING_WIRE_DTYPE_BY_LINK = {
    "local": "none",
    "ici": "none",
    "tcp": "int8",
    "dcn": "int8",
}

# Default transfer-chunk bytes per link class.
RING_CHUNK_BYTES_BY_LINK = {
    "local": 1 << 20,
    "tcp": 256 << 10,
    "dcn": 512 << 10,
    "ici": 2 << 20,
}


def ring_wire_dtype() -> str:
    """``HOROVOD_RING_WIRE_DTYPE``: on-the-wire representation of f32
    payloads in the flat ring's allreduce data phases (``bf16``/``fp16``
    halve the bytes, accumulation stays f32; ``int8`` quarters them with
    per-block scales and error feedback). Unset/garbage -> ``none``, the
    uncompressed stream."""
    val = (os.environ.get("HOROVOD_RING_WIRE_DTYPE") or "").strip().lower()
    return val if val in RING_WIRE_DTYPES else "none"


def _link_class_env(name: str) -> Optional[str]:
    val = (os.environ.get(name) or "").strip().lower()
    return val if val in RING_CHUNK_BYTES_BY_LINK else None


def _inferred_link_class(env_name: str, addrs: Optional[str]) -> str:
    val = _link_class_env(env_name)
    if val is not None:
        return val
    from ..run.nic_discovery import infer_link_class

    return infer_link_class(addrs)


def ring_link_class() -> str:
    """``HOROVOD_RING_LINK_CLASS`` (local/tcp/dcn/ici) of the flat ring;
    unset -> inferred from its addresses."""
    return _inferred_link_class("HOROVOD_RING_LINK_CLASS", ring_addrs())


def local_ring_link_class() -> str:
    """``HOROVOD_LOCAL_RING_LINK_CLASS`` of the hierarchical plane's
    intra-node ring; unset -> inferred from its addresses."""
    return _inferred_link_class("HOROVOD_LOCAL_RING_LINK_CLASS",
                                local_ring_addrs())


def cross_ring_link_class() -> str:
    """``HOROVOD_CROSS_RING_LINK_CLASS`` of the local roots' ring; unset
    -> inferred from its addresses."""
    return _inferred_link_class("HOROVOD_CROSS_RING_LINK_CLASS",
                                cross_ring_addrs())


def _wire_dtype_for(env_name: str, link_class: str) -> str:
    val = (os.environ.get(env_name) or "").strip().lower()
    if val in RING_WIRE_DTYPES:
        return val
    return RING_WIRE_DTYPE_BY_LINK[link_class]


def ring_wire_dtype_local() -> str:
    """``HOROVOD_RING_WIRE_DTYPE_LOCAL``: the wire dtype of the
    hierarchical plane's local hop; default by its link class."""
    return _wire_dtype_for("HOROVOD_RING_WIRE_DTYPE_LOCAL",
                           local_ring_link_class())


def ring_wire_dtype_cross() -> str:
    """``HOROVOD_RING_WIRE_DTYPE_CROSS``: the wire dtype of the
    hierarchical plane's cross hop; default by its link class."""
    return _wire_dtype_for("HOROVOD_RING_WIRE_DTYPE_CROSS",
                           cross_ring_link_class())


def pipeline_enabled() -> bool:
    """``HOROVOD_PIPELINE``: the native engine's double-buffered data
    plane (a wire thread runs fused group N on the ring while the engine
    thread packs N+1). Default on; ``0`` gives the serial stream. Results
    are byte-identical either way."""
    return _env_bool("HOROVOD_PIPELINE", True)


def ring_chunk_bytes() -> int:
    """``HOROVOD_RING_CHUNK_BYTES`` (per rank; ranks need not agree). 0
    (the default, and for garbage) means auto: the link-class default,
    and the knob joins the autotuner's search. A positive value pins
    it."""
    return max(0, _env_int("HOROVOD_RING_CHUNK_BYTES", 0))


def resolved_ring_chunk_bytes() -> int:
    """The chunk size the rings start at: :func:`ring_chunk_bytes`, else,
    when it is auto, the flat ring's link-class default."""
    return ring_chunk_bytes() or RING_CHUNK_BYTES_BY_LINK[ring_link_class()]


# The backward-order bucket scheduler's default bucket: big enough that
# per-bucket negotiation amortizes, small enough that the first reduction
# launches while most of the backward pass still runs.
DEFAULT_BUCKET_BYTES = 8 * 1024 * 1024


def bucket_bytes() -> int:
    """``HOROVOD_BUCKET_BYTES``: size bound of the backward-order gradient
    buckets. 0 (the default, and for garbage) means auto: the 8 MiB
    default, and the knob joins the autotuner's search. A positive value
    pins it."""
    return max(0, _env_int("HOROVOD_BUCKET_BYTES", 0))


def resolved_bucket_bytes() -> int:
    """The bucket size the scheduler starts at: the explicit value, else
    the default."""
    return bucket_bytes() or DEFAULT_BUCKET_BYTES


def autotune_straggler_weight() -> float:
    """``HOROVOD_AUTOTUNE_STRAGGLER_WEIGHT``: how strongly the autotuner's
    score discounts throughput for negotiation slack and excess recv-wait.
    0 gives the pure bytes/sec objective; negative or garbage values clamp
    to the default 1.0."""
    val = _env_float("HOROVOD_AUTOTUNE_STRAGGLER_WEIGHT", 1.0)
    return val if val >= 0 else 1.0


def autotune_overlap_weight() -> float:
    """``HOROVOD_AUTOTUNE_OVERLAP_WEIGHT``: how strongly the score rewards
    the bucket scheduler's measured backward/comm overlap (a factor
    ``1 + w * overlap``). 0 removes the term; negative or garbage values
    clamp to the default 1.0."""
    val = _env_float("HOROVOD_AUTOTUNE_OVERLAP_WEIGHT", 1.0)
    return val if val >= 0 else 1.0


def autotune_priors() -> str:
    """``HOROVOD_AUTOTUNE_PRIORS``: ``capacity`` seeds the autotuner's
    first bucket/chunk configuration from the capacity calibration named
    by :func:`capacity_calibration_path`; anything else (default ``off``)
    keeps the resolver defaults. Explicit pins always win."""
    val = (env_str("HOROVOD_AUTOTUNE_PRIORS") or "").strip().lower()
    return "capacity" if val == "capacity" else "off"


def capacity_calibration_path() -> Optional[str]:
    """``HOROVOD_CAPACITY_CALIBRATION``: path of a control-plane
    calibration artifact (``control_plane`` + ``model_vs_measured`` JSON);
    None when unset or blank."""
    val = env_str("HOROVOD_CAPACITY_CALIBRATION")
    return val.strip() if val and val.strip() else None


def clock_sync_cycles() -> int:
    """``HOROVOD_CLOCK_SYNC_CYCLES``: coordinator cycles between two
    clock-ping bursts of a traced job. Default 100, at least 1."""
    return max(1, _env_int("HOROVOD_CLOCK_SYNC_CYCLES", 100))


@dataclasses.dataclass(frozen=True)
class Config:
    """The knobs the eager-tier controller reads, snapshotted at
    ``init()`` — the JAX package's names and defaults."""

    # Liveness: per-recv deadline (0 = none) and idle heartbeat period
    # (0 = none). No field defaults: the heartbeat's default follows the
    # deadline, so both come from ``comm_timeout_seconds()`` and
    # ``heartbeat_interval_seconds()`` in :meth:`from_env`.
    comm_timeout_seconds: float
    heartbeat_interval_seconds: float
    # Tensor Fusion: fused allreduce buffers up to this many bytes.
    fusion_threshold_bytes: int = DEFAULT_FUSION_THRESHOLD_BYTES
    # Background controller tick, ms.
    cycle_time_ms: float = DEFAULT_CYCLE_TIME_MS
    # Response-cache entries; 0 disables.
    cache_capacity: int = DEFAULT_CACHE_CAPACITY
    # Chrome-trace timeline written by rank 0.
    timeline_filename: Optional[str] = None
    timeline_mark_cycles: bool = False
    # Stall detection: warn after stall_check_seconds, shut the job down
    # after stall_shutdown_seconds (0 = never).
    stall_check_disable: bool = False
    stall_check_seconds: float = DEFAULT_STALL_CHECK_SECONDS
    stall_shutdown_seconds: float = 0.0
    # Two-level data plane (a ring inside each host plus a ring of the
    # hosts' first ranks), when the launcher exported the group rings.
    hierarchical_allreduce: bool = False
    hierarchical_allgather: bool = False
    # Cluster tracing: every rank writes clock-anchored phase spans under
    # this directory; rank 0 merges them (and the straggler report) at
    # clean shutdown.
    trace_dir: Optional[str] = None
    # The GP autotuner on rank 0, and its per-configuration CSV.
    autotune: bool = False
    autotune_log: Optional[str] = None
    log_level: str = "warning"
    log_hide_timestamp: bool = False

    @staticmethod
    def from_env() -> "Config":
        return Config(
            fusion_threshold_bytes=_env_int(
                "HOROVOD_FUSION_THRESHOLD", DEFAULT_FUSION_THRESHOLD_BYTES),
            cycle_time_ms=_env_float("HOROVOD_CYCLE_TIME",
                                     DEFAULT_CYCLE_TIME_MS),
            cache_capacity=_env_int("HOROVOD_CACHE_CAPACITY",
                                    DEFAULT_CACHE_CAPACITY),
            timeline_filename=os.environ.get("HOROVOD_TIMELINE") or None,
            timeline_mark_cycles=_env_bool("HOROVOD_TIMELINE_MARK_CYCLES"),
            stall_check_disable=_env_bool("HOROVOD_STALL_CHECK_DISABLE"),
            stall_check_seconds=_env_float(
                "HOROVOD_STALL_CHECK_TIME_SECONDS",
                DEFAULT_STALL_CHECK_SECONDS),
            stall_shutdown_seconds=_env_float(
                "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS", 0.0),
            hierarchical_allreduce=_env_bool(
                "HOROVOD_HIERARCHICAL_ALLREDUCE"),
            hierarchical_allgather=_env_bool(
                "HOROVOD_HIERARCHICAL_ALLGATHER"),
            comm_timeout_seconds=comm_timeout_seconds(),
            heartbeat_interval_seconds=heartbeat_interval_seconds(),
            trace_dir=trace_dir(),
            autotune=_env_bool("HOROVOD_AUTOTUNE"),
            autotune_log=os.environ.get("HOROVOD_AUTOTUNE_LOG") or None,
            log_level=log_level_name(),
            log_hide_timestamp=_env_bool("HOROVOD_LOG_HIDE_TIME"),
        )
