"""Build + ctypes bindings for the port's native host core — the
counterpart of ``horovod_tpu/core/bindings.py`` on torch tensors.

The C++ sources under ``core/src/`` are the port's own copies of the JAX
package's (``ring.cc``, ``engine.cc``, ``shm.cc`` and their headers), C
ABI and wire format unchanged, so a port rank and a JAX rank compute the
same bytes. They build with ``g++`` at first use into
``build/horovod_tpu_torch/libhvdcore-<hash>.so``; the hash covers the
flags, the host CPU's signature (``-march=native``) and the sources, so
an edited source or another ISA gets a library of its own. Ranks that
start together each compile to a private temporary file and rename it
into place, so no loader maps a half-written library.

A failed build raises with the compiler's output: nothing falls back to
the TCP star (``HOROVOD_CPU_OPS=star`` selects the star explicitly).

Tensors cross the ABI as ``data_ptr()`` of contiguous CPU tensors; the
dtype codes below map ``torch.dtype``s to ``enum DType`` in ``ring.cc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import torch

from ..common import hvd_logging as logging

SRC_DIR = Path(__file__).resolve().parent / "src"
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "horovod_tpu_torch")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

# Must match enum WireDType in ring.cc: the on-the-wire representation of
# f32 allreduce payloads (HOROVOD_RING_WIRE_DTYPE via common/config.py).
WIRE_DTYPE_CODES = {"none": 0, "bf16": 1, "fp16": 2, "int8": 3}

# Must match enum WireLink in ring.cc: which plane's connections a ring's
# wire traffic rides (indexes the per-link counter rows).
WIRE_LINK_CODES = {"flat": 0, "local": 1, "cross": 2}

# Counter-slot layout of hvd_eng_get_counters: MUST mirror enum
# CounterSlot in core/src/engine.cc (tests/test_torch_native_engine.py
# pins the two against each other).
NATIVE_HIST_BUCKETS = 22   # kHistBuckets
NATIVE_HIST_SLOTS = NATIVE_HIST_BUCKETS + 1  # + the +Inf overflow slot
NATIVE_COUNTER_SCALARS = (
    "cycles", "tensors", "fused_tensors", "processed_bytes",
    "fusion_capacity", "fusion_fill", "spans", "spans_dropped",
    "bucket_bytes", "cache_hits", "cache_misses",
    "pipeline_depth", "pipeline_stall_us", "priority_jumps")
_NATIVE_CYCLE_HIST_BASE = len(NATIVE_COUNTER_SCALARS)            # 14
_NATIVE_EXEC_HIST_BASE = _NATIVE_CYCLE_HIST_BASE + 2 + NATIVE_HIST_SLOTS
_NATIVE_ENGINE_GEN = _NATIVE_EXEC_HIST_BASE + 2 + NATIVE_HIST_SLOTS  # 64
N_NATIVE_COUNTER_SLOTS = _NATIVE_ENGINE_GEN + 1                      # 65

# Must match enum DType in ring.cc.
DTYPE_CODES = {
    torch.float32: 0,
    torch.float64: 1,
    torch.int32: 2,
    torch.int64: 3,
    torch.uint8: 4,
    torch.float16: 5,
    torch.bfloat16: 6,
    torch.int8: 7,
    torch.int16: 8,
    torch.uint16: 9,
    torch.bool: 10,
}
DTYPES = {v: k for k, v in DTYPE_CODES.items()}

# Vectorize the reduction loops for the build host; the artifact name
# keys on these flags and the CPU, so another ISA builds its own file.
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
             "-march=native"]


def dtype_code(dtype: torch.dtype) -> Optional[int]:
    """``ring.cc``'s code for ``dtype``; None when the core cannot carry
    it (uint32/uint64, complex)."""
    return DTYPE_CODES.get(dtype)


def _cpu_signature() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return hashlib.sha256(line.encode()).hexdigest()[:16]
    except OSError:
        pass
    return platform.machine()


def _sources() -> List[Path]:
    return sorted(p for p in SRC_DIR.iterdir() if p.suffix in (".cc", ".h"))


def lib_path() -> Path:
    """Where the library for this host, these flags and these sources
    lives."""
    digest = hashlib.sha256(
        (" ".join(CXX_FLAGS) + " cpu:" + _cpu_signature()).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libhvdcore-{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the core unless this host already has it; raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    path = lib_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.tmp.{os.getpid()}")
    cmd = ["g++", *CXX_FLAGS,
           *[str(p) for p in _sources() if p.suffix == ".cc"],
           "-o", str(tmp), "-lrt"]
    logging.debug("building the native core: %s", " ".join(cmd))
    try:
        try:
            result = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as exc:
            raise RuntimeError(
                f"building the native core failed: g++: {exc}") \
                from exc
        if result.returncode != 0:
            raise RuntimeError(
                f"building the native core failed ({' '.join(cmd)}):\n"
                f"{result.stderr}")
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            tmp.unlink()
    return path


def loaded() -> Optional[ctypes.CDLL]:
    """The library if this process loaded it, else None — without
    building."""
    return _lib


def _c(lib, name, restype, *argtypes):
    fn = getattr(lib, name)
    fn.restype = restype
    fn.argtypes = list(argtypes)


def load() -> ctypes.CDLL:
    """The loaded core, built first if needed. Raises when it cannot be
    built."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        vp, i, l, ll, d = (ctypes.c_void_p, ctypes.c_int, ctypes.c_long,
                           ctypes.c_longlong, ctypes.c_double)
        cp, u8p = ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8)
        llp, lp = ctypes.POINTER(ll), ctypes.POINTER(l)
        _c(lib, "hvd_ring_set_chunk_bytes", None, l)
        _c(lib, "hvd_ring_get_chunk_bytes", l)
        _c(lib, "hvd_ring_get_wire_stats", None, llp, llp,
           ctypes.POINTER(d))
        _c(lib, "hvd_ring_get_wire_stats_link", None, i, llp, llp)
        _c(lib, "hvd_ring_last_error", cp)
        _c(lib, "hvd_ringh_create", vp, i, i, cp, u8p, i)
        _c(lib, "hvd_ringh_set_link", None, vp, i)
        # The send cap (RingBackend.set_rate) the wire probe's emulated
        # cross links use.
        _c(lib, "hvd_ringh_set_rate", None, vp, d)
        _c(lib, "hvd_ringh_allreduce_wire", i, vp, vp, l, i, i, i, vp)
        _c(lib, "hvd_ringh_allgather", i, vp, vp, lp, vp, i)
        _c(lib, "hvd_ringh_broadcast", i, vp, vp, l, i, i)
        _c(lib, "hvd_ringh_destroy", None, vp)
        # The engine (engine.cc): init, enqueue and the result surface.
        _c(lib, "hvd_eng_init", i, i, i, cp, u8p, i, d, ll, i, i, d, d, cp,
           i, i, i, i, i)
        _c(lib, "hvd_eng_enqueue", ll, i, cp, vp, llp, i, i, i, vp, i)
        _c(lib, "hvd_eng_poll", i, ll)
        _c(lib, "hvd_eng_wait", i, ll)
        _c(lib, "hvd_eng_wait_for", i, ll, d)
        _c(lib, "hvd_eng_hier_active", i)
        _c(lib, "hvd_eng_result_ndim", i, ll)
        _c(lib, "hvd_eng_result_dtype", i, ll)
        _c(lib, "hvd_eng_result_in_place", i, ll)
        _c(lib, "hvd_eng_result_shape", None, ll, llp)
        _c(lib, "hvd_eng_result_copy", i, ll, vp)
        _c(lib, "hvd_eng_result_nbytes", ll, ll)
        _c(lib, "hvd_eng_result_sizes_count", i, ll)
        _c(lib, "hvd_eng_result_sizes", None, ll, llp)
        _c(lib, "hvd_eng_handle_error", cp, ll)
        _c(lib, "hvd_eng_release", None, ll)
        _c(lib, "hvd_eng_get_stats", None, llp, llp, ctypes.POINTER(d))
        _c(lib, "hvd_eng_shutdown", i)
        _c(lib, "hvd_eng_last_error", cp)
        _c(lib, "hvd_eng_active", i)
        _c(lib, "hvd_eng_get_counters", i, llp, i)
        # The tuning and tracing loop: rank 0's pushes, the cumulative
        # cycle stats it scores, the span ring and its overhead probe.
        ip, dp = ctypes.POINTER(i), ctypes.POINTER(d)
        _c(lib, "hvd_eng_set_params", None, ll, d)
        _c(lib, "hvd_eng_set_tuned_bucket", None, ll)
        _c(lib, "hvd_eng_trace_set", None, i, ll)
        _c(lib, "hvd_eng_get_spans", i, ll, ip, llp, dp, dp, ip, cp, i)
        _c(lib, "hvd_eng_span_probe", d, ll)
        _lib = lib
        return _lib


def wire_stats() -> dict:
    """The ring's wire counters of this process
    (``hvd_ring_get_wire_stats``): bytes sent (``tx_bytes``) and their
    float32 equivalent (``logical_bytes``) per wire dtype, the same per
    link class under ``by_link`` (flat/local/cross:
    ``hvd_ring_get_wire_stats_link``), the cumulative compress seconds
    and the live transfer-chunk size; zeros when the core was never
    loaded."""
    out = {
        "tx_bytes": dict.fromkeys(WIRE_DTYPE_CODES, 0),
        "logical_bytes": dict.fromkeys(WIRE_DTYPE_CODES, 0),
        "by_link": {
            link: {"tx_bytes": dict.fromkeys(WIRE_DTYPE_CODES, 0),
                   "logical_bytes": dict.fromkeys(WIRE_DTYPE_CODES, 0)}
            for link in WIRE_LINK_CODES},
        "compress_seconds": 0.0,
        "chunk_bytes": 0,
    }
    lib = loaded()
    if lib is None:
        return out
    tx = (ctypes.c_longlong * 4)()
    logical = (ctypes.c_longlong * 4)()
    comp = ctypes.c_double()
    lib.hvd_ring_get_wire_stats(tx, logical, ctypes.byref(comp))
    for name, code in WIRE_DTYPE_CODES.items():
        out["tx_bytes"][name] = int(tx[code])
        out["logical_bytes"][name] = int(logical[code])
    for link, lcode in WIRE_LINK_CODES.items():
        lib.hvd_ring_get_wire_stats_link(lcode, tx, logical)
        row = out["by_link"][link]
        for name, code in WIRE_DTYPE_CODES.items():
            row["tx_bytes"][name] = int(tx[code])
            row["logical_bytes"][name] = int(logical[code])
    out["compress_seconds"] = float(comp.value)
    out["chunk_bytes"] = int(lib.hvd_ring_get_chunk_bytes())
    return out


def set_chunk_bytes(nbytes: int) -> None:
    """The ring's transfer-chunk size (per-rank pipelining granularity;
    the C side clamps and rounds it). No-op before the core is loaded."""
    lib = loaded()
    if lib is not None:
        lib.hvd_ring_set_chunk_bytes(int(nbytes))


def native_counters() -> Optional[dict]:
    """The engine's cumulative counters (``hvd_eng_get_counters``): the
    scalar slots by name, the ``cycle_seconds``/``execute_seconds``
    histograms ({count, sum_seconds, counts[23]} over the registry's
    ``DEFAULT_TIME_BUCKETS`` edges), ``engine_gen`` (bumped by each engine
    init) and ``responses``, the count of the execute histogram (one a
    response executed). None when no engine runs in this process or the
    library's slot layout differs."""
    lib = loaded()
    if lib is None or not lib.hvd_eng_active():
        return None
    arr = (ctypes.c_longlong * N_NATIVE_COUNTER_SLOTS)()
    n = lib.hvd_eng_get_counters(arr, N_NATIVE_COUNTER_SLOTS)
    if n != N_NATIVE_COUNTER_SLOTS:
        logging.warning(
            "native engine counter layout drift (library reports %d "
            "slots, bindings expect %d)", n, N_NATIVE_COUNTER_SLOTS)
        return None
    out = {name: int(arr[k]) for k, name in enumerate(NATIVE_COUNTER_SCALARS)}

    def _hist(base):
        return {"count": int(arr[base]),
                "sum_seconds": arr[base + 1] / 1e6,
                "counts": [int(arr[base + 2 + k])
                           for k in range(NATIVE_HIST_SLOTS)]}

    out["cycle_seconds"] = _hist(_NATIVE_CYCLE_HIST_BASE)
    out["execute_seconds"] = _hist(_NATIVE_EXEC_HIST_BASE)
    out["engine_gen"] = int(arr[_NATIVE_ENGINE_GEN])
    out["responses"] = out["execute_seconds"]["count"]
    return out


def engine_stats() -> "tuple[int, int, float]":
    """The engine's cumulative ``(cycles, bytes, busy_seconds)``
    (``hvd_eng_get_stats``): what rank 0's autotuner scores."""
    cycles, nbytes = ctypes.c_longlong(), ctypes.c_longlong()
    busy = ctypes.c_double()
    load().hvd_eng_get_stats(ctypes.byref(cycles), ctypes.byref(nbytes),
                             ctypes.byref(busy))
    return int(cycles.value), int(nbytes.value), float(busy.value)


# Bytes of one span's op-name slot: ``kSpanOpBytes`` of engine.cc.
NATIVE_SPAN_OP_BYTES = 64


def drain_engine_spans(batch: int = 512):
    """Yield ``(phase_code, seq, t0, t1, tensors, op)`` for every span in
    the engine's ring, oldest first, consuming them. ``phase_code``
    indexes ``trace.PHASES`` (engine.cc's ``SpanPhase``); ``t0``/``t1``
    are CLOCK_MONOTONIC seconds (``time.monotonic()``'s clock); ``seq``
    is -1 when no collective id applies."""
    lib = loaded()
    if lib is None:
        return
    stride = NATIVE_SPAN_OP_BYTES
    phases = (ctypes.c_int * batch)()
    seqs = (ctypes.c_longlong * batch)()
    t0s = (ctypes.c_double * batch)()
    t1s = (ctypes.c_double * batch)()
    tensors = (ctypes.c_int * batch)()
    ops = ctypes.create_string_buffer(batch * stride)
    while True:
        n = lib.hvd_eng_get_spans(batch, phases, seqs, t0s, t1s, tensors,
                                  ops, stride)
        if n <= 0:
            return
        raw = ops.raw
        for k in range(n):
            op = raw[k * stride:(k + 1) * stride].split(b"\0", 1)[0]
            yield (int(phases[k]), int(seqs[k]), float(t0s[k]),
                   float(t1s[k]), int(tensors[k]),
                   op.decode(errors="replace"))
        if n < batch:
            return


def _host_tensor(t: torch.Tensor, what: str) -> int:
    """``ring.cc``'s dtype code of a contiguous CPU tensor."""
    code = dtype_code(t.dtype)
    if code is None:
        raise TypeError(f"ring {what}: unsupported dtype {t.dtype}")
    if t.device.type != "cpu" or not t.is_contiguous():
        raise ValueError(f"ring {what} needs a contiguous CPU tensor")
    return code


class RingBackend:
    """One authenticated TCP ring over the handle ABI (``hvd_ringh_*``)
    on contiguous CPU tensors. A process can hold several (the flat ring
    and the hierarchical local/cross pair); each is driven by one thread
    at a time (the controller's)."""

    def __init__(self, rank: int, size: int, addrs: str, secret: bytes):
        self._lib = load()
        key = (ctypes.c_uint8 * len(secret)).from_buffer_copy(secret)
        self._handle = self._lib.hvd_ringh_create(
            rank, size, addrs.encode(), key, len(secret))
        if not self._handle:
            raise RuntimeError(f"ring init failed: {self._last_error()}")

    def _last_error(self) -> str:
        return self._lib.hvd_ring_last_error().decode(errors="replace")

    def allreduce_(self, t: torch.Tensor, average: bool = False,
                   wire_dtype: int = 0,
                   residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Sum (or mean) across ranks, in place. ``wire_dtype`` (a
        ``WIRE_DTYPE_CODES`` code) compresses float32 payloads on the
        wire; ``residual`` (float32, as many elements, contiguous)
        receives the int8 error-feedback residual."""
        code = _host_tensor(t, "allreduce")
        res_ptr = None
        if residual is not None:
            if (residual.dtype != torch.float32
                    or residual.numel() != t.numel()
                    or not residual.is_contiguous()):
                raise ValueError("residual must be a contiguous float32 "
                                 "tensor of the payload's element count")
            res_ptr = residual.data_ptr()
        rc = self._lib.hvd_ringh_allreduce_wire(
            self._handle, t.data_ptr(), t.numel(), code,
            1 if average else 0, int(wire_dtype), res_ptr)
        if rc != 0:
            raise RuntimeError(f"ring allreduce failed: {self._last_error()}")
        return t

    def allgather(self, t: torch.Tensor,
                  counts: Sequence[int]) -> torch.Tensor:
        """Every rank's block (``counts[r]`` elements) concatenated, flat;
        the caller reshapes."""
        code = _host_tensor(t, "allgather")
        counts_arr = (ctypes.c_long * len(counts))(*counts)
        out = torch.empty(int(sum(counts)), dtype=t.dtype)
        rc = self._lib.hvd_ringh_allgather(
            self._handle, t.data_ptr(), counts_arr, out.data_ptr(), code)
        if rc != 0:
            raise RuntimeError(f"ring allgather failed: {self._last_error()}")
        return out

    def broadcast_(self, t: torch.Tensor, root: int) -> torch.Tensor:
        code = _host_tensor(t, "broadcast")
        rc = self._lib.hvd_ringh_broadcast(
            self._handle, t.data_ptr(), t.numel(), code, root)
        if rc != 0:
            raise RuntimeError(f"ring broadcast failed: {self._last_error()}")
        return t

    def set_rate(self, bytes_per_s: float) -> None:
        """Cap this ring's sends at ``bytes_per_s`` per connection (a
        token bucket; 0 lifts it): an emulated slow link for the wire
        probe's two-level layout on one host."""
        self._lib.hvd_ringh_set_rate(self._handle, float(bytes_per_s))

    def set_link(self, link: str) -> None:
        """Tag this ring's link class (``WIRE_LINK_CODES``) so its
        traffic lands in the right per-link counter row."""
        self._lib.hvd_ringh_set_link(self._handle, WIRE_LINK_CODES[link])

    def shutdown(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.hvd_ringh_destroy(self._handle)
            self._handle = None
