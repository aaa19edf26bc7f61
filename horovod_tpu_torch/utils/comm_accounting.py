"""Communication-volume accounting from a profiled step — the port's
counterpart of ``horovod_tpu/utils/comm_accounting.py``.

The JAX module parses the collectives out of compiled HLO; an eager
PyTorch step has no compiled program, so :func:`collectives` reads a
``torch.profiler`` trace of the step (``common/profiler.trace``) instead:
every ``c10d::*`` op the step called on a process group, billed with its
payload bytes at its group's size. The ring-model theory to pin them
against (:func:`ring_allreduce_bytes` ... :func:`wire_bytes_per_device`),
:class:`Collective`, :func:`count_by_op`, :func:`payload_by_op` and
:data:`DECODE_PATH_MARKERS` are the JAX module's, equal as data.

Wire-byte model (ring algorithms, the NCCL standard):

* all-reduce of ``B`` bytes over ``n`` devices: each device sends (and
  receives) ``2 (n-1)/n * B`` — reduce-scatter half + all-gather half.
* reduce-scatter / all-gather alone: ``(n-1)/n * B`` each (``B`` = the
  FULL pre-scatter / post-gather payload).
* collective-permute (ring hop): each device sends its shard once.
* all-to-all of ``B`` bytes: ``(n-1)/n * B`` leaves each device.

Reading the trace: sizes come from the exported trace's ``Input Dims``
(the in-memory events of ``c10d::allreduce_`` show none: it takes a
tensor list). The dtype comes from the op's ``Input type`` where the
argument is one tensor; for a tensor list (``allreduce_``,
``allgather_``, ``broadcast_``, ``send``/``recv_``), and for the group
size of every op, from the marker op that the enclosing ``hvd.*`` label
of ``common/profiler.py`` records. A list op outside any label raises.
Controller-tier collectives (the eager tier's own TCP planes) move no
``c10d`` op and are not counted; their labels still show in the trace.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from .hlo_phases import Timeline

# The trace's C++ type names of tensor elements, in bytes.
_TYPE_BYTES = {
    "float": 4, "double": 8, "c10::Half": 2, "c10::BFloat16": 2,
    "int": 4, "long int": 8, "short int": 2, "signed char": 1,
    "unsigned char": 1, "bool": 1, "c10::complex<float>": 8,
    "c10::complex<double>": 16, "c10::Float8_e4m3fn": 1,
    "c10::Float8_e5m2": 1,
}

COLLECTIVE_OPS = ("all-reduce", "reduce-scatter", "all-gather",
                  "collective-permute", "all-to-all")

# c10d op -> (opcode, which argument holds the payload, whether it is a
# tensor list, whether the payload is that argument times the group
# size). The payload is the op's logical result, as the JAX module's:
# the reduced array, the scattered shard, the gathered whole, the
# exchanged buffer, one hop's shard.
_C10D = {
    "c10d::allreduce_": ("all-reduce", 0, True, False),
    "c10d::allreduce_coalesced_": ("all-reduce", 0, True, False),
    "c10d::_allgather_base_": ("all-gather", 0, False, False),
    "c10d::allgather_": ("all-gather", 1, True, True),
    "c10d::allgather_into_tensor_coalesced_": ("all-gather", 0, True,
                                               False),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", 0, False, False),
    "c10d::reduce_scatter_": ("reduce-scatter", 0, True, False),
    "c10d::reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0, True,
                                               False),
    "c10d::alltoall_base_": ("all-to-all", 0, False, False),
    "c10d::alltoall_": ("all-to-all", 0, True, False),
    "c10d::broadcast_": ("broadcast", 0, True, False),
    # A ring hop counts once, at its send (its recv_ is the same bytes).
    "c10d::send": ("collective-permute", 0, True, False),
}

MARK_OP = "hvd_profile::mark"


@dataclasses.dataclass
class Collective:
    op: str             # opcode (all-reduce, ...)
    payload_bytes: int  # summed result-shape bytes (full logical payload)
    group_size: int     # devices per replica group (1 = unknown/whole)


def _numel(dims) -> int:
    n = 1
    for d in dims:
        n *= int(d)
    return n


def _tensor_dims(arg) -> List[list]:
    """An ``Input Dims`` entry as a list of tensor shapes (one for a
    tensor, several for a tensor list; an empty list exported as [])."""
    if arg and isinstance(arg[0], list):
        return arg
    return [arg] if arg else []


def _marks(tl: Timeline) -> Dict[int, dict]:
    """Label event id -> the args of the marker op recorded directly
    inside it."""
    marks = getattr(tl, "_marks", None)
    if marks is None:
        marks = {}
        for j, parents in tl.parents.items():
            if parents and tl.name(j) == MARK_OP:
                marks.setdefault(parents[-1], tl.events[j].get("args", {}))
        tl._marks = marks
    return marks


def _mark_of(tl: Timeline, i: int) -> Optional[dict]:
    """The args of the marker op recorded by the innermost ``hvd.*``
    label enclosing event ``i``."""
    marks = _marks(tl)
    for label in tl.labels(i):
        if label in marks:
            return marks[label]
    return None


def collective_records(trace) -> List[Tuple[int, Collective, str]]:
    """``(event id, Collective, label)`` for every ``c10d`` collective
    of a profiled run, in time order; ``label`` is the innermost
    enclosing ``hvd.*`` label ("" when none)."""
    tl = trace if isinstance(trace, Timeline) else Timeline(trace)
    out = []
    for i in sorted(tl.parents, key=lambda i: float(tl.events[i]["ts"])):
        spec = _C10D.get(tl.name(i))
        if spec is None or tl.events[i].get("cat") != "cpu_op":
            continue
        op, arg, is_list, times_n = spec
        args = tl.events[i].get("args", {})
        dims = args.get("Input Dims", [])
        types = args.get("Input type", [])
        shapes = _tensor_dims(dims[arg] if arg < len(dims) else [])
        mark = _mark_of(tl, i)
        itemsize = _TYPE_BYTES.get(types[arg] if arg < len(types) else "")
        if itemsize is None and mark is not None:
            itemsize = _TYPE_BYTES.get((mark.get("Input type") or [""])[0])
        if itemsize is None:
            raise ValueError(
                f"{tl.name(i)} at ts {tl.events[i]['ts']}: the element "
                "type is not in the trace (a tensor-list op outside an "
                "hvd.* label)")
        n = 1
        if mark is not None:
            n = int((mark.get("Concrete Inputs") or ["", "1"])[1] or 1)
        elif not is_list and len(dims) > 1 and dims[1]:
            out_n, in_n = _numel(dims[0]), _numel(dims[1])
            n = max(out_n, in_n) // max(1, min(out_n, in_n))
        payload = sum(_numel(s) for s in shapes) * itemsize
        if times_n:
            payload *= n
        labels = tl.labels(i)
        out.append((i, Collective(op, payload, n),
                    tl.name(labels[0]) if labels else ""))
    return out


def collectives(trace) -> List[Collective]:
    """The collectives of a profiled run (a trace path, its parsed JSON
    or a :class:`~.hlo_phases.Timeline`): payload = the op's result
    bytes (for reduce-scatter the shard, for all-gather the gathered
    whole, for all-reduce the reduced tensors), each billed at its
    process group's size."""
    return [c for _, c, _ in collective_records(trace)]


def count_by_op(colls: List[Collective]) -> Dict[str, int]:
    c: Dict[str, int] = {}
    for x in colls:
        c[x.op] = c.get(x.op, 0) + 1
    return c


def payload_by_op(colls: List[Collective]) -> Dict[str, int]:
    c: Dict[str, int] = {}
    for x in colls:
        c[x.op] = c.get(x.op, 0) + x.payload_bytes
    return c


# ---------------------------------------------------------------------------
# Decode-path attribution.

#: The profiler labels ``models.llama._cached_attention`` wraps each
#: decode path in (the JAX package's scope names). A profiled decode
#: shows which path ran; ``models.llama.LAST_DECODE_PATH`` is the cheap
#: twin. A CUDA graph replays kernels without their labels: read the
#: markers from an eager step.
DECODE_PATH_MARKERS = ("hvd.decode.kernel_tp", "hvd.decode.kernel",
                       "hvd.decode.einsum", "hvd.decode.prefill",
                       "hvd.decode.paged_tp", "hvd.decode.paged")


def decode_path_markers(trace) -> Dict[str, int]:
    """Count each decode-path label's ranges in a profiled decode (a
    trace path, its parsed JSON or a :class:`~.hlo_phases.Timeline`): a
    decode that runs the kernel shows ``kernel`` (or ``paged``) > 0 and
    ``einsum`` == 0; the plain path shows the reverse."""
    tl = trace if isinstance(trace, Timeline) else Timeline(trace)
    counts = {m: 0 for m in DECODE_PATH_MARKERS}
    for ev in tl.events:
        if ev.get("cat") == "user_annotation" and ev.get("name") in counts:
            counts[ev["name"]] += 1
    return counts


# ---------------------------------------------------------------------------
# Ring-model wire bytes (per device, send direction).


def ring_allreduce_bytes(n: int, payload: int) -> float:
    return 2 * (n - 1) / n * payload


def ring_reduce_scatter_bytes(n: int, payload: int) -> float:
    return (n - 1) / n * payload


def ring_all_gather_bytes(n: int, payload: int) -> float:
    return (n - 1) / n * payload


def wire_bytes_per_device(colls: List[Collective],
                          default_n: int) -> float:
    """Ring-model send bytes per device for a profiled step. Each
    collective is billed at its own group size; ``default_n`` covers ops
    whose group size is unknown."""
    total = 0.0
    for x in colls:
        n = x.group_size if x.group_size > 1 else default_n
        if x.op == "all-reduce":
            total += ring_allreduce_bytes(n, x.payload_bytes)
        elif x.op == "reduce-scatter":
            # Result is the shard: full payload = shard * n.
            total += ring_reduce_scatter_bytes(n, x.payload_bytes * n)
        elif x.op == "all-gather":
            total += ring_all_gather_bytes(n, x.payload_bytes)
        elif x.op == "collective-permute":
            total += x.payload_bytes
        elif x.op == "all-to-all":
            total += (n - 1) / n * x.payload_bytes
    return total
