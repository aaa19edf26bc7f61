"""Compute/communication-overlap evidence from a profiled step's kernel
timeline — the port's counterpart of ``horovod_tpu/utils/overlap.py``.

The JAX module reads overlap out of a compiled module's schedule
(``X-start``/``X-done`` pairs with compute scheduled between them). An
eager PyTorch step has no compiled schedule: the kernels the card ran
are the evidence. :func:`overlap_report` returns the JAX report's keys,
built from a ``torch.profiler`` trace (``common/profiler.trace``):

* every collective kernel (``nccl*``; on a CPU-only trace, a gloo
  ``c10d::*`` range) is one ``async_pairs`` entry, its interval the
  kernel's: a collective runs on its own stream, asynchronous to the
  host. It counts as overlapped when compute kernels (every other
  kernel; on the CPU, the top-level ops of other threads) on another
  stream run inside its interval, ``compute_in_flight`` counting them;
* ``sync_collectives``: the collectives with no compute in flight, each
  at its position among the step's kernels with the compute that comes
  after it, attributed by its ``hvd.*`` label (``op_name``).

``parse_entry_schedule`` and ``async_pairs`` over HLO text have no
counterpart: there is no HLO text.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from .comm_accounting import _C10D, MARK_OP, collective_records
from .hlo_phases import Timeline

# nccl kernel name fragments -> the JAX opcodes.
_NCCL_OPS = (("allreduce", "all-reduce"), ("reducescatter", "reduce-scatter"),
             ("allgather", "all-gather"), ("sendrecv", "collective-permute"),
             ("send", "collective-permute"), ("recv", "collective-permute"),
             ("alltoall", "all-to-all"), ("broadcast", "broadcast"))


@dataclasses.dataclass
class SyncPlacement:
    opcode: str
    index: int              # position among the step's kernels
    schedule_frac: float    # position / number of kernels
    payload_bytes: int
    compute_after: int      # compute kernels that start after this ends
    compute_after_frac: float
    # The innermost hvd.* label that launched it ("" when none): the
    # ground truth for "is this gradient traffic" that no byte-size
    # heuristic can give.
    op_name: str = ""


@dataclasses.dataclass
class _Op:
    ts: float
    end: float
    stream: tuple
    collective: bool
    opcode: str = ""
    payload_bytes: int = 0
    label: str = ""


def _nccl_opcode(name: str) -> str:
    low = name.lower()
    return next((op for key, op in _NCCL_OPS if key in low), "collective")


def _timeline_ops(tl: Timeline) -> List[_Op]:
    """The scheduled ops in time order: device kernels when the trace
    has any, else the CPU collectives and the top-level CPU ops of every thread
    that hold none."""
    ops = []
    if tl.device:
        records = {}
        for i in tl.device:
            ev = tl.events[i]
            if ev.get("cat") != "kernel":
                continue
            coll = "nccl" in ev.get("name", "").lower()
            ts = float(ev["ts"])
            op = _Op(ts, ts + float(ev.get("dur", 0)),
                     (ev.get("pid"), ev.get("tid")), coll)
            if coll:
                op.opcode = _nccl_opcode(ev.get("name", ""))
                c10d = [j for j in tl.device_stack(i)
                        if tl.name(j) in _C10D]
                if c10d:
                    if not records:
                        records = _records_by_event(tl)
                    coll_rec, label = records.get(c10d[-1], (None, ""))
                    if coll_rec is not None:
                        op.opcode = coll_rec.op
                        op.payload_bytes = coll_rec.payload_bytes
                    op.label = label
                else:
                    labels = [j for j in reversed(tl.device_stack(i))
                              if tl.name(j).startswith("hvd.")]
                    op.label = tl.name(labels[0]) if labels else ""
            ops.append(op)
    else:
        records = _records_by_event(tl)
        holds = {j for i in records for j in tl.parents[i]}
        for i, parents in tl.parents.items():
            ev = tl.events[i]
            top = (ev.get("cat") == "cpu_op" and i not in holds
                   and tl.name(i) != MARK_OP and not any(
                       tl.events[j].get("cat") == "cpu_op" for j in parents))
            if not (top or i in records):
                continue
            ts = float(ev["ts"])
            op = _Op(ts, ts + float(ev.get("dur", 0)),
                     (ev.get("pid"), ev.get("tid")), i in records)
            if op.collective:
                coll_rec, op.label = records[i]
                op.opcode, op.payload_bytes = (coll_rec.op,
                                               coll_rec.payload_bytes)
            ops.append(op)
    ops.sort(key=lambda o: (o.ts, o.end))
    return ops


def _records_by_event(tl: Timeline) -> Dict[int, tuple]:
    """c10d event id -> (Collective, label)."""
    return {i: (c, label) for i, c, label in collective_records(tl)}


def overlap_report(trace) -> dict:
    """One dict with the JAX report's keys, JSON-ready, from a profiled
    run (a trace path, its parsed JSON or a
    :class:`~.hlo_phases.Timeline`)."""
    tl = trace if isinstance(trace, Timeline) else Timeline(trace)
    ops = _timeline_ops(tl)
    compute = [o for o in ops if not o.collective]
    n_compute = max(1, len(compute))
    pairs, syncs = [], []
    for index, o in enumerate(ops):
        if not o.collective:
            continue
        inflight = sum(1 for c in compute if c.stream != o.stream
                       and c.ts < o.end and c.end > o.ts)
        pairs.append((o, inflight))
        if inflight == 0:
            after = sum(1 for c in compute if c.ts >= o.end)
            syncs.append(SyncPlacement(
                o.opcode, index, index / max(1, len(ops)), o.payload_bytes,
                after, after / n_compute, o.label))
    return {
        "n_scheduled_ops": len(ops),
        "n_compute_ops": len(compute),
        "async_pairs": {
            "count": len(pairs),
            "with_compute_in_flight": sum(1 for _, n in pairs if n > 0),
            "total_compute_in_flight": sum(n for _, n in pairs),
            "payload_bytes": sum(o.payload_bytes for o, _ in pairs),
            "by_op": _count_by(o.opcode for o, _ in pairs),
        },
        "sync_collectives": [dataclasses.asdict(s) for s in syncs],
    }


def _count_by(items) -> Dict[str, int]:
    c: Dict[str, int] = {}
    for x in items:
        c[x] = c.get(x, 0) + 1
    return c
