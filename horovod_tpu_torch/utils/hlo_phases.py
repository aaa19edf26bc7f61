"""Shared scaffolding of the per-phase profilers
(``examples/{bert,decode,moe,vit}_phase_profile.py``) — the port's
counterpart of ``horovod_tpu/utils/hlo_phases.py``, reading a
``torch.profiler`` Chrome trace (``common/profiler.trace``) instead of
an XLA xplane.

* :func:`newest_trace` is the counterpart of ``newest_xplane``.
* :func:`kernel_rows` is the counterpart of ``hlo_rows``: one row per
  device kernel name under one label stack (per CPU op on a CPU-only
  trace), with the same keys. ``tf_op_name`` is the stack of CPU ranges
  (``record_function`` labels and aten ops) that enclosed the kernel's
  launch, joined by ``/`` as the JAX name stack is; a kernel launched by
  the backward of an op is prefixed ``transpose(<the forward op's
  stack>)/``, the JAX form, through the autograd sequence number. The
  examples' ``classify()`` runs on it unchanged.
* :func:`add_to_bucket` and :func:`finalize_buckets` are the JAX
  functions.
* :func:`step_split` is the device-time split of a profiled run of
  steps (busy ms, idle share, kernels a step, buckets by kernel name,
  the top kernels) that ``chip_smoke.py`` reports for its training and
  decode steps.

The trace model (:func:`load_events`, :class:`Timeline`) is shared with
``utils/comm_accounting.py`` and ``utils/overlap.py``.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, Iterator, List, Optional

# CPU-side range categories of a torch.profiler trace, and the device
# activity categories.
CPU_RANGES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_STACKED = ("cpu_op", "user_annotation")


def newest_trace(trace_dir: str) -> str:
    """The most recent ``*.pt.trace.json`` under ``trace_dir``
    (recursive)."""
    paths = glob.glob(os.path.join(trace_dir, "**", "*.pt.trace.json"),
                      recursive=True)
    if not paths:
        raise RuntimeError(f"no torch.profiler trace under {trace_dir}")
    return max(paths, key=os.path.getmtime)


def load_events(trace) -> List[dict]:
    """The complete (``ph`` "X") events of a trace: a path to a Chrome
    trace JSON, the parsed JSON, or a list of events."""
    if isinstance(trace, str):
        with open(trace) as f:
            trace = json.load(f)
    if isinstance(trace, dict):
        trace = trace.get("traceEvents", [])
    return [e for e in trace if e.get("ph") == "X"]


def _end(ev: dict) -> float:
    return float(ev["ts"]) + float(ev.get("dur", 0.0))


class Timeline:
    """One trace's events, with each CPU range's enclosing ranges on its
    thread (``parents``: the ids of the enclosing events, outermost
    first) and each device event's launching runtime call
    (``launch``)."""

    def __init__(self, trace):
        self.events = load_events(trace)
        self.parents: Dict[int, List[int]] = {}
        threads: Dict[tuple, List[int]] = {}
        for i, ev in enumerate(self.events):
            if ev.get("cat") in CPU_RANGES:
                threads.setdefault((ev.get("pid"), ev.get("tid")),
                                   []).append(i)
        for ids in threads.values():
            ids.sort(key=lambda i: (float(self.events[i]["ts"]),
                                    -float(self.events[i].get("dur", 0))))
            open_: List[int] = []
            for i in ids:
                ts = float(self.events[i]["ts"])
                while open_ and _end(self.events[open_[-1]]) <= ts:
                    open_.pop()
                self.parents[i] = [j for j in open_
                                   if self.events[j].get("cat") in _STACKED]
                open_.append(i)
        by_corr = {}
        for i, ev in enumerate(self.events):
            if ev.get("cat") in ("cuda_runtime", "cuda_driver"):
                corr = ev.get("args", {}).get("correlation")
                if corr is not None:
                    by_corr[corr] = i
        self.device = [i for i, ev in enumerate(self.events)
                       if ev.get("cat") in DEVICE_CATS]
        self.launch = {i: by_corr.get(self.events[i].get("args", {})
                                      .get("correlation"))
                       for i in self.device}
        self._forward = None

    def name(self, i: int) -> str:
        return self.events[i].get("name", "")

    def stack(self, i: int, own: bool = False) -> List[int]:
        """The ids of the CPU ranges enclosing CPU event ``i`` (and ``i``
        itself with ``own``)."""
        return self.parents.get(i, []) + ([i] if own else [])

    def device_stack(self, i: int) -> List[int]:
        """The CPU ranges that enclosed the launch of device event
        ``i`` (empty when the launch is not in the trace, as for the
        kernels of a CUDA graph's replay)."""
        launch = self.launch.get(i)
        return [] if launch is None else self.parents.get(launch, [])

    def provenance(self, ids: List[int]) -> str:
        """``ids``' names joined by ``/``; a backward op's stack gets the
        ``transpose(<forward stack>)/`` prefix."""
        path = "/".join(self.name(j) for j in ids)
        fwd = self._forward_of(ids)
        if fwd is not None:
            path = ("transpose(" + "/".join(
                self.name(j) for j in self.stack(fwd, own=True)) + ")/"
                + path)
        return path

    def _forward_of(self, ids: List[int]) -> Optional[int]:
        if self._forward is None:
            self._forward = {}
            for i, ev in enumerate(self.events):
                args = ev.get("args", {})
                seq = args.get("Sequence number")
                if (ev.get("cat") == "cpu_op" and seq is not None
                        and "Backward" not in ev.get("name", "")
                        and "evaluate_function" not in ev.get("name", "")):
                    # Sequence numbers grow through a run: one forward op
                    # (the one that made the autograd node) has each.
                    self._forward.setdefault(seq, i)
        for j in ids:
            args = self.events[j].get("args", {})
            if ("Backward" in self.name(j)
                    and args.get("Sequence number") is not None):
                return self._forward.get(args["Sequence number"])
        return None

    def labels(self, i: int, prefix: str = "hvd.") -> List[int]:
        """The ``user_annotation`` ranges named ``prefix...`` enclosing
        CPU event ``i``, innermost first."""
        return [j for j in reversed(self.parents.get(i, []))
                if self.events[j].get("cat") == "user_annotation"
                and self.name(j).startswith(prefix)]

    def self_us(self, i: int, children: Dict[int, float]) -> float:
        return float(self.events[i].get("dur", 0.0)) - children.get(i, 0.0)


def kernel_rows(trace) -> Iterator[dict]:
    """Yield one dict per (kernel name, provenance): ``self_ms`` (total
    over the whole capture), ``tf_op_name``, ``hlo_op_name``,
    ``bound_by`` (""), ``occurrences``, ``expression`` (""). Device
    kernels (and copies) when the trace has any, else the CPU ops with
    their self time. Zero-time rows are skipped."""
    tl = trace if isinstance(trace, Timeline) else Timeline(trace)
    rows: Dict[tuple, dict] = {}

    def add(prov: str, name: str, us: float) -> None:
        if us <= 0:
            return
        row = rows.setdefault((prov, name), {
            "self_ms": 0.0, "tf_op_name": prov, "hlo_op_name": name,
            "bound_by": "", "occurrences": 0, "expression": ""})
        row["self_ms"] += us / 1e3
        row["occurrences"] += 1

    if tl.device:
        for i in tl.device:
            add(tl.provenance(tl.device_stack(i)), tl.name(i),
                float(tl.events[i].get("dur", 0.0)))
    else:
        children: Dict[int, float] = {}
        for i, parents in tl.parents.items():
            if parents and tl.events[i].get("cat") in _STACKED:
                children[parents[-1]] = (children.get(parents[-1], 0.0)
                                         + float(tl.events[i].get("dur", 0)))
        for i in sorted(tl.parents):
            if tl.events[i].get("cat") == "cpu_op":
                add(tl.provenance(tl.stack(i, own=True)), tl.name(i),
                    tl.self_us(i, children))
    yield from rows.values()


def add_to_bucket(buckets: dict, phase: str, t_ms: float, row: dict) -> None:
    b = buckets.setdefault(phase, {"ms": 0.0, "ops": 0, "top": []})
    b["ms"] += t_ms
    b["ops"] += 1
    b["top"].append((t_ms, row["hlo_op_name"], row["tf_op_name"][-90:],
                     row["bound_by"]))


def finalize_buckets(buckets: dict, top: int = 4) -> dict:
    """Round, trim each bucket's op list to the ``top`` slowest, and order
    buckets by time."""
    for b in buckets.values():
        b["top"] = [
            {"ms": round(t, 4), "op": n, "prov": p, "bound_by": bb}
            for t, n, p, bb in sorted(b["top"], reverse=True)[:top]]
        b["ms"] = round(b["ms"], 4)
    return dict(sorted(buckets.items(), key=lambda kv: -kv[1]["ms"]))


def step_split(rows, steps: int, buckets, step_ms: float,
               profiled_ms: float, listed: Optional[str] = None) -> dict:
    """Where the device time of ``steps`` profiled steps goes: ``rows``
    are :func:`kernel_rows` of their trace, ``buckets`` ``(bucket,
    test)`` pairs on the lowercased kernel name (the first that matches
    wins, the rest is ``other``). ``step_ms``: a step's wall time without
    the profiler; ``profiled_ms``: with it. Returns ``step_ms``,
    ``step_ms_profiled``, ``kernels_per_step``,
    ``device_busy_ms_per_step``, ``device_idle_share`` (of the profiled
    window), ``device_busy_over_unprofiled_step``, ``<bucket>_ms_per_step``
    for each bucket and ``other``, ``top_kernels`` ([bucket, name, ms a
    step], the 12 slowest names) and, with ``listed``, every kernel of
    that bucket as ``<listed>_kernels``."""
    split = {key: 0.0 for key, _ in buckets}
    split["other"] = 0.0
    kernels = 0
    by_name: Dict[str, list] = {}
    for row in rows:
        name = row["hlo_op_name"]
        key = next((k for k, test in buckets if test(name.lower())),
                   "other")
        split[key] += row["self_ms"]
        kernels += row["occurrences"]
        entry = by_name.setdefault(name, [0.0, key])
        entry[0] += row["self_ms"]
    busy_ms = sum(split.values()) / steps
    result = {"step_ms": step_ms, "step_ms_profiled": profiled_ms,
              "kernels_per_step": kernels / steps,
              "device_busy_ms_per_step": busy_ms,
              "device_idle_share": (1 - busy_ms / profiled_ms) if busy_ms
              else None,
              "device_busy_over_unprofiled_step": busy_ms / step_ms}
    result.update({f"{k}_ms_per_step": v / steps for k, v in split.items()})
    ranked = sorted(((ms, key, name) for name, (ms, key) in by_name.items()),
                    reverse=True)
    result["top_kernels"] = [[key, name[:90], ms / steps]
                             for ms, key, name in ranked[:12]]
    if listed:
        result[f"{listed}_kernels"] = [[name[:90], ms / steps]
                                       for ms, key, name in ranked
                                       if key == listed]
    return result
