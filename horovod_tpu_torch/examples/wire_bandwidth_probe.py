"""Wire-compression allreduce bandwidth probe — the port's counterpart of
``examples/wire_bandwidth_probe.py``. Host only: no card is used.

Spawns a real N-rank TCP ring over the port's C ABI (``core/bindings``:
``RingBackend`` on the handle ABI, no controller, just the data plane)
on this host and measures effective allreduce bus bandwidth for each
wire dtype x transfer-chunk size x message size:

    effective = 2 (n-1)/n * payload / median step time

(``utils/comm_accounting.ring_allreduce_bytes``). The bf16/int8 rows
ship half/quarter the bytes per hop; on loopback the "wire" is a kernel
memcpy on the cores that also compress, so the probe understates what a
real NIC would gain. The int8 rows carry a live error-feedback residual:
the measured path is the production one (quantize + residual capture).

``--hierarchical`` probes the two-level data plane on a 4-rank 2x2
(local x cross) layout instead: a local ring inside each simulated node,
a cross ring of the node roots, and the flat 4-ring whose node-crossing
edges are the same slow links. Loopback has no slow hop, so the
cross-node links are emulated with the ring's token-bucket send cap
(``RingBackend.set_rate``, ``hvd_ringh_set_rate``; ``--cross-gbps``,
default 0.2 Gbit/s), applied to the hierarchical cross ring and to the
flat ring's two node-crossing edges alike. The per-link wire counters
(``hvd_ring_get_wire_stats_link``) show the cross hop carrying int8
bytes while the local hop stays float32.

    python -m horovod_tpu_torch.examples.wire_bandwidth_probe \\
        [--ranks 2] [--sizes-mib 4,16,64] [--hierarchical] [--out PATH]

One JSON line per row from rank 0, then the summary as the last line;
``--out`` writes the record too.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import socket
import subprocess
import sys
import time
from typing import List, Optional

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--sizes-mib", default="4,16,64")
    p.add_argument("--wire", default="none,bf16,int8")
    p.add_argument("--chunks-kib", default="256,1024")
    p.add_argument("--reps", type=int, default=7)
    p.add_argument("--out", default=None, help="record JSON path")
    p.add_argument("--hierarchical", action="store_true",
                   help="probe the two-level plane on a 4-rank 2x2 layout")
    p.add_argument("--cross-gbps", type=float, default=0.2,
                   help="emulated cross-node link rate (Gbit/s, send cap "
                        "per connection; --hierarchical only)")
    p.add_argument("--child", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--addrs", default=None, help=argparse.SUPPRESS)
    p.add_argument("--local-addrs", default=None, help=argparse.SUPPRESS)
    p.add_argument("--cross-addrs", default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def _payload(mib: int) -> torch.Tensor:
    n = mib * (1 << 20) // 4
    return torch.from_numpy(np.random.RandomState(0).randn(n).astype(
        np.float32))


def _median(times) -> float:
    return sorted(times)[len(times) // 2]


def child_main(args) -> None:
    from horovod_tpu_torch.core import bindings

    rank, size = args.child, args.ranks
    ring = bindings.RingBackend(rank, size, args.addrs, b"wire-bandwidth")
    rows = []
    for mib in [int(s) for s in args.sizes_mib.split(",")]:
        base = _payload(mib)
        for wire in args.wire.split(","):
            code = bindings.WIRE_DTYPE_CODES[wire]
            residual = (torch.zeros_like(base) if wire == "int8" else None)
            for chunk_kib in [int(c) for c in args.chunks_kib.split(",")]:
                bindings.set_chunk_bytes(chunk_kib << 10)
                buf = base.clone()
                # Warm-up: connection ramp + scratch allocation.
                ring.allreduce_(buf, False, wire_dtype=code,
                                residual=residual)
                times = []
                for _ in range(args.reps):
                    t0 = time.perf_counter()
                    ring.allreduce_(buf, False, wire_dtype=code,
                                    residual=residual)
                    times.append(time.perf_counter() - t0)
                median = _median(times)
                alg_bytes = 2 * (size - 1) / size * buf.numel() * 4
                rows.append({
                    "payload_mib": mib, "wire": wire,
                    "chunk_kib": chunk_kib,
                    "effective_GB_s": round(alg_bytes / median / 1e9, 3),
                    "step_ms": round(median * 1e3, 2),
                })
    if rank == 0:
        print("WIREBW " + json.dumps({"rows": rows,
                                      "wire_stats": bindings.wire_stats()}),
              flush=True)
    ring.shutdown()


def _link_delta(before, after, link):
    row_b, row_a = before["by_link"][link], after["by_link"][link]
    return {dtype: row_a["tx_bytes"][dtype] - row_b["tx_bytes"][dtype]
            for dtype in row_a["tx_bytes"]}


def child_hier_main(args) -> None:
    """One of 4 ranks on the 2x2 layout: group = rank // 2 (simulated
    node), local = rank % 2, roots = local 0. Modes per payload:
    flat/none, flat/int8, hier/none, hier/int8-on-cross — each a sum
    over all 4 ranks, so their rows compare."""
    from horovod_tpu_torch.core import bindings

    rank, size = args.child, 4
    group, local = rank // 2, rank % 2
    rate = args.cross_gbps * 1e9 / 8.0
    flat = bindings.RingBackend(rank, size, args.addrs, b"wire-bandwidth")
    if rank in (1, 3):
        # The flat ring's node-crossing edges (1->2 and 3->0): the same
        # emulated fabric as the hierarchical cross ring below.
        flat.set_rate(rate)
    local_ring = bindings.RingBackend(
        local, 2, args.local_addrs.split(";")[group], b"wire-bandwidth")
    local_ring.set_link("local")
    cross = None
    if local == 0:
        cross = bindings.RingBackend(group, 2, args.cross_addrs,
                                     b"wire-bandwidth")
        cross.set_link("cross")
        cross.set_rate(rate)

    def hier_allreduce(buf, wire_code, residual):
        local_ring.allreduce_(buf, False)
        if cross is not None:
            cross.allreduce_(buf, False, wire_dtype=wire_code,
                             residual=residual)
        local_ring.broadcast_(buf, 0)

    rows, proofs = [], {}
    for mib in [int(s) for s in args.sizes_mib.split(",")]:
        base = _payload(mib)
        for mode, wire in (("flat", "none"), ("flat", "int8"),
                           ("hier", "none"), ("hier", "int8")):
            code = bindings.WIRE_DTYPE_CODES[wire]
            residual = (torch.zeros_like(base) if wire == "int8" else None)
            buf = base.clone()
            if mode == "flat":
                def run():
                    flat.allreduce_(buf, False, wire_dtype=code,
                                    residual=residual)
            else:
                def run():
                    hier_allreduce(buf, code, residual)
            run()  # warm-up: connections + scratch
            before = bindings.wire_stats()
            times = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                run()
                times.append(time.perf_counter() - t0)
            after = bindings.wire_stats()
            median = _median(times)
            alg_bytes = 2 * (size - 1) / size * buf.numel() * 4
            rows.append({
                "payload_mib": mib, "mode": mode, "wire": wire,
                "effective_GB_s": round(alg_bytes / median / 1e9, 3),
                "step_ms": round(median * 1e3, 2),
            })
            if rank == 0 and mode == "hier":
                # What this mode put on each hop (rank 0 is a local
                # member and a root).
                proofs[f"{mib}mib_{wire}"] = {
                    "local_tx_delta": _link_delta(before, after, "local"),
                    "cross_tx_delta": _link_delta(before, after, "cross"),
                }
    if rank == 0:
        print("WIREBW " + json.dumps({
            "rows": rows, "link_proofs": proofs,
            "wire_stats": bindings.wire_stats()}), flush=True)
    if cross is not None:
        cross.shutdown()
    local_ring.shutdown()
    flat.shutdown()


def _write(path: Optional[str], record: dict) -> None:
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(record, f, indent=1)
        print(f"wrote {path}", file=sys.stderr)


def main(argv: Optional[List[str]] = None) -> dict:
    args = _parse_args(argv)
    if args.child is not None:
        if args.hierarchical:
            child_hier_main(args)
        else:
            child_main(args)
        return {}
    # Build once in the parent so the children do not race the compiler.
    from horovod_tpu_torch.core import bindings

    bindings.load()
    if args.hierarchical:
        args.ranks = 4  # the 2x2 layout is the probe's whole point
    addrs = ",".join(f"127.0.0.1:{_free_port()}" for _ in range(args.ranks))
    passthrough = ["--ranks", str(args.ranks), "--sizes-mib", args.sizes_mib,
                   "--wire", args.wire, "--chunks-kib", args.chunks_kib,
                   "--reps", str(args.reps)]
    if args.hierarchical:
        local_addrs = ";".join(
            ",".join(f"127.0.0.1:{_free_port()}" for _ in range(2))
            for _ in range(2))
        cross_addrs = ",".join(f"127.0.0.1:{_free_port()}" for _ in range(2))
        passthrough += ["--hierarchical", "--cross-gbps",
                        str(args.cross_gbps), "--local-addrs", local_addrs,
                        "--cross-addrs", cross_addrs]
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.examples."
         "wire_bandwidth_probe", "--child", str(r), "--addrs", addrs]
        + passthrough, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for r in range(args.ranks)]
    outs = []
    for r, proc in enumerate(procs):
        try:
            out, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.wait()
            raise SystemExit(f"rank {r} hung")
        outs.append(out)
    for r, (proc, out) in enumerate(zip(procs, outs)):
        if proc.returncode != 0:
            sys.stderr.write(out)
            raise SystemExit(f"rank {r} failed (exit {proc.returncode})")
    payload = None
    for line in outs[0].splitlines():
        if line.startswith("WIREBW "):
            payload = json.loads(line[len("WIREBW "):])
    if payload is None:
        sys.stderr.write(outs[0])
        raise SystemExit("rank 0 produced no WIREBW record")
    rows = payload["rows"]
    for row in rows:
        print(json.dumps(row), flush=True)
    substrate = {"transport": "loopback TCP (127.0.0.1), shared cores",
                 "host": platform.platform(), "cpus": os.cpu_count()}
    if args.hierarchical:
        summary = _hier_summary(args, rows, payload)
        substrate["transport"] += ("; cross-node links emulated by the "
                                   "ring's send-side token bucket")
    else:
        summary = _flat_summary(args, rows, payload)
    _write(args.out, {
        "what": ("allreduce bus bandwidth of the port's native TCP ring "
                 "by wire dtype, chunk and payload: 2(n-1)/n * payload / "
                 f"median step time over {args.reps} reps"),
        "cmd": "python -m horovod_tpu_torch.examples.wire_bandwidth_probe "
               + " ".join(a for a in passthrough),
        "substrate": substrate, **summary})
    print(json.dumps(summary), flush=True)
    return summary


def _flat_summary(args, rows, payload) -> dict:
    """Best chunk per (size, wire) — what a converged tuner delivers —
    and the speed-ups over the uncompressed path at each size."""
    best = {}
    for row in rows:
        key = (row["payload_mib"], row["wire"])
        if key not in best or row["effective_GB_s"] > best[key][
                "effective_GB_s"]:
            best[key] = row
    speedups = {}
    for (mib, wire), row in sorted(best.items()):
        none_row = best.get((mib, "none"))
        if wire != "none" and none_row:
            speedups[f"{wire}_x_at_{mib}mib"] = round(
                row["effective_GB_s"] / none_row["effective_GB_s"], 3)
    return {
        "ranks": args.ranks,
        "rows": rows,
        "best_by_size_and_wire": {
            f"{mib}mib_{wire}": row for (mib, wire), row in
            sorted(best.items())},
        "speedup_vs_none_at_best_chunk": speedups,
        "wire_stats_rank0": payload["wire_stats"],
    }


def _hier_summary(args, rows, payload) -> dict:
    """The 2x2 probe's speed-ups of the cross-compressed hierarchical
    path over the uncompressed one and over the compressed flat ring on
    the same emulated fabric, with the per-link byte proofs."""
    by_key = {(r["payload_mib"], r["mode"], r["wire"]): r for r in rows}
    speedups = {}
    for mib in sorted({r["payload_mib"] for r in rows}):
        hier_i8 = by_key.get((mib, "hier", "int8"))
        for label, other in (("hier_none", (mib, "hier", "none")),
                             ("flat_int8", (mib, "flat", "int8")),
                             ("flat_none", (mib, "flat", "none"))):
            if hier_i8 and other in by_key:
                speedups[f"hier_int8_vs_{label}_at_{mib}mib"] = round(
                    hier_i8["effective_GB_s"]
                    / by_key[other]["effective_GB_s"], 3)
    return {
        "ranks": args.ranks,
        "layout": "2x2 (2 simulated nodes x 2 local ranks)",
        "cross_gbps_emulated": args.cross_gbps,
        "rows": rows,
        "speedups": speedups,
        "link_proofs": payload["link_proofs"],
        "wire_stats_rank0": payload["wire_stats"],
    }


if __name__ == "__main__":
    main()
