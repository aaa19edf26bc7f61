"""Elastic-restore probe — the port's counterpart of
``examples/elastic_restore_probe.py``.

Measures ``hvd.elastic.State.restore()`` on a real 3-rank elastic job
(the Python controller on the TCP star) at two model sizes ``--factor``
apart, under both restore paths:

* ``p2p`` (the default): rank 0 publishes its commit's per-shard digests;
  every survivor's commit matches, so no model byte crosses the wire:
  two small object collectives and one copy on the device;
* ``broadcast`` (``HOROVOD_ELASTIC_RESTORE=broadcast``): rank 0
  re-broadcasts the whole committed state through the star.

The state is 8 float32 tensors of equal share on ``--device`` (the card
by default; ``cpu`` for a run without one), the same on every rank, as a
lockstep-trained model is. A restore's time is the slowest rank's;
each cell is the median of ``--reps``. The last line of standard output
is the JSON summary::

    python -m horovod_tpu_torch.examples.elastic_restore_probe \\
        --small-mib 16 --factor 4 --reps 5
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(args) -> None:
    import torch

    import horovod_tpu_torch as hvd

    hvd.init(device=args.device)
    dev = hvd.device()
    sizes_mib = [args.small_mib, args.small_mib * args.factor]
    record = {"sizes_mib": sizes_mib, "ranks": hvd.size(),
              "device": str(dev), "modes": {}}
    for mode in ("p2p", "broadcast"):
        record["modes"][mode] = {}
        os.environ["HOROVOD_ELASTIC_RESTORE"] = mode
        for size_mib in sizes_mib:
            n = int(size_mib * (1 << 20) / 4 / 8)
            params = {f"w{i}": torch.full((n,), float(i), device=dev)
                      for i in range(8)}
            state = hvd.elastic.State(step=0, params=params)
            state.restore()  # warm-up: installs the exchange
            reps, moved = [], 0
            for _ in range(args.reps):
                t0 = time.perf_counter()
                state.restore()
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                reps.append(time.perf_counter() - t0)
                moved = state.last_restore["fetched_bytes"]
            ranks = hvd.allgather_object((reps, moved),
                                         name=f"probe.{mode}.{size_mib}")
            worst = [max(vals) for vals in zip(*(r for r, _ in ranks))]
            record["modes"][mode][str(size_mib)] = {
                "median_s": float(np.median(worst)), "reps": args.reps,
                "bytes_moved": [m for _, m in ranks]}
            state.close()
            del state, params
    os.environ["HOROVOD_ELASTIC_RESTORE"] = "p2p"
    if hvd.rank() == 0:
        small, big = (str(s) for s in sizes_mib)
        for _, m in sorted(record["modes"].items()):
            m["ratio"] = m[big]["median_s"] / m[small]["median_s"]
        print("PROBE_RESULT " + json.dumps(record), flush=True)
    hvd.shutdown()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ranks", type=int, default=3)
    parser.add_argument("--small-mib", type=float, default=16.0)
    parser.add_argument("--factor", type=int, default=4)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--device", default=None,
                        help="every rank's device (default cuda:0: the "
                             "ranks share one card)")
    parser.add_argument("--timeout", type=float, default=300.0)
    parser.add_argument("--child", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.device is None:
        args.device = "cuda:0"
    if args.child:
        _child(args)
        return 0
    addr = f"127.0.0.1:{_free_port()}"
    procs = []
    for rank in range(args.ranks):
        env = {k: v for k, v in sorted(os.environ.items())
               if not k.startswith(("HOROVOD_", "OMPI_", "PMI_"))}
        env.update({
            "PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", ""),
            "HOROVOD_RANK": str(rank), "HOROVOD_SIZE": str(args.ranks),
            "HOROVOD_LOCAL_RANK": "0", "HOROVOD_LOCAL_SIZE": "1",
            "HOROVOD_CONTROLLER_ADDR": addr, "HOROVOD_ENGINE": "python",
            "HOROVOD_ELASTIC": "1", "HOROVOD_CYCLE_TIME": "1",
        })
        procs.append(subprocess.Popen(
            [sys.executable, "-m",
             "horovod_tpu_torch.examples.elastic_restore_probe", "--child",
             "--ranks", str(args.ranks), "--small-mib", str(args.small_mib),
             "--factor", str(args.factor), "--reps", str(args.reps),
             "--device", args.device], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + args.timeout
    outputs = []
    for rank, proc in enumerate(procs):
        try:
            out, _ = proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.wait()
            raise SystemExit(f"probe: rank {rank} hung")
        outputs.append(out)
        if proc.returncode != 0:
            sys.stderr.write(out)
            raise SystemExit(f"probe: rank {rank} failed "
                             f"(exit {proc.returncode})")
    record = None
    for line in outputs[0].splitlines():
        if line.startswith("PROBE_RESULT "):
            record = json.loads(line.split(" ", 1)[1])
    if record is None:
        sys.stderr.write(outputs[0])
        raise SystemExit("probe: rank 0 printed no result")
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
