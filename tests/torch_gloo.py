"""Multi-rank jobs on the CPU for the port's tests: ``run_job`` starts
``size`` worker processes of a script with the launcher environment
(``HOROVOD_RANK``/``SIZE`` and a ``FileStore`` rendezvous under
``tmp_path``), each under one timeout, and returns every rank's output
arrays. A worker reads its cases from ``argv[1]`` (an ``.npz`` of
inputs beside a ``.json`` of specs), writes ``<argv[2]>.rank<r>.npz``
and prints ``worker ok``.

``start_launched`` runs the same kind of worker under the port's
``horovodrun`` (``python -m horovod_tpu_torch.run``: the controller and
the gloo group, or ``--spmd``), and ``start_reference`` under the JAX
package's Python controller (ranks spawned with its environment, the
TCP star data plane); both return a :class:`Job` whose ``wait()`` gives
the ranks' arrays.

``monitor_env`` puts a job of either package under both runtime
monitors (``HOROVOD_PROTOCHECK``, ``HOROVOD_LOCKCHECK``) with per-rank
artifacts in one directory, and ``assert_monitored`` holds what the job
left there: every protocol report clean, every lock graph acyclic, at
least the required number of each (a rank killed by SIGKILL writes
none), and every runtime lock edge inside its package's static graph."""

import importlib
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_VARS = ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
               "HOROVOD_LOCAL_SIZE", "HOROVOD_CROSS_RANK",
               "HOROVOD_CROSS_SIZE", "OMPI_COMM_WORLD_RANK",
               "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_LOCAL_RANK",
               "OMPI_COMM_WORLD_LOCAL_SIZE", "PMI_RANK", "PMI_SIZE",
               "HOROVOD_CONTROLLER_ADDR", "HOROVOD_SPMD_COORDINATOR",
               "HOROVOD_RENDEZVOUS_FILE")


def run_job(tmp_path, size, worker_src, inputs, specs, timeout=240):
    """Run ``worker_src`` on ``size`` gloo ranks over ``inputs`` (name ->
    array) and ``specs`` (JSON-able); returns a list, per rank, of dicts
    of the arrays it wrote."""
    script, inp, out = _prepare(tmp_path, worker_src, inputs, specs)
    procs = []
    for rank in range(size):
        env = _clean_env(dict(
            HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
            HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE=str(size),
            HOROVOD_RENDEZVOUS_FILE=str(tmp_path / "store")))
        procs.append(subprocess.Popen(
            [sys.executable, script, inp, out], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return Job(procs, out, size, timeout).wait()[0]


def _prepare(tmp_path, worker_src, inputs, specs):
    tmp_path.mkdir(parents=True, exist_ok=True)
    script = tmp_path / "worker.py"
    script.write_text(worker_src)
    np.savez(tmp_path / "inputs.npz", **inputs)
    (tmp_path / "inputs.json").write_text(json.dumps(specs))
    return [str(script), str(tmp_path / "inputs"), str(tmp_path / "out")]


def _clean_env(extra=None):
    env = {k: v for k, v in sorted(os.environ.items())
           if k not in LAUNCH_VARS}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.update(extra or {})
    return env


def free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class Job:
    """Processes of one job; ``wait()`` joins them under one deadline,
    kills what is left, and returns every rank's arrays (or, with
    ``check=False``, the exit codes and outputs for the caller to
    judge)."""

    def __init__(self, procs, out, size, timeout):
        self.procs, self.out, self.size = procs, out, size
        self.deadline = time.monotonic() + timeout

    def finish(self):
        outputs = []
        for proc in self.procs:
            left = max(1.0, self.deadline - time.monotonic())
            try:
                outputs.append(proc.communicate(timeout=left)[0])
            except subprocess.TimeoutExpired:
                for other in self.procs:
                    if other.poll() is None:
                        other.kill()
                outputs.append(proc.communicate()[0] + "\n[timed out]")
        return [p.returncode for p in self.procs], outputs

    def kill(self):
        """End whatever still runs (a launcher takes its ranks along)."""
        for proc in self.procs:
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()

    def wait(self):
        codes, outputs = self.finish()
        text = "\n".join(outputs)
        assert codes == [0] * len(codes), (
            f"exit codes {codes}:\n{text[-8000:]}")
        assert text.count("worker ok") == self.size, text[-8000:]
        return [dict(np.load(f"{self.out}.rank{r}.npz"))
                for r in range(self.size)], text


def monitor_env(out_dir):
    """Environment that puts a job (either package's: they read the same
    knobs) under the protocol monitor and the lock-order detector, with
    per-rank artifacts in ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    return {"HOROVOD_PROTOCHECK": "1",
            "HOROVOD_PROTOCHECK_OUTPUT":
                os.path.join(str(out_dir), "protocheck.json"),
            "HOROVOD_LOCKCHECK": "1",
            "HOROVOD_LOCKCHECK_OUTPUT":
                os.path.join(str(out_dir), "lockgraph.json")}


_STATIC_EDGES = {}


def static_lock_edges(pkg):
    """The edges of ``pkg``'s static lock graph ("port" or "jax"),
    computed once per process."""
    if pkg not in _STATIC_EDGES:
        name = "horovod_tpu_torch" if pkg == "port" else "horovod_tpu"
        lockorder = importlib.import_module(name + ".analysis.lockorder")
        _STATIC_EDGES[pkg] = {(e["from"], e["to"])
                              for e in lockorder.static_graph()["edges"]}
    return _STATIC_EDGES[pkg]


def _artifacts(out_dir, prefix):
    reports = {}
    for name in sorted(os.listdir(out_dir)):
        if name.startswith(prefix) and ".tmp" not in name:
            with open(os.path.join(out_dir, name)) as f:
                reports[name] = json.load(f)
    return reports


def assert_monitored(out_dir, pkg, require, context=""):
    """Hold a monitored job's artifacts in ``out_dir``: every protocol
    report ``ok``, every lock graph acyclic, at least ``require`` of each
    (the ranks known to exit normally), and every runtime lock edge in
    ``pkg``'s static graph. Returns the transitions, artifact counts and
    runtime lock edges."""
    protocol = _artifacts(str(out_dir), "protocheck.json")
    locks = _artifacts(str(out_dir), "lockgraph.json")
    for name, report in sorted(protocol.items()):
        assert report["ok"], (
            f"{context}: protocol violations in {name}: "
            f"{report['violations']}")
    for name, report in sorted(locks.items()):
        assert report["acyclic"], (
            f"{context}: lock-order cycles in {name}: {report['cycles']}")
    assert len(protocol) >= require and len(locks) >= require, (
        f"{context}: {len(protocol)} protocol and {len(locks)} lock "
        f"artifacts in {out_dir}, expected at least {require} of each")
    runtime = {(e["from"], e["to"]) for _, report in sorted(locks.items())
               for e in report["edges"]}
    missing = sorted(runtime - static_lock_edges(pkg))
    assert not missing, (
        f"{context}: runtime lock edges missing from the {pkg} static "
        f"graph: {missing}")
    return {"transitions": sum(r["transitions"]
                               for _, r in sorted(protocol.items())),
            "protocol_artifacts": len(protocol),
            "lock_artifacts": len(locks), "lock_edges": sorted(runtime)}


def start_launched(tmp_path, size, worker_src, inputs, specs,
                   launcher_args=(), env=None, timeout=240):
    """``worker_src`` on ``size`` ranks started by the port's
    ``horovodrun`` (one launcher process; its output holds every rank's,
    prefixed)."""
    script, inp, out = _prepare(tmp_path, worker_src, inputs, specs)
    cmd = [sys.executable, "-m", "horovod_tpu_torch.run", "-np", str(size),
           *launcher_args, sys.executable, script, inp, out]
    proc = subprocess.Popen(cmd, cwd=REPO, env=_clean_env(env),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return Job([proc], out, size, timeout)


def start_reference(tmp_path, size, worker_src, inputs, specs, env=None,
                    timeout=240):
    """``worker_src`` on ``size`` ranks of the JAX package's Python
    controller over the TCP star (no native engine, no ring)."""
    script, inp, out = _prepare(tmp_path, worker_src, inputs, specs)
    addr = f"127.0.0.1:{free_port()}"
    procs = []
    for rank in range(size):
        rank_env = _clean_env(env)
        rank_env.update(
            JAX_PLATFORMS="cpu", HOROVOD_RANK=str(rank),
            HOROVOD_SIZE=str(size), HOROVOD_LOCAL_RANK=str(rank),
            HOROVOD_LOCAL_SIZE=str(size), HOROVOD_CONTROLLER_ADDR=addr,
            HOROVOD_ENGINE="python", HOROVOD_CPU_OPS="star",
            HOROVOD_CYCLE_TIME="1")
        procs.append(subprocess.Popen(
            [sys.executable, script, inp, out], cwd=REPO, env=rank_env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return Job(procs, out, size, timeout)


WORKER_HEAD = '''
import json
import sys

import numpy as np
import torch

import horovod_tpu_torch as hvd


def load_cases():
    arrays = dict(np.load(sys.argv[1] + ".npz"))
    with open(sys.argv[1] + ".json") as f:
        specs = json.load(f)
    return arrays, specs


def tree_of(arrays, prefix):
    """The nested dict of the arrays under ``prefix`` (``a/b/c`` keys)."""
    tree = {}
    for key, value in arrays.items():
        if key.startswith(prefix):
            node = tree
            *path, leaf = key[len(prefix):].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = value
    return tree


def flatten(tree, prefix=""):
    """(``a/b/c`` key, leaf) of a nested dict, sorted."""
    for key, value in sorted(tree.items()):
        if isinstance(value, dict):
            yield from flatten(value, prefix + key + "/")
        else:
            yield prefix + key, value


def save(results):
    np.savez(sys.argv[2] + f".rank{hvd.rank()}.npz", **{
        k: (v.detach().cpu().numpy() if torch.is_tensor(v) else
            np.asarray(v)) for k, v in results.items()})
'''
