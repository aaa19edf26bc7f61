"""Gloo jobs on the CPU for the port's tests: ``run_job`` starts
``size`` worker processes of a script with the launcher environment
(``HOROVOD_RANK``/``SIZE`` and a ``FileStore`` rendezvous under
``tmp_path``), each under one timeout, and returns every rank's output
arrays. A worker reads its cases from ``argv[1]`` (an ``.npz`` of
inputs beside a ``.json`` of specs), writes ``<argv[2]>.rank<r>.npz``
and prints ``worker ok``."""

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_VARS = ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
               "HOROVOD_LOCAL_SIZE", "HOROVOD_CROSS_RANK",
               "HOROVOD_CROSS_SIZE", "OMPI_COMM_WORLD_RANK",
               "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_LOCAL_RANK",
               "OMPI_COMM_WORLD_LOCAL_SIZE", "PMI_RANK", "PMI_SIZE",
               "HOROVOD_CONTROLLER_ADDR", "HOROVOD_RENDEZVOUS_FILE")


def run_job(tmp_path, size, worker_src, inputs, specs, timeout=240):
    """Run ``worker_src`` on ``size`` gloo ranks over ``inputs`` (name ->
    array) and ``specs`` (JSON-able); returns a list, per rank, of dicts
    of the arrays it wrote."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    script = tmp_path / "worker.py"
    script.write_text(worker_src)
    np.savez(tmp_path / "inputs.npz", **inputs)
    (tmp_path / "inputs.json").write_text(json.dumps(specs))
    out = tmp_path / "out"
    procs = []
    for rank in range(size):
        env = {k: v for k, v in sorted(os.environ.items())
               if k not in LAUNCH_VARS}
        env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                   HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
                   HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE=str(size),
                   HOROVOD_RENDEZVOUS_FILE=str(tmp_path / "store"))
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(tmp_path / "inputs"),
             str(out)], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outputs = []
    try:
        for proc in procs:
            outputs.append(proc.communicate(timeout=timeout)[0])
    finally:
        for proc in procs:
            proc.kill()
    for rank, (proc, text) in enumerate(zip(procs, outputs)):
        assert proc.returncode == 0 and "worker ok" in text, (
            f"rank {rank} exited {proc.returncode}:\n{text[-6000:]}")
    return [dict(np.load(f"{out}.rank{r}.npz")) for r in range(size)]


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
