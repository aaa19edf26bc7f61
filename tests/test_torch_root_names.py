"""The port's package root against the JAX package's: every name
``horovod_tpu/__init__.py`` binds is on ``horovod_tpu_torch`` after
``init``, except an explicit list of JAX-only names and of names whose
modules are later slices (ROADMAP Queue 1, "No counterpart needed" and
items 8.3, 8.6 and 8.7). ``mpi_threads_supported``, ``wait``,
``serving`` and ``trace`` behave as the JAX root's."""

import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# No counterpart needed: the traced tier and its helpers, covered by
# process groups, ``--spmd`` and DistributedOptimizer.
JAX_ONLY = {"compat", "set_default_spmd_axis", "distributed_value_and_grad"}
# Later slices: the bucket scheduler (8.3), the doctor (8.6), the
# profiler (8.7).
LATER = {"BucketScheduler", "partition_buckets", "plan_from_compiled",
         "doctor", "profiler"}


def _jax_root_names():
    with open(os.path.join(REPO, "horovod_tpu", "__init__.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return names


CHECK = r'''
import json, sys
import torch
import horovod_tpu_torch as hvd

names = json.loads(sys.argv[1])
hvd.init(device="cpu")
missing = sorted(n for n in names if not hasattr(hvd, n))
handle = hvd.allreduce_async(torch.ones(2), name="w")
print(json.dumps({
    "missing": missing,
    "threads": hvd.mpi_threads_supported(),
    "wait": hvd.wait(handle).tolist(),
    "serving": callable(hvd.serving.stats),
    "trace": hasattr(hvd.trace, "TraceWriter"),
}))
hvd.shutdown()
'''


def test_port_root_has_the_jax_roots_names():
    import json

    names = _jax_root_names()
    assert {"mpi_threads_supported", "wait", "serving", "trace"} <= names
    assert (JAX_ONLY | LATER) <= names
    want = sorted(names - JAX_ONLY - LATER)
    env = dict(os.environ, PYTHONPATH=REPO)
    for var in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_CONTROLLER_ADDR"):
        env.pop(var, None)
    proc = subprocess.run([sys.executable, "-c", CHECK, json.dumps(want)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"missing": [], "threads": True, "wait": [1.0, 1.0],
                   "serving": True, "trace": True}
