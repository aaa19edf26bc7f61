"""The port's package root against the JAX package's: every name
``horovod_tpu/__init__.py`` binds is on ``horovod_tpu_torch`` after
``init``, except an explicit list of JAX-only names and of names whose
modules are later slices (ROADMAP Queue 1, "No counterpart needed" and
item 8.7, since landed). ``mpi_threads_supported``, ``wait``, ``serving`` and
``trace`` behave as the JAX root's; ``trace`` carries the JAX package's
whole ``__all__``; ``HOROVOD_AUTOTUNE`` reaches the port's ``Config``
and ``horovodrun --trace`` is accepted."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# No counterpart needed: the traced tier and its helpers, covered by
# process groups, ``--spmd`` and DistributedOptimizer.
JAX_ONLY = {"compat", "set_default_spmd_axis", "distributed_value_and_grad"}
# Later slices: none (the profiler, 8.7, has landed).
LATER = set()


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
    "trace_all": sorted(hvd.trace.__all__),
    "profiler_all": sorted(hvd.profiler.__all__),
    "bucket": hvd.BucketScheduler().bucket_bytes,
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
    from horovod_tpu import trace as jtrace
    from horovod_tpu.common import profiler as jprofiler

    assert got == {"missing": [], "threads": True, "wait": [1.0, 1.0],
                   "serving": True, "trace": True,
                   "trace_all": sorted(jtrace.__all__),
                   "profiler_all": sorted(jprofiler.__all__),
                   "bucket": 8 << 20}


@pytest.mark.parametrize("value,want", [("1", True), ("yes", True),
                                        ("0", False), ("", False)])
def test_autotune_env_reaches_the_port_config(monkeypatch, value, want):
    from horovod_tpu.common.config import Config as JaxConfig

    from horovod_tpu_torch.common.config import Config

    monkeypatch.setenv("HOROVOD_AUTOTUNE", value)
    monkeypatch.setenv("HOROVOD_AUTOTUNE_LOG", "/tmp/at.csv")
    monkeypatch.setenv("HOROVOD_TRACE_DIR", "/tmp/tr")
    cfg = Config.from_env()
    assert (cfg.autotune, cfg.autotune_log, cfg.trace_dir) == \
        (want, "/tmp/at.csv", "/tmp/tr")
    assert cfg.autotune == JaxConfig.from_env().autotune


def test_horovodrun_accepts_trace(tmp_path):
    """``--trace DIR`` is taken and exported: a one-rank job's worker sees
    ``HOROVOD_TRACE_DIR``, and the launcher names the artifacts."""
    out = tmp_path / "tr"
    script = ("import os; print('trace dir', "
              "os.environ['HOROVOD_TRACE_DIR'])")
    env = dict(os.environ, PYTHONPATH=REPO)
    for var in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_CONTROLLER_ADDR",
                "HOROVOD_TRACE_DIR"):
        env.pop(var, None)
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", "1",
         "--trace", str(out), sys.executable, "-c", script],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert f"trace dir {out}" in proc.stdout
    assert "not supported" not in proc.stderr
    assert out.is_dir()
    assert f"no per-rank traces under {out}" in proc.stderr
