"""The tuning and tracing loop across real ranks, on the CPU: 2- and
3-rank jobs under the port's ``horovodrun`` on both engines (the native
engine, the launcher's default, and ``HOROVOD_ENGINE=python``), beside
the same steps through the JAX package's ``BucketScheduler`` under its
own launcher.

Every job runs ``STEPS`` steps of named gradient-like tensors through a
``BucketScheduler`` (the gradients drawn on a grid of quarters, so every
sum is exact in any order and any fusion grouping). The port's jobs run
with ``HOROVOD_AUTOTUNE=1`` and ``horovodrun --trace``, and once more
with neither. The tests hold that:

* rank 0 scored configurations (the autotune CSV) and every rank adopted
  the same tuned bucket size: on the Python controller the same values
  at the same point of the collective stream (the responses executed
  when the reply carrying it arrived); on the native engine, whose
  telemetry thread polls the engine's reply slot, the same final value;
* tuned results equal the untuned job's and the JAX job's, bit for bit;
* ``--trace`` wrote ``merged_trace.json`` (spans only of the fixed phase
  vocabulary, at least 20 collectives whose sequence id every rank
  carries), ``clock_offsets.json`` (every rank synced, each offset
  within its uncertainty plus 1 ms, the ranks sharing one host clock)
  and ``straggler_report.json``.

The overlap probe (``examples/overlap_probe.py``) runs its 2-rank job
on CPU tensors on both engines: the bucketed results equal the
unbucketed ones on every rank, and the measured and predicted overlap
are fractions.

No wall-clock speed bound is checked. The jobs start three at a time.
"""

import csv
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import torch_gloo

STEPS = 60
SIZES = [2, 3]
ENGINES = {"native": {}, "python": {"HOROVOD_ENGINE": "python"}}
JOB_SECONDS = 240

GRADS_SRC = '''
import time

import numpy as np

STEPS = 60


def make_grads(rank):
    """(name, float32 array) in production order: values on a grid of
    quarters, so every sum is exact."""
    rng = np.random.RandomState(77 + rank)
    sizes = (3000, 17, 40000, 256, 9000, 1, 65536, 1200, 5000, 333, 20000,
             64)
    return [(f"layer{i:02d}.grad", (rng.randint(-64, 64, n) / 4.0)
             .astype(np.float32)) for i, n in enumerate(sizes)]


def run_steps(make_scheduler, to_tensor, from_result, out, buckets):
    """STEPS steps of the gradients through a fresh scheduler each; the
    results of three steps saved, the bucket size of each step noted."""
    rank_grads = make_grads(RANK)
    for step in range(STEPS):
        sched = make_scheduler()
        buckets.append(int(sched.bucket_bytes))
        sched.backward_started()
        for name, g in rank_grads:
            sched.grad_ready(name, to_tensor(g * (step % 5 + 1)))
            time.sleep(0.0005)
        results, report = sched.finish()
        if step in (0, STEPS // 2, STEPS - 1):
            for name, value in sorted(results.items()):
                out[f"s{step}/{name}"] = from_result(value)
'''

PORT_WORKER = torch_gloo.WORKER_HEAD + GRADS_SRC + r'''
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.controller import bucket_scheduler as bs


def main():
    global RANK
    hvd.init(device="cpu")
    RANK = hvd.rank()
    ctl = basics.controller()
    adopted = []
    set_tuned = bs.set_autotuned_bucket_bytes

    def spy(nbytes):
        # Where in the collective stream the value arrived: the responses
        # this rank executed so far (the same on every rank at a reply).
        adopted.append([int(nbytes), int(ctl.counters()["responses"])])
        set_tuned(nbytes)

    bs.set_autotuned_bucket_bytes = spy
    out, buckets = {}, []
    run_steps(lambda: bs.BucketScheduler(average=False),
              lambda a: torch.from_numpy(a), lambda v: v.numpy(), out,
              buckets)
    hvd.shutdown()
    notes = {"engine": type(ctl).__name__, "adopted": adopted,
             "buckets": buckets, "final": bs.current_bucket_bytes()}
    out["notes"] = np.frombuffer(json.dumps(notes).encode(), np.uint8)
    np.savez(sys.argv[2] + f".rank{RANK}.npz", **out)
    print("worker ok", flush=True)


main()
'''

REFERENCE_WORKER = GRADS_SRC + r'''
import sys

import horovod_tpu as hvd
from horovod_tpu.controller.bucket_scheduler import BucketScheduler


def main():
    global RANK
    hvd.init()
    RANK = hvd.rank()
    out, buckets = {}, []
    run_steps(lambda: BucketScheduler(average=False), lambda a: a,
              np.asarray, out, buckets)
    hvd.shutdown()
    np.savez(sys.argv[2] + f".rank{RANK}.npz", **out)
    print("worker ok", flush=True)


main()
'''


def _start(tmp_path_factory, key):
    kind, size = key[0], key[-1]
    base = tmp_path_factory.mktemp("-".join(map(str, key)))
    env = {"HOROVOD_CYCLE_TIME": "1"}
    if kind == "jax":
        script, inp, out = torch_gloo._prepare(base, REFERENCE_WORKER, {}, {})
        proc = subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu.run", "-np", str(size),
             sys.executable, script, inp, out], cwd=torch_gloo.REPO,
            env=torch_gloo._clean_env(dict(env, JAX_PLATFORMS="cpu")),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return torch_gloo.Job([proc], out, size, JOB_SECONDS), base
    engine, tuned = key[1], key[2] == "tuned"
    env.update(ENGINES[engine])
    args = ()
    if tuned:
        env.update(HOROVOD_AUTOTUNE="1",
                   HOROVOD_AUTOTUNE_LOG=str(base / "autotune.csv"))
        args = ("--trace", str(base / "trace"))
    job = torch_gloo.start_launched(base, size, PORT_WORKER, {}, {},
                                    launcher_args=args, env=env,
                                    timeout=JOB_SECONDS)
    return job, base


KEYS = [key for size in SIZES for key in (
    ("port", "native", "tuned", size), ("port", "python", "tuned", size),
    ("port", "native", "plain", size), ("jax", size))]


def _outcome(key, job, base):
    try:
        return job.wait()[0], base
    except AssertionError as exc:
        return f"job {key} failed: {exc}", base


# The JAX package's launcher draws its ring ports by binding to port 0,
# from the range where any process's outgoing connection may take one
# before the rank binds it; such a job is started once more.
_PORT_TAKEN = "Address already in use"


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Every job's ranks (or the text of its failure) and directory, run
    three at a time."""
    out = {}
    for i in range(0, len(KEYS), 3):
        batch = KEYS[i:i + 3]
        started = {key: _start(tmp_path_factory, key) for key in batch}
        try:
            for key in batch:
                out[key] = _outcome(key, *started[key])
                if key[0] == "jax" and isinstance(out[key][0], str) \
                        and _PORT_TAKEN in out[key][0]:
                    started[key] = _start(tmp_path_factory, key)
                    out[key] = _outcome(key, *started[key])
        finally:
            for key in batch:
                started[key][0].kill()
    return out


def _ranks(jobs, key):
    ranks, base = jobs[key]
    if isinstance(ranks, str):
        raise AssertionError(ranks)
    return ranks, base


def _notes(ranks):
    return [json.loads(r["notes"].tobytes()) for r in ranks]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_every_rank_adopts_the_same_tuned_bucket(jobs, engine, size):
    ranks, base = _ranks(jobs, ("port", engine, "tuned", size))
    notes = _notes(ranks)
    assert {n["engine"] for n in notes} == {
        "NativeController" if engine == "native" else "Controller"}
    with open(base / "autotune.csv") as f:
        rows = [r for r in csv.DictReader(
            line for line in f if not line.startswith("#"))]
    assert len(rows) >= 2, rows
    assert all(float(r["score_bytes_per_sec"]) > 0 for r in rows)
    finals = {n["final"] for n in notes}
    assert len(finals) == 1, finals
    assert finals != {8 << 20}
    if engine == "python":
        # The same values, at the same point of the collective stream.
        assert notes[0]["adopted"], notes[0]
        assert all(n["adopted"] == notes[0]["adopted"] for n in notes)
    else:
        assert all(n["adopted"] and n["adopted"][-1][0] == notes[0]["final"]
                   for n in notes)
    # The schedulers picked the adopted sizes up.
    assert all(set(n["buckets"]) - {8 << 20} for n in notes)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("job", ["native-tuned", "python-tuned",
                                 "native-plain"])
def test_results_equal_the_untuned_and_the_jax_jobs(jobs, job, size):
    engine, mode = job.split("-")
    port, _ = _ranks(jobs, ("port", engine, mode, size))
    ref, _ = _ranks(jobs, ("jax", size))
    for rank in range(size):
        keys = sorted(k for k in ref[rank] if k.startswith("s"))
        assert len(keys) == 36
        assert sorted(k for k in port[rank] if k.startswith("s")) == keys
        for key in keys:
            assert port[rank][key].dtype == ref[rank][key].dtype, key
            np.testing.assert_array_equal(port[rank][key], ref[rank][key],
                                          err_msg=key)
        # And across ranks: one sum.
        np.testing.assert_array_equal(port[rank]["s0/layer00.grad"],
                                      port[0]["s0/layer00.grad"])


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_trace_is_merged_with_clock_and_report(jobs, engine, size):
    _, base = _ranks(jobs, ("port", engine, "tuned", size))
    trace = base / "trace"
    with open(trace / "merged_trace.json") as f:
        events = json.load(f)
    with open(trace / "clock_offsets.json") as f:
        clock = json.load(f)
    with open(trace / "straggler_report.json") as f:
        report = json.load(f)
    spans = [e for e in events if e.get("ph") == "X"]
    assert {e["name"] for e in spans} == {"enqueue", "negotiate", "fuse",
                                          "execute", "done"}
    ranks_of = {}
    for e in spans:
        seq = e["args"].get("seq")
        if seq is not None:
            ranks_of.setdefault(seq, set()).add(e["pid"])
    correlated = [s for s, r in sorted(ranks_of.items())
                  if r == set(range(size))]
    assert len(correlated) >= 20, len(correlated)
    assert sorted(clock) == [str(r) for r in range(size)]
    for r in range(1, size):
        entry = clock[str(r)]
        assert entry["synced"] and entry["samples"] >= 1, entry
        # One host, one wall clock: the offset is the estimate's error.
        assert abs(entry["offset_seconds"]) <= \
            entry["uncertainty_seconds"] + 1e-3, entry
    assert report["ranks"] == list(range(size))
    assert report["collectives"] >= 1
    assert sorted(report["per_rank"]) == [str(r) for r in range(size)]
    for r in range(size):
        assert os.path.exists(trace / f"trace.rank{r}.json")


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_overlap_probe_on_cpu_tensors(engine):
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.examples.overlap_probe",
         "--device", "cpu", "--engine", engine, "--tensors", "6",
         "--tensor-mib", "0.25", "--compute-ms", "5", "--bucket-mib",
         "0.5", "--steps", "2", "--timeout", str(JOB_SECONDS)],
        cwd=torch_gloo.REPO, env=torch_gloo._clean_env(),
        capture_output=True, text=True, timeout=JOB_SECONDS + 30)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["bit_identical"] is True
    assert summary["engine"] == ("NativeController" if engine == "native"
                                 else "Controller")
    assert summary["pipeline"] == (engine == "native")
    assert summary["buckets"] == 3
    for key in ("overlap_efficiency", "model_predicted_overlap_efficiency"):
        assert 0.0 <= summary[key] <= 1.0, summary
    split = summary["stall_split"]
    assert split["buckets"] == 3 and 0.0 <= split["negotiation_frac"] <= 1.0
