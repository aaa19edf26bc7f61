"""The port's native ring (``horovod_tpu_torch/core``) against the JAX
package's (``horovod_tpu/core``), on the CPU.

* The half-precision accumulate and scale of the port's ``ring.cc``: the
  blocked path byte-identical to the scalar one and to IEEE RNE, as
  ``tests/test_ring_kernels.py`` holds the JAX copy.
* ``RingBackend`` on torch tensors in 2- and 3-rank rings: allreduce of
  float32 under each wire dtype (none/bf16/fp16/int8, with the int8
  residual), of every other dtype the ring carries, allgatherv and
  broadcast — each result's bytes equal to the JAX package's
  ``RingBackend`` on the same numpy inputs, and the float32 wires equal
  to the numpy transcript of ``tests/test_wire_compression.py``.
* The int8 error-feedback contract: the carried residual makes the
  T-step average of a repeated allreduce converge to the exact mean.
* A 4-rank 2x2 two-level job (a ring in each group, a ring of the group
  roots, a broadcast back; no shared-memory plane) under each cross wire
  dtype, equal to the JAX package's and to the two-level transcript.

Every rank is a process of its own (this file run as a script); the jobs
start in one module fixture, the port's and then the JAX package's, each
job with a secret of its own (a ring of another job cannot authenticate:
a mis-dialed connection fails the job loudly) and every port drawn below
the kernel's ephemeral range (where no outgoing connection can take it
between the draw and the child's bind). Each rank saves its result arrays
beside its digests, so a failing comparison names the rank, the key, the
count of differing elements and the first of them.
"""

import ctypes
import hashlib
import json
import os
import subprocess
import sys
import threading

import ml_dtypes
import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
DT_F32, DT_F16, DT_BF16 = 0, 5, 6
WIRES = ("none", "bf16", "fp16", "int8")
DTYPES = ("float64", "float16", "bfloat16", "int32", "int64", "int8",
          "uint8", "int16", "uint16", "bool")
FLAT_COUNT = 50021   # uneven segments and a partial int8 quant block
HIER_COUNT = 20021
EF_T = 48
QUANT_BLOCK = 4096  # kQuantBlock in ring.cc


def _free_port():
    """The launcher's draw: below the ephemeral range, never twice
    (imported here, so that a child rank, which runs this file, does not
    import the launcher)."""
    from horovod_tpu_torch.run import launch

    return launch._free_port()


def _input(rank, count, dtype, seed=0):
    rng = np.random.RandomState(2000 + 31 * seed + rank)
    if dtype == "bool":
        return rng.rand(count) > 0.5
    if np.dtype(dtype if dtype != "bfloat16" else "float32").kind in "iu":
        info = np.iinfo(dtype)
        return rng.randint(max(info.min, -100), min(info.max, 100),
                           count).astype(dtype)
    f = (rng.randn(count) * 3).astype(np.float32)
    return f if dtype == "bfloat16" else f.astype(dtype)


# ------------------------------------------------- the numpy transcripts
# (of tests/test_wire_compression.py; copied so that a port rank imports
# nothing of the JAX package)

def _rank_input(rank, count):
    return np.random.RandomState(1000 + rank).randn(count).astype(np.float32)


def _int8_roundtrip(a):
    """Quantize + dequantize as ring.cc's WIRE_I8: per 4096-element
    block, f32 scale amax/127, RNE with clamp, f32 dequant."""
    out = np.empty_like(a)
    for b in range(0, a.size, QUANT_BLOCK):
        blk = a[b:b + QUANT_BLOCK]
        amax = np.float32(np.max(np.abs(blk))) if blk.size else np.float32(0)
        scale = np.float32(amax / np.float32(127.0))
        if scale == 0:
            out[b:b + QUANT_BLOCK] = 0
            continue
        inv = np.float32(np.float32(1.0) / scale)
        v = np.clip(blk * inv, np.float32(-127.0), np.float32(127.0))
        out[b:b + QUANT_BLOCK] = np.rint(v).astype(np.int8).astype(
            np.float32) * scale
    return out


def _wire_roundtrip(a, wire):
    if wire == "bf16":
        return a.astype(ml_dtypes.bfloat16).astype(np.float32)
    if wire == "fp16":
        return a.astype(np.float16).astype(np.float32)
    if wire == "int8":
        return _int8_roundtrip(a)
    return a


def _simulate_ring(xs, wire):
    """ring.cc's schedule: segment s starts at rank s, each hop adds the
    receiver's contribution to the wire-roundtripped partial in f32, and
    the owner roundtrips once more before the allgather relays it."""
    size, count = len(xs), xs[0].size
    base_len, rem = divmod(count, size)

    def seg(s):
        off = s * base_len + min(s, rem)
        return slice(off, off + base_len + (1 if s < rem else 0))

    out = np.empty(count, np.float32)
    for s in range(size):
        v = xs[s][seg(s)].copy()
        for t in range(1, size):
            v = xs[(s + t) % size][seg(s)] + _wire_roundtrip(v, wire)
        out[seg(s)] = _wire_roundtrip(v, wire)
    return out


def _simulate_two_level(xs, cross_wire):
    """2x2: exact local sums (one addition each), the cross ring's
    schedule over the two group sums, a verbatim local broadcast."""
    return _simulate_ring([xs[0] + xs[1], xs[2] + xs[3]], cross_wire)


# ------------------------------------------------------------ child ranks

class _Port:
    """The port's ring on torch tensors."""

    def __init__(self):
        import torch

        from horovod_tpu_torch.core import bindings

        self.torch, self.bindings = torch, bindings

    def tensor(self, a, dtype):
        t = self.torch.from_numpy(np.array(a, copy=True))
        return t.to(self.torch.bfloat16) if dtype == "bfloat16" else t

    def zeros(self, n):
        return self.torch.zeros(n, dtype=self.torch.float32)

    def digest(self, t):
        raw = t.contiguous().view(-1).view(self.torch.uint8).numpy()
        return hashlib.sha256(raw.tobytes()).hexdigest()

    def numpy(self, t):
        if t.dtype == self.torch.bfloat16:
            return t.view(self.torch.uint16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()


class _Jax:
    """The JAX package's ring on numpy arrays."""

    def __init__(self):
        from horovod_tpu.core import bindings

        self.bindings = bindings

    def tensor(self, a, dtype):
        return np.array(a, dtype=ml_dtypes.bfloat16 if dtype == "bfloat16"
                        else a.dtype, copy=True)

    def zeros(self, n):
        return np.zeros(n, np.float32)

    def digest(self, a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    def numpy(self, a):
        return a


class _Results(dict):
    """A rank's results: each array's sha256 under its key, the array
    itself saved beside (``<dir>/rank<r>.<key>.npy``) for the parent's
    element-wise diagnosis."""

    def __init__(self, P, rank):
        super().__init__()
        self.P, self.rank = P, rank
        self.dir = os.environ["HVD_TEST_SAVE_DIR"]

    def put(self, key, t):
        self[key] = self.P.digest(t)
        np.save(os.path.join(self.dir, f"rank{self.rank}.{key}.npy"),
                _savable(self.P.numpy(t)))


def _savable(a):
    # np.save cannot name ml_dtypes' bfloat16: keep its bits.
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _secret(role):
    """This job's secret for one of its rings."""
    return f"{os.environ['HVD_TEST_JOB']}:{role}".encode()


def _child_flat(pkg, rank, size, addrs):
    P = _Port() if pkg == "port" else _Jax()
    ring = P.bindings.RingBackend(rank, size, addrs, _secret("flat"))
    P.bindings.set_chunk_bytes(64 * 1024)  # several chunks a segment
    out = _Results(P, rank)
    x = _rank_input(rank, FLAT_COUNT)
    for wire in WIRES:
        buf = P.tensor(x, "float32")
        residual = P.zeros(FLAT_COUNT) if wire == "int8" else None
        ring.allreduce_(buf, False, wire_dtype=P.bindings.WIRE_DTYPE_CODES[
            wire], residual=residual)
        out.put(f"f32.{wire}", buf)
        if residual is not None:
            out.put("f32.int8.residual", residual)
    for dt in DTYPES:
        buf = P.tensor(_input(rank, 4099, dt), dt)
        ring.allreduce_(buf, False)
        out.put(dt, buf)
    counts = [3 + 7 * r for r in range(size)]
    for dt in ("float32", "int32", "bfloat16"):
        mine = P.tensor(_input(rank, counts[rank], dt, seed=1), dt)
        out.put(f"allgather.{dt}", ring.allgather(mine, counts))
    for dt, root in (("float32", size - 1), ("bfloat16", 0)):
        buf = P.tensor(_input(rank, 1001, dt, seed=2), dt)
        ring.broadcast_(buf, root)
        out.put(f"broadcast.{dt}", buf)
    if pkg == "port":
        out.update(_ef_contract(P, ring, size))
    ring.shutdown()
    return dict(out)


def _ef_contract(P, ring, size):
    """The telescoping contract of tests/test_wire_compression.py, on the
    port's ring: carrying the residual into the next round makes the
    T-step average converge to the exact mean."""
    torch = P.torch
    count = 3 * QUANT_BLOCK + 117
    g = torch.from_numpy(
        np.random.RandomState(42).randn(count).astype(np.float32))
    gmax = float(g.abs().max())

    def run(feedback):
        residual = P.zeros(count)
        acc = torch.zeros(count, dtype=torch.float64)
        first = None
        for _ in range(EF_T):
            x = g + residual if feedback else g.clone()
            ring.allreduce_(x, False, wire_dtype=3, residual=residual)
            y = x / size
            if first is None:
                first = float((y - g).abs().max()) / gmax
            acc += y
        return float((acc / EF_T - g).abs().max()) / gmax, first, residual

    ef_err, single_err, residual = run(True)
    noef_err, _, _ = run(False)
    return {"ef_rel_err": ef_err, "noef_rel_err": noef_err,
            "single_rel_err": single_err,
            "residual_max": float(residual.abs().max()),
            "quant_step_bound": 2.0 * gmax / 127.0}


def _child_hier(pkg, rank, size, addrs):
    P = _Port() if pkg == "port" else _Jax()
    group, local = rank // 2, rank % 2
    local_ring = P.bindings.RingBackend(
        local, 2, os.environ["HVD_TEST_LOCAL_ADDRS"].split(";")[group],
        _secret(f"local{group}"))
    local_ring.set_link("local")
    cross = None
    if local == 0:
        cross = P.bindings.RingBackend(
            group, 2, os.environ["HVD_TEST_CROSS_ADDRS"], _secret("cross"))
        cross.set_link("cross")
    x = _rank_input(rank, HIER_COUNT)
    out = _Results(P, rank)
    for wire in WIRES:
        buf = P.tensor(x, "float32")
        residual = P.zeros(HIER_COUNT) if wire == "int8" else None
        local_ring.allreduce_(buf, False)
        if cross is not None:
            cross.allreduce_(buf, False, wire_dtype=P.bindings.
                             WIRE_DTYPE_CODES[wire], residual=residual)
        local_ring.broadcast_(buf, 0)
        out.put(wire, buf)
    if cross is not None:
        cross.shutdown()
    local_ring.shutdown()
    return dict(out)


def _child_main(argv):
    pkg, scenario, rank, size, addrs = argv
    fn = _child_flat if scenario == "flat" else _child_hier
    out = fn(pkg, int(rank), int(size), addrs)
    print("RESULT " + json.dumps(out), flush=True)


# ------------------------------------------------------------------ jobs

def _start(pkg, scenario, size, save_dir, env=None):
    addrs = ",".join(f"127.0.0.1:{_free_port()}" for _ in range(size))
    child_env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + HERE,
                     OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
                     HVD_TEST_SAVE_DIR=str(save_dir),
                     HVD_TEST_JOB=f"{pkg}-{scenario}-{size}", **(env or {}))
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), pkg, scenario,
         str(rank), str(size), addrs],
        cwd=REPO, env=child_env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(size)]


def _collect(key, procs, timeout=240):
    outs = []
    for proc in procs:
        try:
            outs.append(proc.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise AssertionError(f"{key}: a rank hung")
    results = []
    for rank, (proc, out) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0, f"{key} rank {rank}:\n{out}"
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert lines, f"{key} rank {rank}: no RESULT in\n{out}"
        results.append(json.loads(lines[-1][len("RESULT "):]))
    return results


class _Jobs(dict):
    """(pkg, scenario, size) -> each rank's results; ``dirs`` holds where
    each job's ranks saved their arrays."""

    def array(self, job, rank, key):
        a = np.load(os.path.join(self.dirs[job], f"rank{rank}.{key}.npy"))
        return a.view(ml_dtypes.bfloat16) if "bfloat16" in key else a


def _hier_env():
    return {"HVD_TEST_LOCAL_ADDRS": ";".join(
                ",".join(f"127.0.0.1:{_free_port()}" for _ in range(2))
                for _ in range(2)),
            "HVD_TEST_CROSS_ADDRS": ",".join(
                f"127.0.0.1:{_free_port()}" for _ in range(2))}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ring")
    out, dirs = _Jobs(), {}
    # One package's three jobs (9 ranks) at a time: half the processes,
    # and half the memory, of starting both packages' at once.
    for pkg in ("port", "jax"):
        started = {}
        for scenario, size in (("flat", 2), ("flat", 3), ("hier", 4)):
            key = (pkg, scenario, size)
            dirs[key] = root / f"{pkg}-{scenario}-{size}"
            dirs[key].mkdir()
            started[key] = _start(pkg, scenario, size, dirs[key],
                                  _hier_env() if scenario == "hier" else None)
        try:
            out.update((key, _collect(key, procs))
                       for key, procs in sorted(started.items()))
        finally:
            for _, procs in sorted(started.items()):
                for p in procs:
                    if p.poll() is None:
                        p.kill()
    out.dirs = dirs
    return out


def _bits(a):
    """Each element's bytes as one unsigned integer (NaN-safe, bitwise)."""
    a = np.ascontiguousarray(a).reshape(-1)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[a.dtype.itemsize])


def _diff(what, rank, key, got, want):
    """Why ``got`` is not ``want``: which comparison, the rank and key,
    how many elements differ and the first of them with both values."""
    got, want = np.asarray(got), np.asarray(want)
    head = f"{what}: rank {rank}, key {key!r}"
    if got.shape != want.shape or got.dtype != want.dtype:
        return (f"{head}: {got.dtype}{list(got.shape)} against "
                f"{want.dtype}{list(want.shape)}")
    bad = np.flatnonzero(_bits(got) != _bits(want))
    if bad.size == 0:
        return f"{head}: the arrays are equal, the digests are not"
    i = int(bad[0])
    return (f"{head}: {bad.size} of {got.size} elements differ; first at "
            f"[{i}]: {got.reshape(-1)[i]!r} against {want.reshape(-1)[i]!r}")


# ------------------------------------------------------------------ tests

@pytest.fixture(scope="module")
def lib():
    from horovod_tpu_torch.core import bindings

    lib = bindings.load()
    for fn in ("hvd_dtype_accumulate", "hvd_dtype_accumulate_scalar"):
        getattr(lib, fn).restype = None
    lib.hvd_dtype_scale.restype = None
    return lib


def _acc(lib, fn, dst, src, code):
    getattr(lib, fn)(
        dst.ctypes.data_as(ctypes.c_void_p),
        src.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_long(dst.size), ctypes.c_int(code))


HALVES = [(np.float16, DT_F16), (ml_dtypes.bfloat16, DT_BF16)]


@pytest.mark.parametrize("dtype,code", HALVES)
def test_half_accumulate_vector_scalar_and_ieee_agree(lib, dtype, code):
    import test_ring_kernels as rk

    a = rk._half_operands(dtype, seed=1)
    b = rk._half_operands(dtype, seed=2)
    d_vec = a.copy().view(np.uint16)
    d_sca = a.copy().view(np.uint16)
    s = b.view(np.uint16)
    _acc(lib, "hvd_dtype_accumulate", d_vec, s, code)
    _acc(lib, "hvd_dtype_accumulate_scalar", d_sca, s, code)
    np.testing.assert_array_equal(d_vec, d_sca)
    want = (a.astype(np.float32) + b.astype(np.float32)).astype(dtype)
    want_f = want.astype(np.float32)
    nan = np.isnan(want_f)
    np.testing.assert_array_equal(
        np.isnan(d_vec.view(dtype).astype(np.float32)), nan)
    np.testing.assert_array_equal(d_vec[~nan], want.view(np.uint16)[~nan])


@pytest.mark.parametrize("dtype,code", HALVES)
def test_half_scale_matches_ieee(lib, dtype, code):
    import test_ring_kernels as rk

    a = rk._half_operands(dtype, seed=3)
    buf = a.copy().view(np.uint16)
    lib.hvd_dtype_scale(
        buf.ctypes.data_as(ctypes.c_void_p), ctypes.c_long(buf.size),
        ctypes.c_int(code), ctypes.c_double(0.25))
    want = (a.astype(np.float32) * np.float32(0.25)).astype(dtype)
    nan = np.isnan(want.astype(np.float32))
    np.testing.assert_array_equal(
        np.isnan(buf.view(dtype).astype(np.float32)), nan)
    np.testing.assert_array_equal(buf[~nan], want.view(np.uint16)[~nan])


@pytest.mark.parametrize("size", [2, 3])
def test_ring_results_equal_the_jax_rings_bitwise(jobs, size):
    pj, jj = ("port", "flat", size), ("jax", "flat", size)
    port, ref = jobs[pj], jobs[jj]
    for rank in range(size):
        keys = sorted(ref[rank])
        assert len(keys) == len(WIRES) + 1 + len(DTYPES) + 5
        for key in keys:
            assert port[rank][key] == ref[rank][key], _diff(
                "port vs JAX", rank, key, jobs.array(pj, rank, key),
                jobs.array(jj, rank, key))
    # Every rank holds the same bytes (the residual is each rank's own).
    for key in ref[0]:
        if key != "f32.int8.residual":
            for rank in range(1, size):
                assert port[rank][key] == port[0][key], _diff(
                    "port rank vs port rank 0", rank, key,
                    jobs.array(pj, rank, key), jobs.array(pj, 0, key))


@pytest.mark.parametrize("size", [2, 3])
@pytest.mark.parametrize("wire", WIRES)
def test_ring_wires_equal_the_numpy_transcript(jobs, size, wire):
    xs = [_rank_input(r, FLAT_COUNT) for r in range(size)]
    transcript = _simulate_ring(xs, wire)
    want = hashlib.sha256(transcript.tobytes()).hexdigest()
    key, job = f"f32.{wire}", ("port", "flat", size)
    for rank, res in enumerate(jobs[job]):
        assert res[key] == want, _diff(
            "port vs transcript", rank, key, jobs.array(job, rank, key),
            transcript)


@pytest.mark.parametrize("size", [2, 3])
def test_int8_error_feedback_converges_to_exact_mean(jobs, size):
    for rank, res in enumerate(jobs[("port", "flat", size)]):
        assert res["ef_rel_err"] < 3.0 * res["single_rel_err"] / EF_T, \
            (rank, res)
        assert res["noef_rel_err"] > 10 * res["ef_rel_err"], (rank, res)
        assert res["residual_max"] <= res["quant_step_bound"], (rank, res)


@pytest.mark.parametrize("wire", WIRES)
def test_two_level_2x2_equals_jax_and_transcript(jobs, wire):
    xs = [_rank_input(r, HIER_COUNT) for r in range(4)]
    transcript = _simulate_two_level(xs, wire)
    want = hashlib.sha256(transcript.tobytes()).hexdigest()
    pj, jj = ("port", "hier", 4), ("jax", "hier", 4)
    for rank, (got, ref) in enumerate(zip(jobs[pj], jobs[jj])):
        assert got[wire] == ref[wire], _diff(
            "port vs JAX", rank, wire, jobs.array(pj, rank, wire),
            jobs.array(jj, rank, wire))
        assert ref[wire] == want, _diff(
            "JAX vs transcript", rank, wire, jobs.array(jj, rank, wire),
            transcript)


def _two_ring_ranks(secrets):
    """Rank 0 and rank 1 of one 2-rank port ring in two threads, each
    with its own secret; each rank's error, or None."""
    import torch

    from horovod_tpu_torch.core import bindings

    addrs = ",".join(f"127.0.0.1:{_free_port()}" for _ in range(2))
    errors = [None, None]

    def rank(r):
        try:
            ring = bindings.RingBackend(r, 2, addrs, secrets[r])
            buf = torch.ones(5)
            ring.allreduce_(buf, False)
            assert buf.tolist() == [2.0] * 5
            ring.shutdown()
        except Exception as exc:  # noqa: BLE001 — reported below
            errors[r] = str(exc)

    threads = [threading.Thread(target=rank, args=(r,), name=f"hvd-ring-{r}",
                                daemon=True) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    return errors


def test_a_rank_of_another_job_cannot_join_a_ring():
    """The jobs above run side by side on one host, every one with a
    secret of its own: a rank that reaches another job's ring (a port
    drawn twice, a mis-dial) fails that ring's handshake loudly instead of
    mixing the two jobs' data."""
    assert _two_ring_ranks([b"job-a:flat", b"job-a:flat"]) == [None, None]
    errors = _two_ring_ranks([b"job-a:flat", b"job-b:flat"])
    assert all(e is not None and "authentication failed" in e
               for e in errors), errors


if __name__ == "__main__":
    _child_main(sys.argv[1:])
