"""The port's ``reducescatter``, ``alltoall``, ``broadcast_object`` and
``allgather_object`` (``horovod_tpu_torch.torch.mpi_ops``), with the
semantics of ``horovod_tpu/ops/collective_ops.py`` and the controller's
composed forms.

At size 1 each is held against the JAX package's own result at size 1,
in-process. The rest runs as one 2-rank gloo job on the CPU (worker
processes with ``HOROVOD_RANK``/``HOROVOD_SIZE`` and a ``FileStore``
rendezvous under ``tmp_path``, under its own timeout): reducescatter
sum and average over even and uneven first dims (``np.array_split``
blocks), alltoall with equal and unequal per-rank blocks and its
backward, the same ``ValueError`` on every rank for an indivisible
first dim, both object collectives, and the scalar refusals.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu_torch as thvd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_VARS = ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
               "HOROVOD_LOCAL_SIZE", "HOROVOD_CROSS_RANK",
               "HOROVOD_CROSS_SIZE", "OMPI_COMM_WORLD_RANK",
               "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_LOCAL_RANK",
               "OMPI_COMM_WORLD_LOCAL_SIZE", "PMI_RANK", "PMI_SIZE",
               "HOROVOD_CONTROLLER_ADDR", "HOROVOD_SPMD_COORDINATOR",
               "HOROVOD_RENDEZVOUS_FILE")


@pytest.fixture
def size_one(monkeypatch):
    for name in LAUNCH_VARS:
        monkeypatch.delenv(name, raising=False)
    jhvd.init()
    thvd.init(device="cpu")
    yield
    thvd.shutdown()


def test_size_one_matches_the_jax_package(size_one):
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    t = torch.from_numpy(x.copy())
    for got, want in ((thvd.reducescatter(t), jhvd.reducescatter(x)),
                      (thvd.reducescatter(t, op=thvd.Sum),
                       jhvd.reducescatter(x, op=jhvd.Sum)),
                      (thvd.alltoall(t), jhvd.alltoall(x))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.data_ptr() != t.data_ptr()
    obj = {"a": [1, 2.5, "x"], "b": (None, True)}
    assert thvd.broadcast_object(obj) == jhvd.broadcast_object(obj) == obj
    assert thvd.broadcast_object(obj) is not obj
    assert thvd.allgather_object(obj) == jhvd.allgather_object(obj) == [obj]
    with pytest.raises(ValueError, match="out of range"):
        thvd.broadcast_object(obj, root_rank=1)
    # The gradient passes through the size-1 copies.
    leaf = t.clone().requires_grad_()
    (thvd.alltoall(leaf).sum() + thvd.reducescatter(leaf).sum()).backward()
    assert torch.equal(leaf.grad, torch.full_like(t, 2.0))


def test_scalars_are_refused_at_any_size(size_one):
    for op in ("reducescatter", "alltoall"):
        with pytest.raises(ValueError, match="at least one dimension"):
            getattr(thvd, op)(torch.tensor(1.0))
        with pytest.raises(ValueError, match="at least one dimension"):
            getattr(jhvd, op)(np.float32(1.0))
    with pytest.raises(ValueError, match="not both"):
        thvd.reducescatter(torch.ones(2), average=True, op=thvd.Sum)


WORKER = '''
import torch

import horovod_tpu_torch as hvd


def main():
    r = hvd.rank()
    # reducescatter: even, then uneven dims (rank 0 gets the larger block)
    x = torch.arange(8, dtype=torch.float32).reshape(4, 2) + 100 * r
    base = torch.arange(8, dtype=torch.float32).reshape(4, 2)
    got = hvd.reducescatter(x, op=hvd.Sum)
    assert torch.equal(got, (2 * base + 100)[2 * r:2 * r + 2]), got
    got = hvd.reducescatter(x)
    assert torch.equal(got, (base + 50)[2 * r:2 * r + 2]), got
    y = torch.arange(5, dtype=torch.float32) + 10 * r
    want = (2 * torch.arange(5, dtype=torch.float32) + 10)
    got = hvd.reducescatter(y, average=False)
    assert torch.equal(got, want[:3] if r == 0 else want[3:]), got
    got = hvd.reducescatter(y)
    assert torch.equal(got, (want / 2)[:3] if r == 0 else (want / 2)[3:])
    # reducescatter backward: every input row gets its block's cotangent
    leaf = y.clone().requires_grad_()
    (hvd.reducescatter(leaf, op=hvd.Sum) * (r + 1)).sum().backward()
    assert torch.equal(leaf.grad, torch.tensor([1., 1., 1., 2., 2.])), \\
        leaf.grad
    # alltoall, equal blocks: rank r gets block r of every rank
    a = torch.arange(4, dtype=torch.float32) + 10 * r
    got = hvd.alltoall(a)
    want = torch.tensor([0., 1., 10., 11.]) if r == 0 else \\
        torch.tensor([2., 3., 12., 13.])
    assert torch.equal(got, want), got
    # the MoE exchange's equal-block path (no agreement round) agrees,
    # and so does its backward
    from horovod_tpu_torch.torch.mpi_ops import _alltoall_equal
    leaf = a.clone().requires_grad_()
    out = _alltoall_equal(leaf, None)
    assert torch.equal(out, want), out
    (out * torch.arange(1, 5)).sum().backward()
    # block j of this rank went to rank j's rows 2r, 2r + 1
    assert torch.equal(leaf.grad, torch.tensor([1., 2., 1., 2.]) + 2 * r), \\
        leaf.grad
    # unequal blocks: rank 0 sends 1 row per rank, rank 1 sends 2
    b = torch.arange(2 + 2 * r, dtype=torch.float32)[:, None] + 10 * r
    got = hvd.alltoall(b)
    want = [[0.], [10.], [11.]] if r == 0 else [[1.], [12.], [13.]]
    assert torch.equal(got, torch.tensor(want)), got
    # backward: the inverse exchange
    leaf = b.clone().requires_grad_()
    out = hvd.alltoall(leaf)
    (out * torch.arange(1, out.shape[0] + 1)[:, None]).sum().backward()
    want = [[1.], [1.]] if r == 0 else [[2.], [3.], [2.], [3.]]
    assert torch.equal(leaf.grad, torch.tensor(want)), leaf.grad
    # an indivisible dim on one rank raises the same error on both
    bad = torch.zeros(3 if r == 1 else 2)
    try:
        hvd.alltoall(bad)
        raise AssertionError("indivisible alltoall did not raise")
    except ValueError as exc:
        assert "rank 1 has dim 0 = 3" in str(exc), exc
    for op in (hvd.reducescatter, hvd.alltoall):
        try:
            op(torch.tensor(1.0))
            raise AssertionError("scalar did not raise")
        except ValueError as exc:
            assert "at least one dimension" in str(exc)
    # object collectives
    obj = {"rank": r, "payload": list(range(3 + 40 * r))}
    got = hvd.broadcast_object(obj if r == 1 else None, root_rank=1)
    assert got == {"rank": 1, "payload": list(range(43))}, got
    got = hvd.allgather_object(obj)
    assert got == [{"rank": 0, "payload": [0, 1, 2]},
                   {"rank": 1, "payload": list(range(43))}], got
    assert hvd.allgather_object("x" * r) == ["", "x"]


if __name__ == "__main__":
    hvd.init(device="cpu")
    assert hvd.size() == 2
    main()
    hvd.shutdown()
    print("worker ok")
'''


def test_two_rank_gloo_collectives_more(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    procs = []
    for rank in range(2):
        env = {k: v for k, v in sorted(os.environ.items())
               if k not in LAUNCH_VARS}
        env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                   HOROVOD_RANK=str(rank), HOROVOD_SIZE="2",
                   HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE="2",
                   HOROVOD_RENDEZVOUS_FILE=str(tmp_path / "store"))
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outputs = []
    try:
        for proc in procs:
            outputs.append(proc.communicate(timeout=90)[0])
    finally:
        for proc in procs:
            proc.kill()
    for rank, (proc, text) in enumerate(zip(procs, outputs)):
        assert proc.returncode == 0 and "worker ok" in text, (
            f"rank {rank} exited {proc.returncode}:\n{text}")
