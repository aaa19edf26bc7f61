"""``DistributedOptimizer`` through the three paths a 2-rank job can take:
the port's controller (``horovodrun``), the port's process group
(``horovodrun --spmd``) and ``horovod_tpu.torch`` on the JAX package's
controller. A seeded torch MLP (weights and each rank's batch from numpy)
takes 3 momentum-SGD steps on each; the weights must be equal, bit for
bit: every path averages two float32 gradients, a sum that rounds once
in either order and a division by two that is exact, and the same torch
optimizer updates the same values."""

import numpy as np
import pytest

import torch_gloo

MLP_SRC = r'''
import numpy as np
import torch


def mlp_and_batch(rank):
    rng = np.random.RandomState(99)
    model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                                torch.nn.Linear(16, 4))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(
                rng.randn(*p.shape).astype(np.float32) * 0.3))
    data = np.random.RandomState(7 + rank)
    x = torch.from_numpy(data.randn(3, 6, 8).astype(np.float32))
    y = torch.from_numpy(data.randn(3, 6, 4).astype(np.float32))
    return model, x, y


def train(hvd_torch, rank):
    model, x, y = mlp_and_batch(rank)
    opt = hvd_torch.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters())
    for step in range(3):
        opt.zero_grad()
        loss = ((model(x[step]) - y[step]) ** 2).mean()
        loss.backward()
        opt.step()
    return {name: p.detach().numpy().copy()
            for name, p in sorted(model.named_parameters())}
'''

PORT_WORKER = torch_gloo.WORKER_HEAD + MLP_SRC + r'''
from horovod_tpu_torch.common import basics

hvd.init(device="cpu")
ctl = basics.controller()
weights = train(hvd, hvd.rank())
weights["tier"] = np.array(0 if ctl is None else 1)
weights["controller_tensors"] = np.array(
    0 if ctl is None else ctl.counters()["tensors"])
rank = hvd.rank()
hvd.shutdown()
np.savez(sys.argv[2] + f".rank{rank}.npz", **weights)
print("worker ok", flush=True)
'''

REFERENCE_WORKER = MLP_SRC + r'''
import sys

import horovod_tpu as hvd
import horovod_tpu.torch as thvd

hvd.init()
rank = hvd.rank()
weights = train(thvd, rank)
hvd.shutdown()
np.savez(sys.argv[2] + f".rank{rank}.npz", **weights)
print("worker ok", flush=True)
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jobs = {
        # The Python controller on the TCP star, as the JAX reference.
        "controller": torch_gloo.start_launched(
            tmp_path_factory.mktemp("ctl"), 2, PORT_WORKER, {}, {},
            env={"HOROVOD_CPU_OPS": "star"}),
        "group": torch_gloo.start_launched(
            tmp_path_factory.mktemp("pg"), 2, PORT_WORKER, {}, {},
            launcher_args=("--spmd",)),
        "jax": torch_gloo.start_reference(
            tmp_path_factory.mktemp("jax"), 2, REFERENCE_WORKER, {}, {}),
    }
    try:
        return {name: job.wait()[0] for name, job in sorted(jobs.items())}
    finally:
        for _, job in sorted(jobs.items()):
            job.kill()


def test_each_mode_takes_its_tier(runs):
    for rank in range(2):
        assert int(runs["controller"][rank]["tier"]) == 1
        # 4 parameters a step, 3 steps, all through the controller.
        assert int(runs["controller"][rank]["controller_tensors"]) == 12
        assert int(runs["group"][rank]["tier"]) == 0


@pytest.mark.parametrize("path", ["group", "jax"])
def test_three_steps_equal_weights(runs, path):
    for rank in range(2):
        got = runs["controller"][rank]
        want = runs[path][rank]
        names = sorted(k for k in want if "." in k)
        assert len(names) == 4
        for name in names:
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=f"{path} rank {rank} "
                                                  f"{name}")
    # The ranks agree with each other, and training moved the weights.
    scope = {}
    exec(MLP_SRC, scope)
    start = dict(scope["mlp_and_batch"](0)[0].named_parameters())
    for name in names:
        np.testing.assert_array_equal(runs["controller"][0][name],
                                      runs["controller"][1][name])
        assert not np.array_equal(runs["controller"][0][name],
                                  start[name].detach().numpy())
