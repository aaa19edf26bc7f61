"""The port's remaining training and generation examples on the CPU:
``examples/vit_training.py`` at ``VIT_TINY`` with both attention paths,
``examples/mnist.py`` on its synthetic data, and
``examples/llama_generation.py --model moe-tiny`` (the JAX example's MoE
choice, ``MoeLM`` through the same ``generate()``), and the sharded-state
examples: ``llama_fsdp_training`` on 2 gloo ranks, ``imagenet_resnet50``
killed after a checkpoint and resumed, and ``fsdp_hbm_budget`` against
the JAX example's table. Each prints the JAX example's line. (``examples/moe_lm_training.py`` runs in
``tests/test_torch_moe_lm.py``, ``examples/moe_training.py`` on 4 gloo
ranks in ``tests/test_torch_moe.py``.)
"""

import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu_torch.examples import llama_generation, mnist, vit_training
from horovod_tpu_torch.models import llama as tllama
from horovod_tpu_torch.models.moe_lm import MOE_TINY, MoeLM
from horovod_tpu_torch.ops import attention as tattn


@pytest.fixture
def port_state():
    thvd.init(device="cpu")             # main()'s init() then keeps it
    yield
    thvd.shutdown()


@pytest.mark.parametrize("attention", ["xla", "flash"])
def test_vit_example_runs_and_reports(port_state, capsys, attention,
                                      monkeypatch):
    calls = []
    flash = tattn.flash_attention
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a, **k: calls.append(1) or flash(*a, **k))
    out = vit_training.main(["--model", "tiny", "--batch-per-chip", "4",
                             "--steps", "3", "--warmup-steps", "1",
                             "--steps-per-call", "2",
                             "--attention", attention])
    # 1 warm-up call + 2 timed calls, 2 optimizer steps each.
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert out["losses"][-1] < out["losses"][0]
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("vit-tiny 32px: ") and "img/sec (" in line
    # Two layers, forward only through the seam (the backward is the
    # Function's): 2 per step, 6 steps.
    assert len(calls) == (12 if attention == "flash" else 0)


def test_vit_example_warmup_schedule_is_optax_linear():
    from horovod_tpu_torch.models.vit import VIT_TINY, VisionTransformer

    args = vit_training.parse_args(["--base-lr", "1e-3", "--warmup-steps",
                                    "2", "--steps-per-call", "2"])
    model = VisionTransformer(VIT_TINY, device="cpu")
    thvd.init(device="cpu")
    try:
        opt, schedule = vit_training.make_optimizer(model, args, 1)
        lrs = []
        for _ in range(6):
            lrs.append(opt.param_groups[0]["lr"])
            schedule.step()
    finally:
        thvd.shutdown()
    # optax.linear_schedule(1e-4, 1e-3, 4) at counts 0..5.
    np.testing.assert_allclose(lrs, [1e-4, 3.25e-4, 5.5e-4, 7.75e-4, 1e-3,
                                     1e-3], rtol=1e-6)


def test_mnist_example_learns_the_synthetic_blobs(port_state, capsys):
    out = mnist.main(["--epochs", "2", "--batch-size", "256"])
    assert len(out["losses"]) == 2 and out["losses"][1] < out["losses"][0]
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["epoch 0", "epoch 1"]
    x, y = mnist.synthetic_mnist()
    with torch.no_grad():
        pred = out["model"](torch.from_numpy(x[:512])).argmax(-1).numpy()
    assert (pred == y[:512]).mean() > 0.9


def test_generation_example_runs_moe_tiny(capsys):
    out = llama_generation.main(["--model", "moe-tiny", "--prompt-len", "8",
                                 "--max-new-tokens", "5", "--batch-size",
                                 "2", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("moe-tiny prompt=8 b=2: ")
    assert "decode tokens/sec" in line
    prompt = torch.from_numpy(np.random.RandomState(0).randint(
        0, MOE_TINY.vocab_size, (2, 8)))
    want = tllama.generate(MoeLM(MOE_TINY, device="cpu", seed=0), prompt,
                           max_new_tokens=5)
    assert torch.equal(out["out"], want)


# ---------------------------------------------------------------------------
# The sharded-state examples

FSDP_WORKER = """
import contextlib
import io
import sys

import numpy as np

import horovod_tpu_torch as hvd
from horovod_tpu_torch.examples import llama_fsdp_training as ex

out = io.StringIO()
with contextlib.redirect_stdout(out):
    rec = ex.main(["--model", "tiny", "--seq-len", "32",
                   "--batch-per-shard", "2", "--num-iters", "4",
                   "--device", "cpu"])
np.savez(sys.argv[2] + f".rank{hvd.rank()}.npz",
         losses=np.array(rec["losses"]), line=np.array(out.getvalue()))
hvd.shutdown()
print("worker ok")
"""


def test_llama_fsdp_training_example_on_two_ranks(tmp_path):
    from torch_gloo import run_job

    ranks = run_job(tmp_path, 2, FSDP_WORKER, {}, {})
    line = str(ranks[0]["line"]).strip().splitlines()[-1]
    assert line.startswith("fsdp llama-tiny dp=2 tp=1 seq=32: ")
    assert "tokens/sec, loss=" in line and line.endswith(
        "param shard fraction=1/2")
    assert str(ranks[1]["line"]) == ""         # rank 0 prints
    for rank in ranks:
        losses = rank["losses"]
        assert np.isfinite(losses).all() and losses[-1] < losses[0]


class _Killed(Exception):
    pass


def test_imagenet_example_resumes_after_a_kill(port_state, tmp_path,
                                               monkeypatch, capsys):
    """Killed after its step-2 save and run again, the example resumes
    there and ends with the parameters and BatchNorm statistics of one
    uninterrupted run."""
    from horovod_tpu_torch.examples import imagenet_resnet50 as ex

    # One intra-op thread: ResNet-50's many small CPU convolutions run as
    # fast on one, and a shared CPU (parallel test workers) oversubscribed
    # by every process's thread pool slows them dozens of times.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    args = ["--image-size", "32", "--batch-per-chip", "2", "--steps", "4",
            "--checkpoint-every", "2", "--warmup-steps", "1"]
    try:
        _kill_and_resume(ex, args, tmp_path, monkeypatch, capsys)
    finally:
        torch.set_num_threads(threads)


def _kill_and_resume(ex, args, tmp_path, monkeypatch, capsys):
    whole = ex.main(args + ["--checkpoint-dir", str(tmp_path / "a")])
    save = ex.save_checkpoint

    def killed_after_step_2(path, tree):
        save(path, tree)
        if path.endswith("ckpt_2"):
            raise _Killed

    monkeypatch.setattr(ex, "save_checkpoint", killed_after_step_2)
    with pytest.raises(_Killed):
        ex.main(args + ["--checkpoint-dir", str(tmp_path / "b")])
    monkeypatch.setattr(ex, "save_checkpoint", save)
    resumed = ex.main(args + ["--checkpoint-dir", str(tmp_path / "b")])
    assert resumed["start_step"] == 2 and len(resumed["losses"]) == 2
    assert "resumed from" in capsys.readouterr().out
    assert resumed["losses"] == whole["losses"][2:]
    for (name, a), (_, b) in zip(
            sorted(whole["model"].state_dict().items()),
            sorted(resumed["model"].state_dict().items())):
        assert torch.equal(a, b), name


def test_imagenet_example_schedule_is_optax_join():
    from horovod_tpu_torch.examples.imagenet_resnet50 import learning_rate

    import optax

    peak = 0.05
    sched = optax.join_schedules(
        [optax.linear_schedule(peak / 10, peak, 3),
         optax.cosine_decay_schedule(peak, 10)], [3])
    np.testing.assert_allclose([learning_rate(s, peak, 3, 10)
                                for s in range(16)],
                               [float(sched(s)) for s in range(16)],
                               rtol=1e-6, atol=1e-9)


def test_fsdp_hbm_budget_matches_the_jax_table(capsys):
    """The same per-rank bytes as the JAX example's ``budget()`` (Adam:
    torch keeps a 4-byte ``step`` per parameter where optax keeps one
    count), the same printed figures, and nothing written under
    ``artifacts/``."""
    import importlib.util
    import os

    from horovod_tpu_torch.examples import fsdp_hbm_budget as port

    import optax

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "jax_fsdp_hbm_budget", os.path.join(repo, "examples",
                                            "fsdp_hbm_budget.py"))
    jax_ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_ex)
    artifacts = os.path.join(repo, "artifacts")
    before = {n: os.stat(os.path.join(artifacts, n)).st_mtime_ns
              for n in os.listdir(artifacts)}
    rows = port.main([])
    printed = capsys.readouterr().out.rstrip("\n").splitlines()
    assert {n: os.stat(os.path.join(artifacts, n)).st_mtime_ns
            for n in os.listdir(artifacts)} == before
    assert len(rows) == len(printed) == 15
    tx = optax.adam(1e-4)
    for row, line in zip(rows, printed):
        want = jax_ex.budget(jax_ex.CONFIGS[row["model"]], row["fsdp"], tx)
        assert row["num_params"] == want["num_params"]
        assert row["params_gib"] == want["params_gib"]
        assert row["grads_gib"] == want["grads_gib"]
        leaves = len(port._model(port.CONFIGS[row["model"]])[0])
        assert row["opt_state_bytes"] - 4 * (leaves - 1) == \
            round(want["opt_state_gib"] * 2 ** 30)
        jax_line = (f"{row['model']:>11} fsdp={row['fsdp']:>2}: params "
                    f"{want['params_gib']:7.2f} + grads "
                    f"{want['grads_gib']:7.2f} + adam "
                    f"{want['opt_state_gib']:7.2f} = "
                    f"{want['total_gib']:7.2f} GiB/")
        assert line.startswith(jax_line), (line, jax_line)
