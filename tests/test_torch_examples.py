"""The port's remaining training and generation examples on the CPU:
``examples/vit_training.py`` at ``VIT_TINY`` with both attention paths,
``examples/mnist.py`` on its synthetic data, and
``examples/llama_generation.py --model moe-tiny`` (the JAX example's MoE
choice, ``MoeLM`` through the same ``generate()``). Each prints the JAX
example's line. (``examples/moe_lm_training.py`` runs in
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
