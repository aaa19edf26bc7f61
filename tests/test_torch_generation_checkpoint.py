"""The generation example's ``--checkpoint`` on the port against the JAX
package: JAX tiny-Llama weights (``LLAMA_TINY`` as the example builds it,
bfloat16 compute) carried across with ``models.convert.llama_from_flax``,
saved with the port's ``utils.checkpoint.save_checkpoint``, decoded by
``examples/llama_generation.py --checkpoint PATH --device cpu``. Its
greedy tokens must equal the JAX ``generate`` from the same weights, and
differ from the example's own random weights. A checkpoint with a
missing name or a wrong shape raises before decoding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import llama as jllama
from horovod_tpu_torch.examples import llama_generation
from horovod_tpu_torch.models import llama as tllama
from horovod_tpu_torch.models.convert import llama_from_flax
from horovod_tpu_torch.utils.checkpoint import save_checkpoint
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARGS = ["--model", "tiny", "--prompt-len", "12", "--max-new-tokens", "8",
        "--batch-size", "2", "--device", "cpu"]


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """(path of the port checkpoint, JAX variables) from JAX seed 3."""
    variables = jllama.LlamaLM(jllama.LLAMA_TINY).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))
    model = llama_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"]),
        tllama.LLAMA_TINY, device="cpu")
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny")
    save_checkpoint(path, model.state_dict())
    return path, variables


def test_checkpoint_tokens_equal_jax_generate(saved):
    path, variables = saved
    prompt = jnp.asarray(np.random.RandomState(0).randint(
        0, jllama.LLAMA_TINY.vocab_size, (2, 12)), jnp.int32)
    want = np.asarray(jllama.generate(jllama.LlamaLM(jllama.LLAMA_TINY),
                                      variables, prompt, max_new_tokens=8))
    got = llama_generation.main(ARGS + ["--checkpoint", path])["out"]
    np.testing.assert_array_equal(got.numpy(), want)
    fresh = llama_generation.main(ARGS)["out"]
    assert not torch.equal(fresh, got)


def test_checkpoint_that_does_not_fit_raises(tmp_path):
    model = tllama.LlamaLM(tllama.LLAMA_TINY, device="cpu", seed=0)
    good = model.state_dict()
    name = sorted(good)[0]
    wrong = dict(good)
    wrong[name] = torch.zeros(3, 5)
    save_checkpoint(str(tmp_path / "wrong"), wrong)
    with pytest.raises(ValueError, match="wrong shapes"):
        llama_generation.main(ARGS + ["--checkpoint",
                                      str(tmp_path / "wrong")])
    missing = dict(good)
    del missing[name]
    save_checkpoint(str(tmp_path / "missing"), missing)
    with pytest.raises(ValueError, match="missing"):
        llama_generation.main(ARGS + ["--checkpoint",
                                      str(tmp_path / "missing")])
