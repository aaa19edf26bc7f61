"""The flash kernels' key-mask path (``horovod_tpu_torch.ops.attention``):
the mask's bitmap and the masks that leave whole key tiles out, held
against the JAX package on the same numpy inputs.

On the card a key mask reaches kernels 1-3 as one bitmap a call
(``flash_mask_words``), and the bf16 kernels skip key tiles it wholly
leaves out; ``chip_smoke.py`` phase 6 holds that against the plain
versions. Here the CPU runs the plain versions: these tests hold the
bitmap's plain version against a bit-by-bit reference, the autograd
functions' plumbing (one bitmap a call, handed to all three kernels),
and the port against the JAX package (Pallas in interpret mode) on masks
that pad whole 64- and 128-key tiles, a fully padded sequence among
them, and a BERT-tiny step over variable-length padding.

Tolerances: those of ``test_torch_flash_attention.py`` (float32 atol
2e-5 / rtol 1e-4; bfloat16 atol 1e-2 / rtol 1e-2) and of
``test_torch_models.py`` for the BERT step.
"""

import inspect

import numpy as np
import pytest
import torch

from horovod_tpu.ops.attention import make_attention_fn as jmake
from horovod_tpu_torch.ops import attention as tattn
from horovod_tpu_torch.parallel import sequence
from test_torch_flash_attention import (BF16, F32, _arrays, _close,
                                        _jax_flash, _port_flash)
from test_torch_models import TBERT, _bert_loss_check, _bert_pair
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _reference_words(mask):
    """Bit by bit: word w of row b has bit j set when key 64 w + j is
    allowed; two words a 128-key tile, bits past Sk 0."""
    b, sk = mask.shape
    words = np.zeros((b, 2 * ((sk + 127) // 128)), np.uint64)
    for row in range(b):
        for key in np.flatnonzero(mask[row]):
            words[row, key // 64] |= np.uint64(1) << np.uint64(key % 64)
    return words


@pytest.mark.parametrize("sk", [1, 63, 64, 65, 197, 512])
def test_mask_words_plain_sets_one_bit_a_key(sk):
    mask = np.random.RandomState(sk).rand(3, sk) > 0.4
    mask[1] = True
    mask[2] = False
    want = _reference_words(mask)
    for dtype in (torch.bool, torch.uint8):
        words = tattn.mask_words_plain(torch.from_numpy(mask).to(dtype))
        assert words.dtype == torch.int64
        assert tuple(words.shape) == (3, tattn.mask_words_count(sk))
        # Row 1 is all true: its bits past Sk stay 0, as the reference's.
        np.testing.assert_array_equal(words.numpy().view(np.uint64), want)


def test_flash_mask_words_takes_a_cpu_mask_and_refuses_others():
    mask = torch.rand(2, 70) > 0.5
    tattn.reset_launch_counts()
    assert torch.equal(tattn.flash_mask_words(mask),
                       tattn.mask_words_plain(mask))
    assert tattn.MASK_LAUNCHES == {"flash_mask_words": 0}
    with pytest.raises(TypeError, match="bool or uint8"):
        tattn.flash_mask_words(mask.float())
    with pytest.raises(TypeError, match="bool or uint8"):
        tattn.flash_mask_words(mask[0])


def test_kernel_args_refuse_words_of_another_shape():
    q, k, v = (torch.zeros(2, 130, 2, 64) for _ in range(3))
    good = torch.zeros(2, tattn.mask_words_count(130), dtype=torch.int64)
    ptr_nw, dims = tattn._kernel_args("flash_forward", q, k, v, good)
    assert ptr_nw == (good.data_ptr(), 4) and dims == (2, 130, 130, 2, 2, 64)
    assert tattn._kernel_args("flash_forward", q, k, v, None)[0] == (None, 4)
    for bad in (good[:, :3].contiguous(), good.int(), good[:1]):
        with pytest.raises(ValueError, match="words"):
            tattn._kernel_args("flash_forward", q, k, v, bad)


def _spy(module, name, seen):
    real = getattr(module, name)
    signature = inspect.signature(real)

    def spy(*args, **kwargs):
        seen.append((name, signature.bind(*args, **kwargs).arguments.get(
            "words")))
        return real(*args, **kwargs)

    return spy


@pytest.mark.parametrize("path", ["flash_attention", "ring_block"])
def test_one_bitmap_a_call_reaches_all_three_kernels(monkeypatch, path):
    """The autograd functions build the words once in the forward and hand
    the same tensor to kernels 1, 2 and 3. The CPU builds none (the plain
    versions read the bool mask), so the bitmap's builder is replaced by
    its plain version for the test."""
    built, seen = [], []

    def words_of(q, key_mask, words=None):
        if words is not None:
            return words
        built.append(key_mask)
        return tattn.mask_words_plain(key_mask)

    forward_module = tattn if path == "flash_attention" else sequence
    monkeypatch.setattr(forward_module, "flash_call_words", words_of)
    monkeypatch.setattr(forward_module, "_flash_forward",
                        _spy(tattn, "_flash_forward", seen))
    for name in ("flash_backward_dq", "flash_backward_dkdv"):
        monkeypatch.setattr(tattn, name, _spy(tattn, name, seen))
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _arrays(3, (2, 64, 2, 16), (2, 64, 1, 16),
                                (2, 64, 1, 16)))
    mask = torch.ones(2, 64, dtype=torch.bool)
    mask[1, 40:] = False
    tattn.reset_launch_counts()
    if path == "flash_attention":
        out = tattn.flash_attention(q, k, v, key_mask=mask)
        want = tattn.reference_attention(q, k, v, key_mask=mask)
        torch.testing.assert_close(out, want, **F32)
    else:
        out, lse = sequence._FlashBlockPair.apply(q, k, v, mask, False,
                                                  0.25)
        out = out + lse.sum()
    out.sum().backward()
    assert len(built) == 1 and built[0] is mask
    names = [name for name, _ in seen]
    assert names == ["_flash_forward", "flash_backward_dq",
                     "flash_backward_dkdv"]
    words = [w for _, w in seen]
    assert all(w is words[0] for w in words)
    assert torch.equal(words[0], tattn.mask_words_plain(mask))
    assert tattn.MASK_LAUNCHES == {"flash_mask_words": 0}
    assert sorted(tattn.LAUNCHES.values()) == [0, 0, 0]


S_TILES = 256


def _tile_mask(kind):
    """(2, 256) masks that leave whole key tiles out: ``tiles64`` 64-key
    tiles inside mixed 128-key ones, ``tiles128`` whole 128-key tiles (a
    sequence padded to 128, one whose first half is out), ``padded`` a
    ragged length beside a fully padded sequence."""
    mask = np.ones((2, S_TILES), bool)
    if kind == "tiles64":
        mask[0, 64:128] = False
        mask[0, 192:] = False
        mask[1, :64] = False
    elif kind == "tiles128":
        mask[0, 128:] = False
        mask[1, :128] = False
    else:
        mask[0, 100:] = False
        mask[1] = False
    return mask


@pytest.mark.parametrize("kind,causal,dtype", [
    ("tiles64", False, "float32"), ("tiles64", False, "bfloat16"),
    ("tiles128", False, "float32"), ("tiles128", False, "bfloat16"),
    ("padded", False, "float32"), ("padded", False, "bfloat16"),
    ("tiles64", True, "float32"), ("tiles128", True, "float32"),
    ("padded", True, "float32")])
def test_flash_with_whole_tiles_masked_matches_jax(kind, causal, dtype):
    """Forward and the three gradients against the JAX package. Under
    causal, ``tiles128``'s second sequence and ``padded``'s rows of the
    fully padded sequence have no allowed key: zeros, zero gradients."""
    import jax.numpy as jnp

    q, k, v = _arrays(41, (2, S_TILES, 2, 16), (2, S_TILES, 2, 16),
                      (2, S_TILES, 2, 16))
    mask = _tile_mask(kind)
    port = _port_flash(q, k, v, mask, causal,
                       dtype=getattr(torch, dtype))
    jax_ = _jax_flash(q, k, v, mask, causal, dtype=getattr(jnp, dtype),
                      blocks=(64, 64))
    _close(port, jax_, F32 if dtype == "float32" else BF16)
    if kind == "padded":
        np.testing.assert_array_equal(port[0][1], 0.0)
        for g in port[1]:
            np.testing.assert_array_equal(g[1], 0.0)


def test_bert_tiny_step_over_variable_length_padding_matches_jax():
    """BERT-tiny, flash forced on both sides (the JAX package's Pallas
    kernels in interpret mode, the port's plain versions), four sequences
    of 128 with lengths drawn from a seed: one full, one fully padded.
    Logits, the MLM loss and every gradient on converted weights."""
    rng = np.random.RandomState(43)
    b, s = 4, 128
    ids = rng.randint(0, TBERT.vocab_size, (b, s)).astype(np.int32)
    lengths = np.concatenate([[s, 0], rng.randint(1, s, b - 2)])
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    labels_mask = (rng.rand(b, s) < 0.3).astype(np.float32)
    fns = (jmake(use_flash=True), tattn.make_attention_fn(use_flash=True))
    jmodel, variables, tmodel = _bert_pair(ids, fns)
    _bert_loss_check(jmodel, variables, tmodel, ids, mask, labels_mask)
