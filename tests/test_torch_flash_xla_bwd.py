"""``HOROVOD_FLASH_XLA_BWD`` on the port against the JAX package, on the
CPU: with the flag set, flash attention's backward and the ring block
pair's backward differentiate the plain attention recomputed from q, k, v
(and the mask) instead of running the two backward kernels.

* ``flash_attention``'s flagged gradients against the JAX package's
  flagged gradients (its forward in Pallas interpret mode), causal with
  GQA, with a key mask that leaves a dead row (whose cotangent must not
  reach dk/dv), and in the decode convention with Sq > Sk;
* the ring block pair (``_FlashBlockPair`` / ``_flash_block_pair``)
  under the flag, with cotangents on both ``out`` and ``lse``;
* under the flag the port never reaches its backward kernels' wrapper;
* the raw truthiness: ``"0"`` switches it on in both packages, ``""``
  leaves it off.

Tolerance: atol 2e-5 / rtol 1e-4 (float32; the two packages differ in
summation order only). The flagged gradients also match each package's
kernel backward at the same tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.common import config as jconfig
from horovod_tpu.ops import attention as jattn
from horovod_tpu.parallel import sequence as jseq
from horovod_tpu_torch.common import config as tconfig
from horovod_tpu_torch.ops import attention as tattn
from horovod_tpu_torch.parallel import sequence as tseq
from torch_threads import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = dict(atol=2e-5, rtol=1e-4)
FLAG = "HOROVOD_FLASH_XLA_BWD"


def _inputs(seed, b, sq, sk, h, hkv, d):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, sq, h, d) * 0.5).astype(np.float32)
    k = (rng.randn(b, sk, hkv, d) * 0.5).astype(np.float32)
    v = (rng.randn(b, sk, hkv, d) * 0.5).astype(np.float32)
    g = rng.randn(b, sq, h, d).astype(np.float32)
    return q, k, v, g


def _jax_grads(q, k, v, g, mask, causal):
    jmask = None if mask is None else jnp.asarray(mask)

    def f(q, k, v):
        return jattn.flash_attention(q, k, v, key_mask=jmask, causal=causal,
                                     block_q=32, block_k=32)

    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _port_grads(q, k, v, g, mask, causal):
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = tattn.flash_attention(
        tq, tk, tv, key_mask=None if mask is None else torch.tensor(mask),
        causal=causal)
    out.backward(torch.tensor(g))
    return [x.grad.numpy() for x in (tq, tk, tv)]


CASES = {
    # name: (b, sq, sk, h, hkv, d, causal, masked key positions)
    "causal_gqa": (2, 16, 16, 4, 2, 16, True, None),
    "dead_row": (2, 16, 16, 4, 2, 16, True, [0]),
    "decode_sq_gt_sk": (1, 24, 16, 2, 2, 16, True, None),
    "masked_full": (2, 12, 20, 2, 1, 16, False, [3, 7, 19]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_flagged_flash_gradients_match_jax(monkeypatch, name):
    b, sq, sk, h, hkv, d, causal, masked = CASES[name]
    q, k, v, g = _inputs(len(name), b, sq, sk, h, hkv, d)
    mask = None
    if masked is not None:
        mask = np.ones((b, sk), bool)
        mask[0, masked] = False
    kernel = _port_grads(q, k, v, g, mask, causal)
    monkeypatch.setenv(FLAG, "1")
    monkeypatch.setattr(tattn, "_flash_backward", lambda *a, **k: 1 / 0)
    want = _jax_grads(q, k, v, g, mask, causal)
    got = _port_grads(q, k, v, g, mask, causal)
    for label, a, w, kern in zip("qkv", got, want, kernel):
        np.testing.assert_allclose(a, w, **TOL, err_msg=f"d{label}")
        np.testing.assert_allclose(a, kern, **TOL,
                                   err_msg=f"d{label} vs kernels")
    if name == "dead_row":
        # Query row 0 sees only key 0, which the mask drops in batch 0.
        np.testing.assert_array_equal(got[0][0, 0], 0.0)


@pytest.mark.parametrize("causal,masked", [(True, False), (False, True)],
                         ids=["diag_causal", "masked"])
def test_flagged_ring_block_pair_matches_jax(monkeypatch, causal, masked):
    b, s, h, hkv, d = 2, 16, 4, 2, 16
    q, k, v, g = _inputs(7, b, s, s, h, hkv, d)
    dlse = np.random.RandomState(8).randn(b * h, 1, s).astype(np.float32)
    mask = np.ones((b, s), bool)
    if masked:
        mask[1, [2, 5, 11]] = False
    scale = 1.0 / np.sqrt(d)

    def port():
        tq, tk, tv = (torch.tensor(x, requires_grad=True)
                      for x in (q, k, v))
        out, lse = tseq._FlashBlockPair.apply(
            tq, tk, tv, torch.tensor(mask) if masked else None, causal,
            scale)
        torch.autograd.backward(
            [out, lse], [torch.tensor(g), torch.tensor(dlse).reshape(
                lse.shape)])
        return [x.grad.numpy() for x in (tq, tk, tv)]

    kernel = port()
    monkeypatch.setenv(FLAG, "1")
    monkeypatch.setattr(tseq, "_flash_backward", lambda *a, **k: 1 / 0)
    got = port()
    (jout, jlse), vjp = jax.vjp(
        lambda q_, k_, v_: jseq._flash_block_pair(
            q_, jnp.asarray(mask), k_, v_, causal, scale),
        *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp((jnp.asarray(g), jnp.asarray(dlse).reshape(jlse.shape)))
    for label, a, w, kern in zip("qkv", got, want, kernel):
        np.testing.assert_allclose(a, np.asarray(w), **TOL,
                                   err_msg=f"d{label}")
        np.testing.assert_allclose(a, kern, **TOL,
                                   err_msg=f"d{label} vs kernels")


@pytest.mark.parametrize("value,on", [("0", True), ("1", True),
                                      ("", False), (None, False)])
def test_flag_is_raw_truthiness_in_both_packages(monkeypatch, value, on):
    if value is None:
        monkeypatch.delenv(FLAG, raising=False)
    else:
        monkeypatch.setenv(FLAG, value)
    assert tconfig.flash_xla_bwd() is jconfig.flash_xla_bwd() is on
