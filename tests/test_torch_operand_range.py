"""The kernels' operand range, held on the CPU.

The flash kernels are instantiated at head_dim 64 and 128 and take any
group; ``ops/attention.py`` brings a narrower head_dim to them by
zero-padding it. Those transforms are plain functions around any
implementation of the kernels' signatures: here they wrap the plain
versions, which must then give what the plain versions give on the
operands unpadded — forward, dq, dk and dv at D=16 and D=32 (Llama-tiny,
BERT-tiny), also at group 16 and 3. The card-side cases (the kernels
themselves at these shapes) are in ``tests/test_torch_cuda.py``.

Also here: the decode-path switch of ``models/llama.py`` is per thread,
so serving replicas in one process cannot leave each other's path set.
"""

import threading

import numpy as np
import pytest
import torch

from horovod_tpu_torch.models import llama
from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import attention as A

# float32 on both sides: padded columns add exact zeros, so only the
# order of the sums inside the products may differ.
TOL = dict(atol=2e-6, rtol=1e-5)


def _inputs(seed, b, sq, sk, h, hkv, d, masked):
    rng = np.random.RandomState(seed)

    def randn(*shape):
        return torch.from_numpy((rng.randn(*shape) * 0.5).astype(np.float32))

    q, k, v, g = (randn(b, sq, h, d), randn(b, sk, hkv, d),
                  randn(b, sk, hkv, d), randn(b, sq, h, d))
    mask = None
    if masked:
        mask = torch.from_numpy(rng.rand(b, sk) > 0.3)
        mask[:, -1] = True
    return q, k, v, g, mask


@pytest.mark.parametrize(
    "b,sq,sk,h,hkv,d,causal,masked",
    [(2, 24, 24, 4, 2, 16, True, False),      # Llama-tiny heads
     (2, 19, 19, 2, 2, 32, False, True),      # BERT-tiny: D=32, key mask
     (1, 12, 20, 16, 1, 32, True, False),     # group 16 at D=32
     (1, 9, 9, 6, 2, 16, True, True),         # group 3 at D=16
     (2, 16, 16, 4, 4, 128, False, False)],   # in range: passed through
    ids=["d16", "d32_mask", "group16", "group3_d16", "in_range"])
def test_transforms_around_plain_equal_plain(b, sq, sk, h, hkv, d, causal,
                                             masked):
    q, k, v, g, mask = _inputs(0, b, sq, sk, h, hkv, d, masked)
    assert A.kernel_width(d) in _build.FLASH_WIDTHS
    out, lse = A.forward_in_range(A.flash_attention_forward_plain, q, k, v,
                                  mask, causal)
    want_out, want_lse = A.flash_attention_forward_plain(q, k, v, mask,
                                                         causal)
    assert out.shape == q.shape
    torch.testing.assert_close(out, want_out, **TOL)
    torch.testing.assert_close(lse, want_lse, **TOL)
    delta = A.flash_delta(want_out, g)
    dq = A.dq_in_range(A.flash_backward_dq_plain, q, k, v, mask, g,
                       want_lse, delta, causal)
    dk, dv = A.dkdv_in_range(A.flash_backward_dkdv_plain, q, k, v, mask, g,
                             want_lse, delta, causal)
    want_dq = A.flash_backward_dq_plain(q, k, v, mask, g, want_lse, delta,
                                        causal)
    want_dk, want_dv = A.flash_backward_dkdv_plain(q, k, v, mask, g,
                                                   want_lse, delta, causal)
    assert dk.shape == k.shape and dv.shape == v.shape
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        torch.testing.assert_close(got, want, **TOL)


def test_padding_keeps_bfloat16_exact():
    """The padded columns are exact zeros in bfloat16 too: every output,
    dk and dv of a group-16 head included, is within float32 rounding of
    the unpadded plain version (both round once, to bf16, at the end)."""
    q, k, v, g, _ = _inputs(1, 1, 16, 16, 16, 1, 16, False)
    q, k, v, g = (x.to(torch.bfloat16) for x in (q, k, v, g))
    out, lse = A.forward_in_range(A.flash_attention_forward_plain, q, k, v,
                                  None, True)
    want_out, want_lse = A.flash_attention_forward_plain(q, k, v, None,
                                                         True)
    delta = A.flash_delta(want_out, g)
    got = [out, A.dq_in_range(A.flash_backward_dq_plain, q, k, v, None, g,
                              want_lse, delta, True),
           *A.dkdv_in_range(A.flash_backward_dkdv_plain, q, k, v, None, g,
                            want_lse, delta, True)]
    want = [want_out, A.flash_backward_dq_plain(q, k, v, None, g, want_lse,
                                                delta, True),
            *A.flash_backward_dkdv_plain(q, k, v, None, g, want_lse, delta,
                                         True)]
    torch.testing.assert_close(lse, want_lse, **TOL)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        # One bf16 ulp where float32 rounding tips a rounding.
        torch.testing.assert_close(a.float(), b.float(), rtol=2 ** -7,
                                   atol=1e-6)


def test_operand_rule_names_what_stays_out_of_range():
    assert [A.kernel_width(d) for d in (16, 32, 64, 100, 128)] == \
        [64, 64, 64, 128, 128]
    with pytest.raises(ValueError, match="head_dim up to 128, got 160"):
        A.kernel_width(160)
    assert _build.DECODE_WIDTHS == (16, 32, 64, 128)
    assert _build.DECODE_GROUPS == (1, 2, 4, 8, 16)


def test_flash_attention_on_cpu_is_the_plain_path_at_any_width():
    q, k, v, _, mask = _inputs(2, 2, 10, 10, 4, 2, 16, True)
    A.reset_launch_counts()
    out = A.flash_attention(q, k, v, key_mask=mask, causal=True)
    want, _ = A.flash_attention_forward_plain(q, k, v, mask, True)
    torch.testing.assert_close(out, want, **TOL)
    assert A.LAUNCHES == {"flash_forward": 0, "flash_backward_dq": 0,
                          "flash_backward_dkdv": 0}


def test_decode_path_is_per_thread():
    """Two threads enter ``decode_path_context("einsum")`` and
    ``("kernel")`` interleaved: each sees its own path, and the state
    outside is unchanged after both exit (with a process-global switch the
    einsum thread's exit restored "kernel" over the other's value, or the
    other way round, and later engines ran a path nobody chose)."""
    before = llama.current_decode_path()
    steps = [threading.Event() for _ in range(4)]
    seen = {}
    errors = []

    def worker(name, path, enter_after, entered, exit_after, exited):
        try:
            if enter_after is not None:
                steps[enter_after].wait(10)
            with llama.decode_path_context(path):
                steps[entered].set()
                steps[exit_after].wait(10)
                seen[name] = llama.current_decode_path().path
            steps[exited].set()
        except Exception as exc:  # surfaced below
            errors.append(exc)

    # a enters, b enters, a exits, b exits: the interleaving that broke
    # the global save/restore.
    a = threading.Thread(target=worker, name="hvd-test-path-a",
                         daemon=True, args=("a", "einsum", None, 0, 1, 2))
    b = threading.Thread(target=worker, name="hvd-test-path-b",
                         daemon=True, args=("b", "kernel", 0, 1, 2, 3))
    a.start()
    b.start()
    a.join(20)
    b.join(20)
    assert not errors, errors
    assert seen == {"a": "einsum", "b": "kernel"}
    assert llama.current_decode_path() == before
    with llama.decode_kernel_disabled():
        assert llama.current_decode_path().path == "einsum"
        inner = {}
        t = threading.Thread(target=lambda: inner.update(
            path=llama.current_decode_path().path),
            name="hvd-test-path-fresh", daemon=True)
        t.start()
        t.join(10)
        assert inner["path"] == "kernel"   # a new thread starts at default
    assert llama.current_decode_path() == before


def test_launch_counters_lose_no_update_across_threads():
    """Fleet replicas launch the decode kernels from their own loop
    threads: the launch counters take a lock, so concurrent increments
    all land."""
    import sys

    from horovod_tpu_torch.ops import decode_attention as D

    D.reset_launch_counts()
    A.reset_launch_counts()
    per_thread, threads = 3000, 12
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [
            (D._count_launch("paged_decode_attention"),
             A._count_launch("flash_forward"))
            for _ in range(per_thread)], name=f"hvd-test-count-{i}",
            daemon=True) for i in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    assert D.LAUNCHES["paged_decode_attention"] == per_thread * threads
    assert A.LAUNCHES["flash_forward"] == per_thread * threads
    D.reset_launch_counts()
    A.reset_launch_counts()
