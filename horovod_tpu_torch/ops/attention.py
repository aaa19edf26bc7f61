"""Attention in torch: the counterpart of ``horovod_tpu/ops/attention.py``.

``reference_attention`` is the plain path. ``flash_attention`` is one
``torch.autograd.Function``: its forward runs kernel 1 (the counterpart
of the Pallas ``_flash_kernel``), which saves ``out`` and the per-row
log-sum-exp; its backward computes ``delta = rowsum(dO * O in f32) -
dlse`` in plain torch, as the JAX package does outside its kernels, and
runs kernel 2 (dq) and kernel 3 (dk/dv, summed over each GQA group). The
kernels are hand-written CUDA in ``csrc/flash_attention.cu``.

Routing, as in ``ops/decode_attention.py``: a CUDA tensor always goes to
the kernel, and the call raises if the kernel cannot take it (a head_dim
above 256, or float16); a head_dim other than 64, 128 or 256 reaches the
kernels zero-padded (see "The kernels' operand range" below). Only CPU
tensors take the plain versions (``flash_attention_forward_plain``,
``flash_backward_dq_plain``, ``flash_backward_dkdv_plain``), which repeat
the kernels' arithmetic with explicit formulas. ``LAUNCHES`` counts kernel
launches per wrapper.

Semantics kept from the JAX package: q ``(B, Sq, H, D)``, k/v
``(B, Sk, Hkv, D)`` with query head h reading K/V head ``h // (H/Hkv)``;
an optional ``(B, Sk)`` key mask; causal in the decode convention (query
row i attends keys ``<= i + Sk - Sq``); rows with no allowed key give
zeros (and zero gradients), not ``reference_attention``'s mean(v). Any
Sq and Sk work without padding: the kernels bounds-check, which gives what
the JAX package's auto-pad path gives. ``HOROVOD_FLASH_XLA_BWD`` (the JAX
package's rematerialised backward) is not ported. The JAX package's
``block_q``/``block_k`` (tiles chosen for TPU VMEM) have no counterpart:
the kernels fix their own tiles. The three bfloat16 kernels are Hopper
kernels (TMA loads, wgmma) that read q/k/v/dO through tensor maps, so
their operands must be contiguous and 16-byte aligned, as the wrappers
check; the float32 kernels, and both types at head_dim 256, stream 32-row
tiles through FMA loops.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import torch

from . import _build

NEG_INF = -1e30

FLASH_AUTO_MIN_SEQ = 512

#: Kernel launches per wrapper since the last :func:`reset_launch_counts`.
LAUNCHES: Dict[str, int] = {"flash_forward": 0, "flash_backward_dq": 0,
                            "flash_backward_dkdv": 0}
_launch_lock = threading.Lock()

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, k, v, mask, out, lse, b, sq, sk, h, hkv, d, scale, causal, dtype,
    # stream
    "hvd_flash_forward": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _F, _I, _I, _P),
    # q, k, v, mask, dout, lse, delta, dq, b, sq, sk, h, hkv, d, scale,
    # causal, dtype, stream
    "hvd_flash_backward_dq": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              _I, _I, _I, _F, _I, _I, _P),
    # q, k, v, mask, dout, lse, delta, dk, dv, b, sq, sk, h, hkv, d, scale,
    # causal, dtype, stream
    "hvd_flash_backward_dkdv": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                _I, _I, _I, _I, _F, _I, _I, _P),
}


def reset_launch_counts() -> None:
    with _launch_lock:
        for key in LAUNCHES:
            LAUNCHES[key] = 0


def _count_launch(name: str) -> None:
    """One launch of ``name``'s kernel. Under a lock: several serving
    loops (fleet replicas) launch from their own threads."""
    with _launch_lock:
        LAUNCHES[name] += 1


def _check_gqa_heads(q, k, v, name: str) -> None:
    if (v.shape[2] != k.shape[2]) or (q.shape[2] % k.shape[2]):
        raise ValueError(
            f"{name}: query heads ({q.shape[2]}) must be a multiple of "
            f"K/V heads ({k.shape[2]}, v {v.shape[2]}) — grouped-query "
            "attention folds each group of H/Hkv query heads onto one "
            "K/V head")


def repeat_kv(q, k, v):
    """Repeat grouped K/V heads (dim 2) up to q's head count: query head
    h reads K/V head h // group (group-contiguous, as in the JAX
    package)."""
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    return k, v


def reference_attention(q, k, v, key_mask=None, causal: bool = False,
                        sm_scale: Optional[float] = None):
    """Plain attention. q (B, Sq, H, D); k/v (B, Sk, Hkv, D) with
    H % Hkv == 0; key_mask (B, Sk) bool. Logits and softmax in f32, the
    probabilities cast to q's dtype before P·V; causal uses the decode
    convention (query row i attends keys <= i + Sk - Sq)."""
    d = q.shape[-1]
    _check_gqa_heads(q, k, v, "reference_attention")
    k, v = repeat_kv(q, k, v)
    scale = sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if key_mask is not None:
        logits = logits.masked_fill(~key_mask[:, None, None, :], NEG_INF)
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        ki = torch.arange(sk, device=q.device)[None, :]
        logits = logits.masked_fill(~(ki <= qi)[None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)


# ---------------------------------------------------------------------------
# Plain versions of the three kernels


def _scale(q, sm_scale):
    return sm_scale if sm_scale is not None else 1.0 / (q.shape[-1] ** 0.5)


def _allowed(key_mask, causal, sq, sk, device):
    """(B|1, 1, 1, Sq, Sk) bool of allowed entries, or None when every
    entry is allowed (no key mask and not causal: no masking runs)."""
    allowed = None
    if key_mask is not None:
        allowed = key_mask.bool()[:, None, None, None, :]
    if causal:
        qi = torch.arange(sq, device=device)[:, None] + (sk - sq)
        tri = (torch.arange(sk, device=device)[None, :] <= qi)[None, None,
                                                                None]
        allowed = tri if allowed is None else (allowed & tri)
    return allowed


def _grouped(x, hkv):
    """(B, S, H, D) -> (B, Hkv, H/Hkv, S, D) float32: query head
    ``kv * group + g`` at [:, kv, g]."""
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, hkv, h // hkv, s, d).float()


def _kv(x):
    """(B, Sk, Hkv, D) -> (B, Hkv, 1, Sk, D) float32."""
    return x.permute(0, 2, 1, 3)[:, :, None].float()


def _ungroup(x, dtype):
    """(B, Hkv, G, S, D) -> (B, S, Hkv*G, D) in ``dtype``."""
    b, hkv, g, s, d = x.shape
    return x.reshape(b, hkv * g, s, d).permute(0, 2, 1, 3).to(
        dtype).contiguous()


def _scores(q, k, key_mask, causal, scale):
    """s = (q·k) in f32 times ``scale`` per group, and the allowed mask."""
    hkv = k.shape[2]
    s = (_grouped(q, hkv) @ _kv(k).transpose(-1, -2)) * scale
    return s, _allowed(key_mask, causal, q.shape[1], k.shape[1], q.device)


def flash_attention_forward_plain(q, k, v, key_mask=None,
                                  causal: bool = False,
                                  sm_scale: Optional[float] = None):
    """Plain version of kernel 1: ``(out, lse)``, out (B, Sq, H, D) in q's
    dtype and lse (B*H, 1, Sq) f32. Masked scores are NEG_INF and their p
    is zeroed explicitly; p is rounded to V's dtype before P·V."""
    _check_gqa_heads(q, k, v, "flash_attention")
    b, sq, h, _ = q.shape
    s, allowed = _scores(q, k, key_mask, causal, _scale(q, sm_scale))
    if allowed is not None:
        s = s.masked_fill(~allowed, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if allowed is not None:
        p = p.masked_fill(~allowed, 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = p.to(v.dtype).float() @ _kv(v)
    out = _ungroup(acc / l, q.dtype)
    lse = (m + torch.log(l)).reshape(b * h, 1, sq)
    return out, lse


def _probs_plain(q, k, key_mask, lse, causal, scale):
    """p = exp(s - lse), zeroed where not allowed, per group."""
    b, sq, h, _ = q.shape
    hkv = k.shape[2]
    s, allowed = _scores(q, k, key_mask, causal, scale)
    p = torch.exp(s - lse.reshape(b, hkv, h // hkv, sq, 1))
    if allowed is not None:
        p = p.masked_fill(~allowed, 0.0)
    return p


def _ds_plain(q, k, v, key_mask, g, lse, delta, causal, scale):
    b, sq, h, _ = q.shape
    hkv = k.shape[2]
    p = _probs_plain(q, k, key_mask, lse, causal, scale)
    dp = _grouped(g, hkv) @ _kv(v).transpose(-1, -2)
    return p, p * (dp - delta.reshape(b, hkv, h // hkv, sq, 1))


def flash_backward_dq_plain(q, k, v, key_mask, g, lse, delta,
                            causal: bool = False,
                            sm_scale: Optional[float] = None):
    """Plain version of kernel 2: dq = scale · Σ ds k, ds rounded to K's
    dtype, in q's dtype."""
    scale = _scale(q, sm_scale)
    _, ds = _ds_plain(q, k, v, key_mask, g, lse, delta, causal, scale)
    return _ungroup((ds.to(k.dtype).float() @ _kv(k)) * scale, q.dtype)


def flash_backward_dkdv_plain(q, k, v, key_mask, g, lse, delta,
                              causal: bool = False,
                              sm_scale: Optional[float] = None):
    """Plain version of kernel 3: ``(dk, dv)`` at Hkv width, summed in f32
    over each GQA group: dv = Σ pᵀ dO (p rounded to dO's dtype), dk =
    scale · Σ dsᵀ q (ds rounded to q's dtype)."""
    scale = _scale(q, sm_scale)
    hkv = k.shape[2]
    p, ds = _ds_plain(q, k, v, key_mask, g, lse, delta, causal, scale)
    dv = (p.to(g.dtype).float().transpose(-1, -2) @ _grouped(g, hkv)).sum(2)
    dk = (ds.to(q.dtype).float().transpose(-1, -2)
          @ _grouped(q, hkv)).sum(2) * scale
    return (dk.permute(0, 2, 1, 3).to(k.dtype).contiguous(),
            dv.permute(0, 2, 1, 3).to(v.dtype).contiguous())


def flash_delta(out, g, dlse=None):
    """delta = rowsum(dO · O) in f32, minus ``dlse`` when the lse output
    has a cotangent (ring attention's merge): (B*H, 1, Sq) f32."""
    b, sq, h, _ = out.shape
    delta = (g.float() * out.float()).sum(-1).permute(0, 2, 1).reshape(
        b * h, 1, sq)
    if dlse is not None:
        delta = delta - dlse.reshape(b * h, 1, sq).float()
    return delta.contiguous()


def flash_attention_backward_plain(q, k, v, key_mask, out, lse, g,
                                   causal: bool = False,
                                   sm_scale: Optional[float] = None,
                                   dlse=None):
    """Plain version of :func:`_flash_backward`: ``(dq, dk, dv)``."""
    delta = flash_delta(out, g, dlse)
    dq = flash_backward_dq_plain(q, k, v, key_mask, g, lse, delta, causal,
                                 sm_scale)
    dk, dv = flash_backward_dkdv_plain(q, k, v, key_mask, g, lse, delta,
                                       causal, sm_scale)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# The kernels' operand range
#
# The flash kernels are instantiated at head_dim 64, 128 and 256
# (``_build.FLASH_WIDTHS``) and take any group H/Hkv. A narrower head_dim
# is zero-padded up to the next width, with the scale taken from the true
# head_dim: the padded columns add 0 to every q·k and give 0 in out, dq,
# dk and dv, which are sliced back; lse and delta (a row sum of dO·O) are
# unchanged. The transforms are plain functions around any
# implementation of the kernels' signatures, so the CPU tests drive them
# around the plain versions.


def kernel_width(d: int) -> int:
    """The flash kernels' head width that takes head_dim ``d``: the next
    of ``FLASH_WIDTHS``. A head_dim above the widest raises."""
    widths = [w for w in _build.FLASH_WIDTHS if w >= d]
    if not widths:
        raise ValueError(
            f"flash_attention: the CUDA kernels take head_dim up to "
            f"{max(_build.FLASH_WIDTHS)}, got {d} (no configuration of the "
            "repo has a wider head)")
    return widths[0]


def widen(x, width: int):
    """``x`` with its last dim zero-padded up to ``width``."""
    d = x.shape[-1]
    return x if d == width else torch.nn.functional.pad(x, (0, width - d))


def forward_in_range(forward, q, k, v, key_mask=None, causal: bool = False,
                     sm_scale: Optional[float] = None):
    """``forward`` (kernel 1 or its plain version, at a kernel width) over
    any head_dim up to the widest: ``(out, lse)``."""
    d = q.shape[-1]
    width = kernel_width(d)
    if width == d:
        return forward(q, k, v, key_mask, causal, sm_scale)
    out, lse = forward(widen(q, width), widen(k, width), widen(v, width),
                       key_mask, causal, _scale(q, sm_scale))
    return out[..., :d].contiguous(), lse


def dq_in_range(backward_dq, q, k, v, key_mask, g, lse, delta,
                causal: bool = False, sm_scale: Optional[float] = None):
    """``backward_dq`` (kernel 2 or its plain version) over any head_dim
    up to the widest."""
    d = q.shape[-1]
    width = kernel_width(d)
    if width == d:
        return backward_dq(q, k, v, key_mask, g, lse, delta, causal,
                           sm_scale)
    dq = backward_dq(widen(q, width), widen(k, width), widen(v, width),
                     key_mask, widen(g, width), lse, delta, causal,
                     _scale(q, sm_scale))
    return dq[..., :d].contiguous()


def dkdv_in_range(backward_dkdv, q, k, v, key_mask, g, lse, delta,
                  causal: bool = False, sm_scale: Optional[float] = None):
    """``backward_dkdv`` (kernel 3 or its plain version) over any head_dim
    up to the widest: ``(dk, dv)``."""
    d = q.shape[-1]
    width = kernel_width(d)
    if width == d:
        return backward_dkdv(q, k, v, key_mask, g, lse, delta, causal,
                             sm_scale)
    dk, dv = backward_dkdv(widen(q, width), widen(k, width),
                           widen(v, width), key_mask, widen(g, width), lse,
                           delta, causal, _scale(q, sm_scale))
    return dk[..., :d].contiguous(), dv[..., :d].contiguous()


# ---------------------------------------------------------------------------
# Kernel wrappers


def _kernel_args(name, q, k, v, key_mask, **more):
    _build.check_operands(name, _build.FLASH_WIDTHS, q=q, k=k, v=v, **more)
    mask = None
    if key_mask is not None:
        mask = key_mask.to(torch.uint8).contiguous()
    b, sq, h, d = q.shape
    return mask, (b, sq, k.shape[1], h, k.shape[2], d)


def _mask_ptr(mask):
    return None if mask is None else mask.data_ptr()


def _forward_kernel(q, k, v, key_mask, causal, sm_scale):
    """Launch kernel 1 on operands in its range."""
    mask, dims = _kernel_args("flash_forward", q, k, v, key_mask)
    b, sq, sk, h, hkv, d = dims
    out = torch.empty_like(q)
    lse = torch.empty((b * h, 1, sq), dtype=torch.float32, device=q.device)
    lib = _build.library("flash_attention", _SIGNATURES)
    code = lib.hvd_flash_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _mask_ptr(mask),
        out.data_ptr(), lse.data_ptr(), *dims, float(_scale(q, sm_scale)),
        int(causal), _build.KERNEL_DTYPES[q.dtype], _build.stream(q.device))
    _build.check(lib, "hvd_flash_forward", code)
    _count_launch("flash_forward")
    return out, lse


def _flash_forward(q, k, v, key_mask=None, causal: bool = False,
                   sm_scale: Optional[float] = None):
    """Kernel 1 (``_flash_kernel``'s counterpart): ``(out, lse)`` as
    :func:`flash_attention_forward_plain` returns them."""
    _check_gqa_heads(q, k, v, "flash_attention")
    tensors = (q, k, v) + (() if key_mask is None else (key_mask,))
    if not _build.on_card("flash attention", *tensors):
        return flash_attention_forward_plain(q, k, v, key_mask, causal,
                                             sm_scale)
    return forward_in_range(_forward_kernel, q, k, v, key_mask, causal,
                            sm_scale)


def _check_stats(q, lse, delta):
    want = (q.shape[0] * q.shape[2], 1, q.shape[1])
    for label, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != want or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(
                f"flash backward: {label} must be contiguous float32 of "
                f"shape {want}, got {t.dtype} {tuple(t.shape)}")


def _dq_kernel(q, k, v, key_mask, g, lse, delta, causal, sm_scale):
    """Launch kernel 2 on operands in its range."""
    mask, dims = _kernel_args("flash_backward_dq", q, k, v, key_mask, g=g)
    _check_stats(q, lse, delta)
    dq = torch.empty_like(q)
    lib = _build.library("flash_attention", _SIGNATURES)
    code = lib.hvd_flash_backward_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _mask_ptr(mask),
        g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *dims, float(_scale(q, sm_scale)), int(causal),
        _build.KERNEL_DTYPES[q.dtype], _build.stream(q.device))
    _build.check(lib, "hvd_flash_backward_dq", code)
    _count_launch("flash_backward_dq")
    return dq


def flash_backward_dq(q, k, v, key_mask, g, lse, delta, causal=False,
                      sm_scale=None):
    """Kernel 2 (``_flash_bwd_dq_kernel``'s counterpart): dq."""
    tensors = (q, k, v, g, lse, delta) + (
        () if key_mask is None else (key_mask,))
    if not _build.on_card("flash attention", *tensors):
        return flash_backward_dq_plain(q, k, v, key_mask, g, lse, delta,
                                       causal, sm_scale)
    return dq_in_range(_dq_kernel, q, k, v, key_mask, g, lse, delta, causal,
                       sm_scale)


def _dkdv_kernel(q, k, v, key_mask, g, lse, delta, causal, sm_scale):
    """Launch kernel 3 on operands in its range."""
    mask, dims = _kernel_args("flash_backward_dkdv", q, k, v, key_mask, g=g)
    _check_stats(q, lse, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _build.library("flash_attention", _SIGNATURES)
    code = lib.hvd_flash_backward_dkdv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _mask_ptr(mask),
        g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), *dims, float(_scale(q, sm_scale)), int(causal),
        _build.KERNEL_DTYPES[q.dtype], _build.stream(q.device))
    _build.check(lib, "hvd_flash_backward_dkdv", code)
    _count_launch("flash_backward_dkdv")
    return dk, dv


def flash_backward_dkdv(q, k, v, key_mask, g, lse, delta, causal=False,
                        sm_scale=None):
    """Kernel 3 (``_flash_bwd_dkdv_kernel``'s counterpart): ``(dk, dv)``,
    one block per (batch, K/V head, key tile) sweeping its whole query
    group — deterministic, no atomics."""
    tensors = (q, k, v, g, lse, delta) + (
        () if key_mask is None else (key_mask,))
    if not _build.on_card("flash attention", *tensors):
        return flash_backward_dkdv_plain(q, k, v, key_mask, g, lse, delta,
                                         causal, sm_scale)
    return dkdv_in_range(_dkdv_kernel, q, k, v, key_mask, g, lse, delta,
                         causal, sm_scale)


def _flash_backward(q, k, v, key_mask, out, lse, g, causal: bool = False,
                    sm_scale: Optional[float] = None, dlse=None):
    """The backward of :func:`_flash_forward`: delta in plain torch, then
    kernels 2 and 3. ``dlse``: a cotangent on lse (a shift of delta)."""
    delta = flash_delta(out, g, dlse)
    dq = flash_backward_dq(q, k, v, key_mask, g, lse, delta, causal,
                           sm_scale)
    dk, dv = flash_backward_dkdv(q, k, v, key_mask, g, lse, delta, causal,
                                 sm_scale)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_mask, causal, sm_scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = _flash_forward(q, k, v, key_mask, causal, sm_scale)
        ctx.save_for_backward(q, k, v, key_mask, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_backward(q, k, v, key_mask, out, lse,
                                     g.contiguous(), ctx.causal,
                                     ctx.sm_scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, key_mask=None, causal: bool = False,
                    sm_scale: Optional[float] = None):
    """Flash attention with its flash backward (see the module doc)."""
    _check_gqa_heads(q, k, v, "flash_attention")
    return _Flash.apply(q, k, v, key_mask, causal, sm_scale)


def make_attention_fn(causal: bool = False, use_flash="auto",
                      sm_scale: Optional[float] = None):
    """Adapter for ``LlamaLM(attention_fn=...)``: signature
    ``(q, k, v, mask)`` with mask (B, Sk) or None. ``use_flash="auto"``
    takes flash from ``FLASH_AUTO_MIN_SEQ`` query rows upward and the
    plain path below; True/False force. The fn carries
    ``supports_gqa = True``: both paths take grouped K/V."""

    def fn(q, k, v, mask):
        flash = use_flash
        if flash == "auto":
            flash = q.shape[1] >= FLASH_AUTO_MIN_SEQ
        if flash:
            return flash_attention(q, k, v, key_mask=mask, causal=causal,
                                   sm_scale=sm_scale)
        return reference_attention(q, k, v, key_mask=mask, causal=causal,
                                   sm_scale=sm_scale)

    fn.supports_gqa = True
    return fn
