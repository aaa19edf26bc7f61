"""horovod_tpu_torch — the PyTorch/CUDA port of ``horovod_tpu``.

The JAX package beside this one stays the reference; every module here
keeps its counterpart's name so the two are easy to hold side by side.
This package imports ``torch`` and never ``jax``, ``flax`` or anything
of ``horovod_tpu`` (host modules it needs are copied, not imported).

Slice 1 is the serving path: ``models.llama`` (``LlamaLM``,
``generate``) and ``serving`` (``ServingEngine``, ``serve``) over the
hand-written Hopper decode kernels in ``csrc/decode_attention.cu``.

Entry points take ``device=None``, which means ``cuda``: without a card
they raise unless the caller asks for ``device="cpu"`` explicitly.
"""

from __future__ import annotations

from typing import Union

import torch

__version__ = "0.1.0"

DeviceLike = Union[str, torch.device, None]


def default_device(device: DeviceLike = None) -> torch.device:
    """Resolve an entry point's ``device`` argument. ``None`` means the
    current CUDA device; with no card that raises — the CPU is used only
    when the caller names it, never as a silent fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "horovod_tpu_torch: no CUDA device is available; pass "
                "device='cpu' explicitly to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
