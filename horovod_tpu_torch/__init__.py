"""horovod_tpu_torch — the PyTorch/CUDA port of ``horovod_tpu``.

The JAX package beside this one stays the reference; every module here
keeps its counterpart's name so the two are easy to hold side by side.
This package imports ``torch`` and never ``jax``, ``flax`` or anything
of ``horovod_tpu`` (host modules it needs are copied, not imported).

Slice 1 is the serving path: ``models.llama`` (``LlamaLM``,
``generate``) and ``serving`` (``ServingEngine``, ``serve``) over the
hand-written Hopper decode kernels in ``csrc/decode_attention.cu``.
Slice 2 is training: ``init``/``rank``/``size``, the collectives and
``DistributedOptimizer`` (re-exported here from ``.torch``, so
``import horovod_tpu_torch as hvd`` reads like ``import horovod_tpu as
hvd``), ``models.llama``'s losses and remat, and flash attention over
the kernels in ``csrc/flash_attention.cu``
(``examples/llama_training.py``). The eager tier's tuning and tracing
loop adds ``BucketScheduler``, ``partition_buckets`` and
``plan_from_compiled`` here, and ``trace`` carries the JAX package's
whole tracing surface. ``doctor`` is the cluster doctor (``report``,
``summary``, the rule catalog) over the metrics plane and the traces.
``profiler`` records ``torch.profiler`` traces under the JAX package's
``hvd.*`` labels, which ``utils/{comm_accounting,hlo_phases,overlap}.py``
read.

Entry points take ``device=None``, which means ``cuda``: without a card
they raise unless the caller asks for ``device="cpu"`` explicitly.
"""

from __future__ import annotations

from typing import Union

# Imported under another name: the ``.torch`` subpackage below becomes
# this package's attribute ``torch``.
import torch as _torch

__version__ = "0.1.0"

DeviceLike = Union[str, _torch.device, None]


def default_device(device: DeviceLike = None) -> _torch.device:
    """Resolve an entry point's ``device`` argument. ``None`` means the
    current CUDA device; with no card that raises — the CPU is used only
    when the caller names it, never as a silent fallback."""
    if device is None:
        if not _torch.cuda.is_available():
            raise RuntimeError(
                "horovod_tpu_torch: no CUDA device is available; pass "
                "device='cpu' explicitly to run on the CPU")
        return _torch.device("cuda", _torch.cuda.current_device())
    return _torch.device(device)


from .torch import *  # noqa: E402,F401,F403
from . import elastic  # noqa: E402,F401
from . import serving  # noqa: E402,F401
from . import doctor  # noqa: E402,F401  (hvd.doctor.report() / rule catalog)
from .common import profiler  # noqa: E402,F401  (hvd.profiler.trace())
from . import trace  # noqa: E402,F401
from .controller.bucket_scheduler import (  # noqa: E402,F401
    BucketScheduler,
    partition_buckets,
    plan_from_compiled,
)
