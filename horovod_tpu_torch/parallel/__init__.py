"""Parallel modes of the port, named as in ``horovod_tpu/parallel``:
expert parallelism (``moe``) so far. A data x expert layout builds its
process groups with ``torch.distributed.new_group`` (``mesh`` is not
ported yet)."""

from .moe import moe_apply, moe_apply_dense, switch_aux_loss  # noqa: F401
