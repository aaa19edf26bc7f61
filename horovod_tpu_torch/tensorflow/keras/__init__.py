"""``import horovod_tpu_torch.tensorflow.keras as hvd`` — parity alias for
the reference's ``horovod/tensorflow/keras`` package (same shared impl as
``horovod_tpu_torch.keras``), the counterpart of
``horovod_tpu/tensorflow/keras/__init__.py``."""

from ...keras import (  # noqa: F401
    Compression,
    DistributedOptimizer,
    allgather,
    allgather_object,
    allreduce,
    barrier,
    broadcast,
    broadcast_global_variables,
    broadcast_object,
    broadcast_variables,
    callbacks,
    cross_rank,
    cross_size,
    init,
    is_initialized,
    load_model,
    local_rank,
    local_size,
    mpi_threads_supported,
    rank,
    shutdown,
    size,
)
