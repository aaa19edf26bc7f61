"""Parallel modes of the port, named as in ``horovod_tpu/parallel``:
process meshes (``mesh``), hierarchical collectives, sequence
parallelism (ring and Ulysses attention), pipelines and expert
parallelism (``moe``), over ``torch.distributed`` process groups; the
neighbour exchange and the group sums they share live in ``exchange``.
The JAX sharding-spec helpers have no counterpart (see ``mesh``)."""

from . import exchange, hierarchical, moe, pipeline, sequence  # noqa: F401
from .exchange import ring_exchange  # noqa: F401
from .hierarchical import (  # noqa: F401
    hierarchical_allgather,
    hierarchical_allreduce,
)
from .mesh import (  # noqa: F401
    DATA_AXIS,
    Mesh,
    axis_size,
    make_mesh,
    make_multislice_mesh,
    mesh,
    replicate,
    reset_mesh,
    set_mesh,
    shard_batch,
)
from .moe import moe_apply, moe_apply_dense, switch_aux_loss  # noqa: F401
from .pipeline import (  # noqa: F401
    collect_from_last_stage,
    pipeline_1f1b,
    pipeline_apply,
    pipeline_loss,
    stack_stage_params,
)
