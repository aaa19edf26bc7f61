"""Control-plane message protocol: Request / Response — the port's copy
of ``horovod_tpu/common/message.py``.

Each rank's background thread emits a ``Request`` per pending tensor
(rank, type, dtype, name, shape, root); the coordinator replies with a
fused ``ResponseList``. Plain dataclasses, pickled over the authenticated
wire (``common/wire.py``). ``tensor_dtype`` carries numpy's dtype names
(``"float32"``, ``"bfloat16"``, ...) whatever the tensor's framework, so
fusion groups and error texts are the JAX package's.

``construct_response`` is the reference's cross-rank validation matrix
(``ConstructResponse``, ``horovod/common/operations.cc:198-371``):
mismatched dtype / op / shape / root across ranks produce an ERROR
response whose message reaches every participating rank; the texts are
the JAX package's, word for word.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence, Tuple


class RequestType(enum.IntEnum):
    # reference message.h:47
    ALLREDUCE = 0
    ALLGATHER = 1
    BROADCAST = 2


class ResponseType(enum.IntEnum):
    # reference message.h:132
    ALLREDUCE = 0
    ALLGATHER = 1
    BROADCAST = 2
    ERROR = 3


@dataclasses.dataclass
class Request:
    """One rank's declaration that a tensor is ready (reference
    ``message.h:40-120``)."""

    request_rank: int
    request_type: RequestType
    tensor_name: str
    tensor_dtype: str  # numpy dtype string, e.g. "float32"
    tensor_shape: Tuple[int, ...]
    root_rank: int = -1  # broadcast only
    # Launch priority (0 = none; docs/overlap.md): the coordinator
    # stable-sorts each cycle's fused responses by the tagged priority so
    # the optimizer-critical bucket launches first on every rank. Must
    # agree across ranks for a given tensor (like dtype); NOT part of the
    # validation matrix — a mismatch reorders, it doesn't error.
    priority: int = 0


@dataclasses.dataclass
class RequestList:
    """Everything one rank has pending this cycle (reference
    ``message.h:186-215``). ``shutdown`` cooperatively propagates teardown
    (reference operations.cc:1442-1445)."""

    requests: List[Request] = dataclasses.field(default_factory=list)
    shutdown: bool = False


@dataclasses.dataclass
class Response:
    """Coordinator's instruction to execute (possibly fused) collectives
    (reference ``message.h:125-184``)."""

    response_type: ResponseType
    tensor_names: List[str] = dataclasses.field(default_factory=list)
    error_message: str = ""
    # Allgather only: every rank's dim-0 size, rank order (reference
    # message.h:170-180 tensor_sizes).
    tensor_sizes: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ResponseList:
    responses: List[Response] = dataclasses.field(default_factory=list)
    shutdown: bool = False


_TYPE_NAMES = {
    RequestType.ALLREDUCE: "allreduce",
    RequestType.ALLGATHER: "allgather",
    RequestType.BROADCAST: "broadcast",
}


def construct_response(requests: Sequence[Request], size: int) -> Response:
    """Build one tensor's Response after all ``size`` ranks have submitted
    requests, running the cross-rank consistency checks.

    Mirrors reference ``ConstructResponse`` (``operations.cc:198-371``)
    including the error strings' spirit: first mismatch wins, and the error
    names the offending ranks' values.
    """
    assert len(requests) == size, "construct_response requires all ranks"
    first = requests[0]
    name = first.tensor_name

    # Ordered by the reference's own check order: op type, then dtype, then
    # op-specific shape/root rules.
    for req in requests[1:]:
        if req.request_type != first.request_type:
            return Response(
                ResponseType.ERROR, [name],
                error_message=(
                    f"Mismatched collective operations: rank "
                    f"{first.request_rank} requested "
                    f"{_TYPE_NAMES[first.request_type]} of tensor {name}, but "
                    f"rank {req.request_rank} requested "
                    f"{_TYPE_NAMES[req.request_type]}."))
    for req in requests[1:]:
        if req.tensor_dtype != first.tensor_dtype:
            return Response(
                ResponseType.ERROR, [name],
                error_message=(
                    f"Mismatched data types: rank {first.request_rank} has "
                    f"tensor {name} with dtype {first.tensor_dtype}, but rank "
                    f"{req.request_rank} has dtype {req.tensor_dtype}."))

    if first.request_type == RequestType.ALLREDUCE:
        for req in requests[1:]:
            if req.tensor_shape != first.tensor_shape:
                return Response(
                    ResponseType.ERROR, [name],
                    error_message=(
                        f"Mismatched allreduce tensor shapes: rank "
                        f"{first.request_rank} has shape {first.tensor_shape} "
                        f"for tensor {name}, but rank {req.request_rank} has "
                        f"shape {req.tensor_shape}."))
        return Response(ResponseType.ALLREDUCE, [name])

    if first.request_type == RequestType.BROADCAST:
        for req in requests[1:]:
            if req.root_rank != first.root_rank:
                return Response(
                    ResponseType.ERROR, [name],
                    error_message=(
                        f"Mismatched broadcast root ranks: rank "
                        f"{first.request_rank} specified root "
                        f"{first.root_rank} for tensor {name}, but rank "
                        f"{req.request_rank} specified {req.root_rank}."))
        if not (0 <= first.root_rank < size):
            return Response(
                ResponseType.ERROR, [name],
                error_message=(
                    f"Invalid broadcast root rank {first.root_rank} for "
                    f"tensor {name}: world size is {size}."))
        # Non-root shapes must match the root's (the reference checks all
        # ranks agree, operations.cc:311-330).
        root_req = next(r for r in requests if r.request_rank == first.root_rank)
        for req in requests:
            if req.tensor_shape != root_req.tensor_shape:
                return Response(
                    ResponseType.ERROR, [name],
                    error_message=(
                        f"Mismatched broadcast tensor shapes: root rank "
                        f"{root_req.request_rank} has shape "
                        f"{root_req.tensor_shape} for tensor {name}, but rank "
                        f"{req.request_rank} has shape {req.tensor_shape}."))
        return Response(ResponseType.BROADCAST, [name])

    assert first.request_type == RequestType.ALLGATHER
    for req in requests[1:]:
        if len(req.tensor_shape) != len(first.tensor_shape):
            return Response(
                ResponseType.ERROR, [name],
                error_message=(
                    f"Mismatched allgather tensor ranks: rank "
                    f"{first.request_rank} has rank-{len(first.tensor_shape)} "
                    f"tensor {name}, but rank {req.request_rank} has rank "
                    f"{len(req.tensor_shape)}."))
        if len(first.tensor_shape) == 0:
            return Response(
                ResponseType.ERROR, [name],
                error_message=(
                    f"Allgather of scalar tensor {name} is not possible: "
                    "tensors must have at least one dimension."))
        if req.tensor_shape[1:] != first.tensor_shape[1:]:
            return Response(
                ResponseType.ERROR, [name],
                error_message=(
                    f"Mismatched allgather tensor shapes: all dimensions "
                    f"except the first must match; rank {first.request_rank} "
                    f"has shape {first.tensor_shape} for tensor {name}, but "
                    f"rank {req.request_rank} has shape {req.tensor_shape}."))
    if len(first.tensor_shape) == 0:
        return Response(
            ResponseType.ERROR, [name],
            error_message=(
                f"Allgather of scalar tensor {name} is not possible: "
                "tensors must have at least one dimension."))
    by_rank: Dict[int, Request] = {r.request_rank: r for r in requests}
    sizes = [by_rank[r].tensor_shape[0] for r in range(size)]
    return Response(ResponseType.ALLGATHER, [name], tensor_sizes=sizes)
