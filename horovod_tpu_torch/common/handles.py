"""Async-operation handles of the eager-tier controller — the port's copy
of ``horovod_tpu/common/handles.py``.

A Handle owns a ``threading.Event`` plus the result, filled in by the
controller thread; the manager keeps handles alive until waited (the
reference pins tensors in ``_handle_map`` for the same reason). A result
that lives on a card carries the CUDA event recorded after the
controller's last copy into it: ``wait()`` makes the caller's current
stream wait on that event, so the caller's next kernel reads the
finished values without a host synchronisation.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional


class Handle:
    __slots__ = ("_id", "_event", "_result", "_error", "_manager",
                 "_ready", "tensor_sizes")

    def __init__(self, handle_id: int, manager: "HandleManager"):
        self._id = handle_id
        self._event = threading.Event()
        self._result: Any = None
        self._error: Optional[BaseException] = None
        self._manager = manager
        # torch.cuda.Event recorded on the controller's stream after the
        # result was written on the card; None for host results.
        self._ready = None
        # For allgather handles: every rank's first-dim size from the
        # negotiated Response, so autograd's backward can locate this
        # rank's slice without a second sizes-allgather. None otherwise.
        self.tensor_sizes: Optional[list] = None

    @property
    def id(self) -> int:
        return self._id

    def set_result(self, value: Any, ready=None) -> None:
        self._result = value
        self._ready = ready
        self._event.set()

    def set_error(self, exc: BaseException) -> None:
        self._error = exc
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError(f"handle {self._id} not complete after {timeout}s")
        self._manager.clear(self._id)
        if self._error is not None:
            raise self._error
        if self._ready is not None:
            import torch

            torch.cuda.current_stream(self._result.device).wait_event(
                self._ready)
        return self._result


class HandleManager:
    """Allocates handles and retains them until cleared
    (reference ``torch/handle_manager.h:31-42``)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._next = 0
        self._live: Dict[int, Handle] = {}

    def allocate(self) -> Handle:
        with self._lock:
            hid = self._next
            self._next += 1
            h = Handle(hid, self)
            self._live[hid] = h
            return h

    def completed(self, value: Any) -> Handle:
        """A handle that is already resolved (size-1 fast path)."""
        h = self.allocate()
        h.set_result(value)
        return h

    def clear(self, handle_id: int) -> None:
        with self._lock:
            self._live.pop(handle_id, None)

    def outstanding(self) -> int:
        with self._lock:
            return sum(1 for h in self._live.values() if not h.done())
