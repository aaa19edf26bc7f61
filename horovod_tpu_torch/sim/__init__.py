"""simcluster on the port — the JAX package's ``horovod_tpu/sim`` over the
port's own controller, wire and monitors.

This package multiplexes N *logical* worker ranks onto the calling
thread of ONE process, behind the exact ``common/wire.py`` seams
production uses: every logical rank dials the coordinator over a real
loopback TCP socket, speaks the real authenticated frame protocol (kind
bytes, HMAC, deadlines, heartbeats, ``ProtocolMonitor`` hooks), and the
coordinator side is the port's real ``Controller`` +
``CoordinatorService``: negotiation, Tensor Fusion, elastic
``reform()``, the doctor sweep, all unmodified. What is simulated is
only the worker-side *process*: a :class:`SimWorker` is a lockstep
protocol state machine over numpy arrays, not a training job; rank 0
enqueues CPU torch tensors and its results come back as numpy.

That buys a 64-256-rank world for the cost of a couple of threads:
join/leave storms, correlated rack failures (the ``group_kill`` plan
kind) and flapping-NIC delay bursts all run under
``HOROVOD_PROTOCHECK=1`` with the doctor expected to name every injected
fault.

The same harness is the measurement rig for ``utils/scaling_model.py``:
:mod:`~horovod_tpu_torch.sim.measure` records negotiation, reshape and
heartbeat-fanout costs per world size, and the capacity planner's
control-plane calibration is fitted from that data
(``examples/capacity_probe.py``).

Entry points:

* :class:`~horovod_tpu_torch.sim.cluster.SimCluster`, the harness.
* ``python -m horovod_tpu_torch.tools.simcluster --ranks N --plan @file``,
  a seeded scenario runner that exits non-zero on any conformance
  violation or undiagnosed fault.
"""

from .cluster import SimCluster, SimStepTorn, StepSpec, allreduce_spec
from .faults import SimFaultDriver, expected_diagnoses, sim_supported_plan
from .scenario import ScenarioResult, run_scenario
from .worker import SimOp, SimWorker, SimWorkerDead

__all__ = [
    "ScenarioResult",
    "SimCluster",
    "SimFaultDriver",
    "SimOp",
    "SimStepTorn",
    "SimWorker",
    "SimWorkerDead",
    "StepSpec",
    "allreduce_spec",
    "expected_diagnoses",
    "run_scenario",
    "sim_supported_plan",
]
