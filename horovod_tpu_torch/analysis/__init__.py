"""The port's static analysis and runtime lock and protocol checks — its
own copy of ``horovod_tpu/analysis`` (stdlib only), re-rooted at
``horovod_tpu_torch/``.

Horovod's core invariant — every rank issues the same collectives in the
same order — is enforced at runtime by the coordinator; the tracing plane
assumes every rank walks the identical response order, and the control
plane assumes its locks across wire/controller/metrics/heartbeat threads
never invert. This package checks all of it, statically and at runtime:

* :mod:`.framework` + :mod:`.rules` — hvdlint, an AST lint with the
  distributed-correctness rules HVD001..HVD011, ``# hvdlint:
  disable=RULE`` suppressions, baselines (HVD010/HVD011 are
  ``NEVER_BASELINE``) and text/JSON reporters. CLI: ``python -m
  horovod_tpu_torch.tools.lint``.
* :mod:`.dataflow` — the call graph and rank taint behind HVD001 and the
  static lock graph.
* :mod:`.protocol` — the wire/epoch protocol as one declarative
  ``SPEC`` (equal, as data, to the JAX package's: the port's frames are
  its wire's byte for byte), checked statically against the port's own
  dispatch (HVD008, ``python -m horovod_tpu_torch.tools.protocheck``) and
  at runtime by the ``HOROVOD_PROTOCHECK=1`` monitor in ``Wire``.
* :mod:`.lockorder` — ``make_lock`` and the ``HOROVOD_LOCKCHECK=1``
  acquisition-order graph, the static lock graph over the port's sources
  (with the C++ core's mutexes) and the static x runtime join.
* :mod:`.autofix` — ``--fix`` for HVD002 and HVD005.
* :mod:`.cpp` — hvdabi, a compiler-free extractor over the port's C++
  core (``core/src/``): the ``extern "C"`` ABI against
  ``core/bindings.py``, the counter slots against the metrics mirror,
  the engine's frame-kind anchors and its mutex graph. CLI: ``python -m
  horovod_tpu_torch.tools.abicheck``.

``common/wire.py`` and every other module with a lock imports
:func:`.lockorder.make_lock` at load, so nothing here imports torch,
numpy or the rest of the package.
"""

from .framework import (  # noqa: F401
    NEVER_BASELINE,
    Finding,
    LintResult,
    Rule,
    SourceFile,
    baseline_key,
    iter_python_files,
    lint_source,
    load_baseline,
    render_json,
    render_text,
    run_lint,
    write_baseline,
)
from .lockorder import (  # noqa: F401
    LockGraph,
    TrackedLock,
    find_cycles,
    join_reports,
    lockcheck_enabled,
    make_lock,
    static_graph,
)
from .protocol import (  # noqa: F401
    ProtocolMonitor,
    ProtocolViolationError,
    epoch_advances,
    epoch_is_stale,
    protocheck_enabled,
)
from .rules import ALL_RULES, aux_rules, get_rule  # noqa: F401

__all__ = [
    "NEVER_BASELINE",
    "Finding", "LintResult", "Rule", "SourceFile", "baseline_key",
    "iter_python_files", "lint_source", "load_baseline", "render_json",
    "render_text", "run_lint", "write_baseline", "ALL_RULES", "aux_rules",
    "get_rule", "LockGraph", "TrackedLock", "find_cycles", "join_reports",
    "lockcheck_enabled", "make_lock", "static_graph", "ProtocolMonitor",
    "ProtocolViolationError", "epoch_advances", "epoch_is_stale",
    "protocheck_enabled",
]
