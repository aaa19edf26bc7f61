"""The port's command-line tools (``python -m horovod_tpu_torch.tools.<name>``),
each a copy of the JAX package's tool of that name over the port's own
sources:

* ``lint`` — hvdlint over the package (and, with ``--aux``, over its
  examples and tests).
* ``protocheck`` — the wire protocol's static conformance, runtime
  artifacts (``--runtime``), the static x runtime lock-graph join
  (``--lockgraph``) and the native engine's frame coverage (``--native``).
* ``abicheck`` — hvdabi over the port's C++ core and its bindings.
* ``check`` — the five gates above in one exit code.
* ``doctor`` — the offline cluster diagnosis of a job's artifacts.
* ``simcluster`` — a seeded N-logical-rank chaos and conformance run on
  the simulated cluster (``horovod_tpu_torch.sim``).
* ``capacity`` — the capacity planner over a control-plane calibration
  (the port's own by default) or a live job's re-fit (``--live``).
* ``straggler`` — the merged trace and straggler report of a traced
  job's directory.
"""
