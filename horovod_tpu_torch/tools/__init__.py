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
"""
