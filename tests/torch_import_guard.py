"""Which imports of JAX or of the JAX package the port's own code makes.

``import tensorflow`` loads jax by itself where jax is installed (its
lite converter's optional JAX path), so a process that runs the port's TF
front end holds jax in ``sys.modules`` whatever the port does. This guard
tells the two apart: it wraps ``builtins.__import__`` and records each
absolute import of a banned top-level name made from a module whose file
lies in the port's package (or is one of ``files``)."""

import builtins
import os

BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "horovod_tpu")


def install(port_dir, files=()):
    """Start recording; returns the list the offenders go into, as
    ``"<importing file>: import <name>"``."""
    port_dir = os.path.join(os.path.abspath(port_dir), "")
    files = {os.path.abspath(f) for f in files}
    offenders = []
    original = builtins.__import__

    def guarded(name, globals=None, locals=None, fromlist=(), level=0):
        if level == 0 and name.partition(".")[0] in BANNED:
            where = os.path.abspath((globals or {}).get("__file__") or "?")
            if where.startswith(port_dir) or where in files:
                offenders.append(f"{where}: import {name}")
        return original(name, globals, locals, fromlist, level)

    builtins.__import__ = guarded
    return offenders
