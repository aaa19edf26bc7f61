"""Keras front end over the port's eager tier: ``import
horovod_tpu_torch.keras as hvd`` — the counterpart of
``horovod_tpu/keras/__init__.py``.

Reference: ``horovod/keras/__init__.py`` + ``horovod/_keras/__init__.py``
(shared impl with ``horovod/tensorflow/keras``). This is Keras 3 as
``tf.keras``: the optimizer seam is ``apply_gradients``, so
``DistributedOptimizer`` is shared with the TF front end
(``horovod_tpu_torch.tensorflow``), whose collectives these are.
"""

try:
    import tensorflow  # noqa: F401
except ImportError as exc:
    raise ImportError(
        "horovod_tpu_torch.keras requires the 'tensorflow' package (Keras 3 "
        "as tf.keras), which is not installed in this environment. Use "
        "horovod_tpu_torch (the torch front end) instead.") from exc

from ..common.basics import (  # noqa: F401
    cross_rank,
    cross_size,
    is_initialized,
    local_rank,
    local_size,
    mpi_threads_supported,
    rank,
    shutdown,
    size,
)
from ..tensorflow import (  # noqa: F401
    Compression,
    DistributedOptimizer,
    allgather,
    allgather_object,
    allreduce,
    barrier,
    broadcast,
    broadcast_object,
    broadcast_variables,
    init,
)
from . import callbacks  # noqa: F401


def broadcast_global_variables(model, root_rank: int = 0) -> None:
    """Broadcast a model's variables from root (reference
    ``keras/__init__.py`` delegating to ``_keras``; TF2 needs the model
    explicitly — there is no global collection)."""
    broadcast_variables(list(model.variables), root_rank=root_rank)


def load_model(filepath, custom_optimizers=None, custom_objects=None,
               compression=Compression.none):
    """Load a saved Keras model with its optimizer wrapped in
    ``DistributedOptimizer`` — optimizer state (params and slot weights) is
    picked up for retraining (reference ``keras/__init__.py:115-…``
    delegating to ``_keras/__init__.py:93-109``).

    Every optimizer class in ``keras.optimizers`` is registered by default;
    ``custom_optimizers`` adds user optimizer classes, ``custom_objects``
    passes straight through to ``keras.models.load_model`` (and wins on key
    collisions, as in the reference).

    Keras 3 resolves built-in class names BEFORE consulting
    ``custom_objects`` (``serialization_lib._retrieve_class_or_fn``), so
    unlike the reference's Keras-2 flow, name registration alone cannot
    intercept a built-in optimizer. The registrations below still catch
    models saved with wrapped/custom optimizers; a model that deserialized
    with a plain optimizer is wrapped after the fact by swapping the live
    instance's class to the ``_Distributed`` subclass — same object, all
    restored slot state intact, only ``apply_gradients`` overridden.
    """
    import inspect

    import keras

    from ..tensorflow import _distributed_optimizer_class

    def register(objs, cls):
        wrapped = _distributed_optimizer_class(cls, compression)
        # Keras 3 serializes CamelCase class names; Keras 2 lowercased them
        # (the reference registers the lowercase form) — cover both, plus a
        # model saved while already compiled with the wrapped class.
        objs[cls.__name__] = wrapped
        objs[cls.__name__.lower()] = wrapped
        objs[f"Distributed{cls.__name__}"] = wrapped

    horovod_objects = {}
    base = keras.optimizers.Optimizer
    for obj in vars(keras.optimizers).values():
        if (inspect.isclass(obj) and issubclass(obj, base)
                and obj is not base):
            register(horovod_objects, obj)
    for cls in custom_optimizers or ():
        register(horovod_objects, cls)
    if custom_objects:
        horovod_objects.update(custom_objects)
    model = keras.models.load_model(filepath,
                                    custom_objects=horovod_objects)
    optimizer = getattr(model, "optimizer", None)
    if optimizer is not None and not getattr(
            type(optimizer), "_hvd_distributed", False):
        optimizer.__class__ = _distributed_optimizer_class(
            type(optimizer), compression)
    return model
