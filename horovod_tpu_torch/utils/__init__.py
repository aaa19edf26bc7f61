"""Utilities — the port's counterpart of ``horovod_tpu/utils``: the
checkpoint and resume helpers of ``checkpoint.py``."""

from .checkpoint import (  # noqa: F401
    latest_checkpoint,
    restart_epoch,
    restore_checkpoint,
    restore_latest,
    save_checkpoint,
)
