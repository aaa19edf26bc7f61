"""The port's launcher (``python -m horovod_tpu_torch.run``)."""

from .launch import build_rank_env, main, parse_hosts, run  # noqa: F401
