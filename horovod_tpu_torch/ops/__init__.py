"""Ops of the port: plain attention and the hand-written decode kernels
(``decode_attention``; sources under ``horovod_tpu_torch/csrc``)."""
