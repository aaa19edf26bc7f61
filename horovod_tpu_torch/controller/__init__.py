"""The eager tier's background controller over the TCP star
(``controller.py``) and its transport (``service.py``) — the port's
copies of ``horovod_tpu/controller/``."""
