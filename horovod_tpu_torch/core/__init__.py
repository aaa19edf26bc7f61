"""The port's native host core: the TCP ring, the /dev/shm local plane and
the C++ engine (own copies of the JAX package's sources, built with g++ at
first use by ``bindings.py``)."""
