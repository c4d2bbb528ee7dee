"""Hand-written Hopper kernels of the port, each beside its plain torch
version (``ref.py``) and a dispatcher (``ops.py``)."""
