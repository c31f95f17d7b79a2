"""Hand-written Hopper kernels of the port, their plain PyTorch versions
(``ref.py``) and their dispatch (``ops.py``)."""
