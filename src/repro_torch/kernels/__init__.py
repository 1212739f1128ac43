"""Hopper kernels of the port (CUDA C++ under ``csrc/``, bound with ctypes)
and their plain PyTorch versions (``ref.py``).  Importing this package
builds nothing."""
