"""Kernels of the port: hand-written CUDA (``csrc/``), their ctypes wrappers, the plain versions (``ref``) and the dispatch by device (``ops``)."""
