"""Tile kernels of the port: CUDA C++ sources in ``csrc/``, their
wrappers and plain PyTorch versions, and the device-dispatching ops."""
