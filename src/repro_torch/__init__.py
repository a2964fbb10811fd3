"""PyTorch / CUDA port of the distributed ε-NNG system (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its
layout and names, runs its kernels as hand-written CUDA for Hopper, and
imports nothing of it. Entry point: ``repro_torch.nng.build_nng``.
"""
