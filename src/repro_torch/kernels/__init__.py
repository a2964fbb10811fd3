"""Tile kernels of the port: CUDA C++ sources in ``csrc/``, their
wrappers and plain PyTorch versions, and the device-dispatching ops.

The package re-exports the ops wrappers under the reference's names
(``repro.kernels``); the distance-kernel API is ``pairwise_sqdist``,
``pairwise_hamming`` and ``eps_count``."""
from .ops import (  # noqa: F401
    eps_count,
    ghost_block_active,
    grouped_block_active,
    nng_tile_bits,
    nng_tile_bits_ghost,
    nng_tile_bits_grouped,
    nng_tile_bits_pair,
    nng_tile_geometry,
    pairwise_hamming,
    pairwise_sqdist,
    tree_frontier_step,
)
