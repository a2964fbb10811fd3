"""Dense pairwise Hamming distances on the card.

``pairwise_hamming_cuda`` (``csrc/pairwise_hamming.cu``) is the
hand-written CUDA kernel that replaces the reference's
``pairwise_hamming_pallas``: for x (q, w) and y (p, w) packed 32-bit words
it writes the (q, p) int32 matrix of popcount(x ⊕ y) summed over the
words. Words are int32 tensors holding the uint32 bit pattern, as
everywhere in the port. Its plain version is ``ref.pairwise_hamming_ref``;
the two are exact and equal bit for bit on every input.
"""
from __future__ import annotations

import torch

from .nng_tile import check_operands, launch_row_chunks


def pairwise_hamming_cuda(x, y) -> torch.Tensor:
    """The CUDA kernel: x (q, w), y (p, w) contiguous int32 words on one
    CUDA device -> (q, p) int32 Hamming distances. Any q, p and w: the
    kernel masks ragged edges, and its output offsets are 64-bit."""
    check_operands("pairwise_hamming_cuda", ("x", x, torch.int32, 2),
                   ("y", y, torch.int32, 2))
    if y.shape[1] != x.shape[1]:
        raise ValueError(f"pairwise_hamming_cuda: shapes x "
                         f"{tuple(x.shape)}, y {tuple(y.shape)}")
    out = torch.empty((x.shape[0], y.shape[0]), dtype=torch.int32,
                      device=x.device)
    pairwise_hamming_cuda.launches += launch_row_chunks("pairwise_hamming",
                                                        x, y, out)
    return out


pairwise_hamming_cuda.launches = 0
