"""The plain reference of the ε-graph, its lower-precision control, and the
comparison that decides a run's ``correct``.

Plain PyTorch and NumPy only: nothing of the program under test. The
reference takes a call's points and ε and works out each row's neighbours
itself (every j != i with d(i, j) <= ε), by brute force over all n points in
blocks of rows:

- ``euclidean``: d² = ‖x‖² + ‖y‖² − 2x·y in float64, whose error (about
  1e-16·S, S = ‖x‖² + ‖y‖²) is nine orders below the program's fp32 error;
- ``hamming`` (rows of packed 32-bit words): the words unpacked to 0/1 bits,
  popcount(x ^ y) = |x| + |y| − 2x·y by one matrix product. Every term and
  every partial sum is an integer of at most 32·words, so the product is
  exact in float32, and in float16 (integers to 2048) up to 64 words.

The program computes in fp32, so a pair whose distance lies within fp32
error of ε may fall either way. The comparison therefore measures each pair
on which the program and the reference disagree by how far it lies from ε,
in units of its fp32 error scale: ``split_u`` = |d² − ε²| / (u·S) for L2,
u = 2⁻²⁴, the largest over the pairs checked (0 where none differ). Hamming is integer-exact: ``wrong_pairs``
counts the pairs that differ. A listed neighbour that is no pair (an id out
of range, or one listed twice) counts as a differing pair, at
``NO_PAIR_SPLIT`` for ``split_u``.

The control puts the reference in the program's place, one step down:
for L2 the product in TF32 (the card's tensor-core float32 with a 10-bit
mantissa; on the CPU its rounding of the inputs emulated). Hamming states no precision, so its control breaks the stated
guarantee of a closed ball: it keeps the pairs with d < ε.
"""
from __future__ import annotations

import math

import numpy as np
import torch

U32 = 2.0 ** -24                   # fp32 unit round-off
NO_PAIR_SPLIT = 1e38               # split_u of a listed id that is no pair
BLOCK_BYTES = 6 * 2**30            # the (rows, n) block's working memory


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa (nearest, ties
    away), as the tensor cores read them."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


class Reference:
    """The ε-graph of ``points`` (one call's rows, on the device the check
    runs on) under ``metric``, a block of rows at a time."""

    def __init__(self, points: torch.Tensor, eps: float, metric: str):
        self.metric, self.eps = metric, float(eps)
        self.n = len(points)
        self.dev = points.device
        if metric == "euclidean":
            self.x64 = points.double()
            self.sq = (self.x64 * self.x64).sum(1)
            self.x32 = points.float()
            self.bytes_per = 9
        elif metric == "hamming":
            words = points.shape[1]
            exact16 = self.dev.type == "cuda" and 32 * words <= 2048
            self.bdt = torch.float16 if exact16 else torch.float32
            shifts = torch.arange(32, device=self.dev, dtype=torch.int32)
            bits = (points.to(torch.int32)[:, :, None] >> shifts) & 1
            self.bits = bits.reshape(self.n, 32 * words).to(self.bdt)
            self.pop = self.bits.float().sum(1).to(self.bdt)
            self.bytes_per = 1 + self.bits.element_size()
        else:
            raise ValueError(f"no reference for metric {metric!r}")

    def block_rows(self) -> int:
        return max(1, int(BLOCK_BYTES // (self.n * self.bytes_per)))

    def keys(self, rb: torch.Tensor, control: bool = False) -> torch.Tensor:
        """Sorted keys (local row · n + column) of rows ``rb``'s neighbours:
        the reference's, or with ``control`` its lower-precision control's."""
        hit = self._hits(rb, control)
        hit[torch.arange(len(rb), device=self.dev), rb] = False
        r, c = hit.nonzero(as_tuple=True)
        return r * self.n + c

    def _hits(self, rb, control):
        eps = self.eps
        if self.metric == "euclidean":
            if not control:
                d = torch.addmm(self.sq[None, :], self.x64[rb], self.x64.T,
                                alpha=-2.0)           # ‖y‖² − 2x·y
                return d <= (eps * eps - self.sq[rb])[:, None]
            x = self.x32 if self.dev.type == "cuda" else _tf32(self.x32)
            sq = (self.x32 * self.x32).sum(1)
            saved = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                d = torch.addmm(sq[None, :], x[rb], x.T, alpha=-2.0)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = saved
            e2 = torch.tensor(eps, dtype=torch.float32) ** 2
            return d <= (e2.to(self.dev) - sq[rb])[:, None]
        d = torch.addmm(self.pop[None, :], self.bits[rb], self.bits.T,
                        alpha=-2.0)                   # |y| − 2x·y
        # integer distances: d <= eps is d <= floor(eps), d < eps is
        # d <= ceil(eps) - 1; every threshold an integer, exact in bdt
        k = math.ceil(eps) - 1 if control else math.floor(eps)
        return d <= (k - self.pop[rb].float()).to(self.bdt)[:, None]

    def split(self, r: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """How far L2 pairs (r, c) lie from ε, in units of their fp32 error
        scale (float64, by the direct difference)."""
        d2 = ((self.x64[r] - self.x64[c]) ** 2).sum(1)
        return (d2 - self.eps ** 2).abs() / (U32 * (self.sq[r] + self.sq[c]))


def csr_keys(row_ptr: np.ndarray, col_ids: np.ndarray, rows: np.ndarray,
             n: int, device) -> tuple[torch.Tensor, int]:
    """The CSR's listed neighbours of ``rows`` as keys (local row · n +
    column) on ``device``, and how many of them are no pair (an id out of
    range)."""
    starts = row_ptr[rows]
    lens = row_ptr[rows + 1] - starts
    idx = (np.repeat(starts - np.cumsum(lens) + lens, lens)
           + np.arange(lens.sum()))
    cols = torch.from_numpy(col_ids[idx].astype(np.int64)).to(device)
    local = torch.from_numpy(np.repeat(np.arange(len(rows)), lens)).to(device)
    ok = (cols >= 0) & (cols < n)
    return local[ok] * n + cols[ok], int((~ok).sum())


def compare(ref: Reference, rows: np.ndarray, got) -> dict:
    """The pairs of ``rows`` on which ``got`` differs from the reference.
    ``got(rb_np, rb)`` gives the judged side's keys of a block of rows and
    its count of ids that are no pair."""
    out = dict(rows=0, pairs_ref=0, pairs_got=0, missing=0, extra=0,
               no_pair=0, split_u=0.0)
    step = ref.block_rows()
    for b0 in range(0, len(rows), step):
        rb_np = rows[b0:b0 + step]
        rb = torch.from_numpy(rb_np).to(ref.dev)
        want = ref.keys(rb)
        have, no_pair = got(rb_np, rb)
        uniq = torch.unique(have)
        no_pair += len(have) - len(uniq)
        miss = want[~torch.isin(want, uniq)]
        extra = uniq[~torch.isin(uniq, want)]
        out["rows"] += len(rb_np)
        out["pairs_ref"] += len(want)
        out["pairs_got"] += len(have)
        out["missing"] += len(miss)
        out["extra"] += len(extra)
        out["no_pair"] += no_pair
        differ = torch.cat([miss, extra])
        if len(differ) and ref.metric != "hamming":
            r, c = rb[differ // ref.n], differ % ref.n
            out["split_u"] = max(out["split_u"],
                                 float(ref.split(r, c).max()))
        if no_pair:
            out["split_u"] = NO_PAIR_SPLIT
        del want, have, uniq, miss, extra, differ
    out["wrong_pairs"] = out["missing"] + out["extra"] + out["no_pair"]
    return out


def judge_graph(ref: Reference, row_ptr, col_ids, rows) -> dict:
    """The program's CSR rows ``rows`` against the reference."""
    return compare(ref, rows, lambda rb_np, rb: csr_keys(
        row_ptr, col_ids, rb_np, ref.n, ref.dev))


def judge_control(ref: Reference, rows) -> dict:
    """The control, in the program's place, against the reference."""
    return compare(ref, rows, lambda rb_np, rb: (ref.keys(rb, True), 0))


def reading(metric: str, result: dict) -> tuple[str, float]:
    """The number a configuration's limit holds: (name, value)."""
    if metric == "hamming":
        return "wrong_pairs", float(result["wrong_pairs"])
    return "split_u", float(result["split_u"])
