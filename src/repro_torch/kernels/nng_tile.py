"""Fused ε-NNG tiles: distances, threshold and bit-packed adjacency.

The systolic ring evaluates each (local × visiting) block pair through a
tile of its metric. Each returns

  - cnt  (q,)          exact per-row ε-neighbour counts, int32,
  - bits (q, p / 32)   the hit mask packed 32 columns per word,

and the distance tile never reaches device memory on the kernel path.

Words are int32 tensors holding the uint32 bit pattern (column j is word
j // 32, bit j % 32, little-endian), because torch's uint32 lacks shifts;
so are Hamming points, rows of packed 32-bit words.

Three metrics, each a hand-written CUDA kernel that takes CUDA tensors only
and its plain PyTorch version with the same arithmetic:

  - L2: ``nng_tile_cuda`` (``csrc/nng_tile.cu``) / ``nng_tile_ref``, the
    fp32 ‖x‖² + ‖y‖² − 2x·y expansion against ``eps2_f32(eps)``;
  - Hamming: ``nng_tile_hamming_cuda`` (``csrc/nng_tile_hamming.cu``) /
    ``nng_tile_hamming_ref``, exact XOR + popcount against ``int(eps)``;
  - L1: ``nng_tile_l1_cuda`` (``csrc/nng_tile_l1.cu``) / ``nng_tile_l1_ref``,
    fp32 sums of |x − y| in ``l1_dist``'s order against fp32 eps.

Each has a grouped variant for the landmark engine (Algorithms 5+6):
``nng_tile_grouped{,_hamming,_l1}_cuda`` (``csrc/nng_tile_grouped*.cu``)
and ``nng_tile_grouped{,_hamming,_l1}_ref``. Rows carry a group (the
Voronoi cell, < 0 for padding) and a global id, and a pair hits only when
its distance passes the threshold, its groups are equal and valid, and its
ids differ (``grouped_hit``). The kernels skip the distances of a block
whose groups cannot meet and store zero words there; the L2 one walks a
list of the live tiles only (``grouped_tile_plan``).

And a ghost variant for the landmark engine's ghost ring:
``nng_tile_ghost{,_hamming,_l1}_cuda`` (``csrc/nng_tile_ghost*.cu``) and
``nng_tile_ghost{,_hamming,_l1}_ref``. A visiting row carries its slacked
Lemma-1 ghost cells as packed words (``x_gbits``, (q, ceil(m/32)), the
``pack_words`` layout), and a pair hits only when its distance passes the
threshold and bit ``y_group[j]`` of row i's words is set (``ghost_hit``).
A row's own cell bit is never set, so no id test is needed. The kernels
skip the distances of a block where no row has a bit in the block's y
cell range and store zero words there; the L2 and L1 ones first order the
rows by their ghost cells among y's (``ghost_row_order``) and walk a list
of the live tiles only (``ghost_tile_plan``), storing in the caller's
order.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build

# bit b of a word as an int32 (bit 31 is the sign bit)
_BIT = torch.from_numpy(
    (np.uint32(1) << np.arange(32, dtype=np.uint32)).view(np.int32))


def eps2_f32(eps: float) -> float:
    """The canonical L2 threshold: eps rounded to fp32, squared in fp32.
    Every tile path embeds this value, so a pair whose fp32 d² lands on
    the threshold classifies the same way on all of them."""
    return float(np.float32(eps) ** 2)


# bit b of a byte as a uint8, for the byte-wise packing below
_BYTE_BIT = torch.tensor([1 << b for b in range(8)], dtype=torch.uint8)


def pack_words(hit: torch.Tensor) -> torch.Tensor:
    """(q, p) bool, p % 32 == 0 -> (q, p / 32) int32 words, little-endian
    (column j lands in word j // 32, bit j % 32). Packs 8 columns a byte
    and reads four bytes as one word, so no temporary is wider than a
    byte per column."""
    q, p = hit.shape
    assert p % 32 == 0, p
    bytes_ = hit.contiguous().view(torch.uint8).reshape(q, p // 8, 8)
    bytes_ = (bytes_ * _BYTE_BIT.to(hit.device)).sum(-1, dtype=torch.uint8)
    return bytes_.view(torch.int32)


def unpack_words(bits: torch.Tensor) -> torch.Tensor:
    """(q, W) int32 words -> (q, 32 W) bool, the inverse of ``pack_words``."""
    bytes_ = bits.contiguous().view(torch.uint8)
    out = (bytes_[:, :, None] & _BYTE_BIT.to(bits.device)) != 0
    return out.reshape(bits.shape[0], 32 * bits.shape[1])


def _hits(hit):
    """(q, p) bool hit mask, p % 32 == 0 -> (cnt, packed words)."""
    return hit.sum(1, dtype=torch.int32), pack_words(hit)


def nng_tile_ref(x, y, y_valid, eps: float):
    """Plain PyTorch version: x (q, d), y (p, d), y_valid (p,) with
    p % 32 == 0 -> (cnt (q,) int32, bits (q, p / 32) int32)."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    d2 = ((x * x).sum(1)[:, None] + (y * y).sum(1)[None, :]
          - 2.0 * x @ y.T)
    return _hits((d2 <= eps2_f32(eps)) & (y_valid != 0)[None, :])


def eps_int(eps: float) -> int:
    """The Hamming threshold: ``int(eps)`` (truncated, as the reference),
    clamped to ±2^30 so that d + r and r + eps stay in int32. Distances are
    at most 32 bits a word, so the clamp changes no decision."""
    return max(-(1 << 30), min(int(eps), 1 << 30))


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word's uint32 pattern -> int64, elementwise
    (a SWAR count: torch has no popcount and its uint32 no shifts)."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


# elements of the plain Hamming distance's (rows, p, w) int64 temporaries
_CUBE = 1 << 24


def hamming_dist(x, y) -> torch.Tensor:
    """(q, w), (p, w) int32 words -> (q, p) int32 exact Hamming distances,
    in row chunks that keep the (rows, p, w) temporaries near _CUBE
    elements."""
    q, w = x.shape
    p = y.shape[0]
    out = torch.empty((q, p), dtype=torch.int32, device=x.device)
    step = max(1, _CUBE // max(p * w, 1))
    for i in range(0, q, step):
        xor = x[i:i + step, None, :] ^ y[None, :, :]
        out[i:i + step] = popcount32(xor).sum(-1)
    return out


L1_CHUNK = 8      # features a partial sum (the reference's cchunk)


def l1_dist(x, y) -> torch.Tensor:
    """(q, d), (p, d) fp32 -> (q, p) fp32 sums of |x − y| in the kernels'
    order: within each chunk of L1_CHUNK features a partial sum left to
    right, then d += partial. Spelled out feature by feature, because a
    torch sum over a chunk fixes no order."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    dim = x.shape[1]
    d = torch.zeros((x.shape[0], y.shape[0]), dtype=torch.float32,
                    device=x.device)
    for c0 in range(0, dim, L1_CHUNK):
        part = (x[:, c0, None] - y[None, :, c0]).abs()
        for k in range(c0 + 1, min(c0 + L1_CHUNK, dim)):
            part += (x[:, k, None] - y[None, :, k]).abs()
        d += part
    return d


def nng_tile_hamming_ref(x, y, y_valid, eps: float):
    """Plain PyTorch version: x (q, w), y (p, w) int32 words, y_valid (p,)
    with p % 32 == 0 -> (cnt (q,) int32, bits (q, p / 32) int32)."""
    return _hits((hamming_dist(x, y) <= eps_int(eps))
                 & (y_valid != 0)[None, :])


def nng_tile_l1_ref(x, y, y_valid, eps: float):
    """Plain PyTorch version: x (q, d), y (p, d) fp32, y_valid (p,) with
    p % 32 == 0 -> (cnt (q,) int32, bits (q, p / 32) int32)."""
    return _hits((l1_dist(x, y) <= float(np.float32(eps)))
                 & (y_valid != 0)[None, :])


# ---------------------------------------------------------------------------
# grouped variants (the landmark engine's cell-scoped tiles)
# ---------------------------------------------------------------------------

GBIG = 2**30     # the empty group range's min (the kernels' GBIG)


def grouped_hit(d_ok, xg, yg, xid, yid):
    """Fold group equality, validity (group >= 0) and id inequality into a
    (q, p) bool threshold mask. The id test keeps a point off its own row
    even where fp32 rounds d(x, x) past eps."""
    return (d_ok & (xg[:, None] == yg[None, :]) & (xg >= 0)[:, None]
            & (yg >= 0)[None, :] & (xid[:, None] != yid[None, :]))


def nng_tile_grouped_ref(x, y, xg, yg, xid, yid, eps: float):
    """Plain PyTorch version of the grouped L2 tile: x (q, d), y (p, d),
    groups and ids (q,) / (p,) int32, p % 32 == 0 -> (cnt (q,) int32, bits
    (q, p / 32) int32), with ``nng_tile_ref``'s fp32 expansion."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    d2 = ((x * x).sum(1)[:, None] + (y * y).sum(1)[None, :]
          - 2.0 * x @ y.T)
    return _hits(grouped_hit(d2 <= eps2_f32(eps), xg, yg, xid, yid))


def nng_tile_grouped_hamming_ref(x, y, xg, yg, xid, yid, eps: float):
    """Plain PyTorch version of the grouped Hamming tile over int32 words,
    as ``nng_tile_grouped_ref`` otherwise."""
    return _hits(grouped_hit(hamming_dist(x, y) <= eps_int(eps), xg, yg,
                             xid, yid))


def nng_tile_grouped_l1_ref(x, y, xg, yg, xid, yid, eps: float):
    """Plain PyTorch version of the grouped L1 tile (``l1_dist``'s order),
    as ``nng_tile_grouped_ref`` otherwise."""
    return _hits(grouped_hit(l1_dist(x, y) <= float(np.float32(eps)), xg,
                             yg, xid, yid))


# ---------------------------------------------------------------------------
# ghost variants (the landmark engine's ghost ring)
# ---------------------------------------------------------------------------

def ghost_hit(d_ok, x_gbits, y_group):
    """Fold the ghost test into a (q, p) bool threshold mask: pair (i, j)
    stays where ``y_group[j] >= 0`` and bit ``y_group[j]`` of row i's
    packed words ``x_gbits`` (q, mw) int32 is set. A direct bit test: the
    reference folds the lookup into a one-hot product (``_ghost_hit``),
    which gives the same bits."""
    yg = y_group.long()
    c = yg.clamp_min(0)
    word = x_gbits[:, c // 32]                           # (q, p) int32
    bit = ((word >> (c % 32).to(torch.int32)[None, :]) & 1) != 0
    return d_ok & bit & (yg >= 0)[None, :]


def nng_tile_ghost_ref(x, y, x_gbits, y_group, eps: float):
    """Plain PyTorch version of the ghost L2 tile: x (q, d), y (p, d),
    x_gbits (q, mw) int32 words, y_group (p,) int32, p % 32 == 0 ->
    (cnt (q,) int32, bits (q, p / 32) int32), with ``nng_tile_ref``'s fp32
    expansion."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    d2 = ((x * x).sum(1)[:, None] + (y * y).sum(1)[None, :]
          - 2.0 * x @ y.T)
    return _hits(ghost_hit(d2 <= eps2_f32(eps), x_gbits, y_group))


def nng_tile_ghost_hamming_ref(x, y, x_gbits, y_group, eps: float):
    """Plain PyTorch version of the ghost Hamming tile over int32 words, as
    ``nng_tile_ghost_ref`` otherwise."""
    return _hits(ghost_hit(hamming_dist(x, y) <= eps_int(eps), x_gbits,
                           y_group))


def nng_tile_ghost_l1_ref(x, y, x_gbits, y_group, eps: float):
    """Plain PyTorch version of the ghost L1 tile (``l1_dist``'s order), as
    ``nng_tile_ghost_ref`` otherwise."""
    return _hits(ghost_hit(l1_dist(x, y) <= float(np.float32(eps)), x_gbits,
                           y_group))


def check_operands(fn: str, *specs) -> None:
    """Raise unless every (name, tensor, dtype, ndim) of ``specs`` is a
    contiguous CUDA tensor of that dtype and rank, all on one device."""
    for name, t, dt, nd in specs:
        if not t.is_cuda:
            raise ValueError(f"{fn}: {name} must be a CUDA tensor "
                             f"(got {t.device})")
        if t.dtype != dt or t.dim() != nd or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be a contiguous {nd}-d "
                             f"{dt} tensor (got {t.dtype}, shape "
                             f"{tuple(t.shape)})")
    if len({t.device for _, t, _, _ in specs}) != 1:
        raise ValueError(f"{fn}: operands on different devices")


# rows a launch of a dense-output kernel may cover: the grid's y limit
# (65535 blocks) times the 128-row block
ROWS_PER_LAUNCH = 65535 * 128


def launch_row_chunks(lib: str, x, y, out, *tail) -> int:
    """Launch kernel ``lib`` over ``x``'s rows in chunks of at most
    ``ROWS_PER_LAUNCH``: entry(x, y, out, rows, p, d, *tail, stream) with
    ``out``'s matching rows (``out`` is indexed by x's row on its first
    axis). Raises on a launch error; returns the number of launches."""
    q, d = x.shape
    p = y.shape[0]
    if q == 0 or p == 0:
        return 0
    launch = _build.entry(lib)
    n = 0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        for r0 in range(0, q, ROWS_PER_LAUNCH):
            r1 = min(r0 + ROWS_PER_LAUNCH, q)
            code = launch(x[r0:r1].data_ptr(), y.data_ptr(),
                          out[r0:r1].data_ptr(), r1 - r0, p, d, *tail,
                          stream)
            _build.check(lib, code)
            n += 1
    return n


def row_norm_scratch(q: int, p: int, device):
    """The persistent kernels' scratch: fp32 (q,) and (p,) for the squared
    norms of x's and y's rows, which the launch computes once before the
    tiles read them."""
    return (torch.empty(q, dtype=torch.float32, device=device),
            torch.empty(p, dtype=torch.float32, device=device))


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The streaming multiprocessors of CUDA device ``index``: the
    persistent kernels (``csrc/l2_pipe.cuh``) size their grid from it."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_tile(fn: str, x, y, ints, dtype, gbits=None):
    """Raise unless x and y are (q, d) and (p, d) contiguous ``dtype``
    CUDA tensors, each of ``ints`` ((name, tensor, "q" or "p")) an int32
    vector of q or p rows and ``gbits`` (if given) (q, mw) int32, all on
    one device -> (q, d, p)."""
    extra = () if gbits is None else (("x_gbits", gbits, torch.int32, 2),)
    check_operands(fn, ("x", x, dtype, 2), ("y", y, dtype, 2), *extra,
                   *((name, t, torch.int32, 1) for name, t, _ in ints))
    q, d = x.shape
    p = y.shape[0]
    if y.shape[1] != d or any(t.shape[0] != (q if ax == "q" else p)
                              for _, t, ax in ints) or (
                                  gbits is not None and gbits.shape[0] != q):
        raise ValueError(f"{fn}: shapes x {tuple(x.shape)}, y "
                         f"{tuple(y.shape)}, " + ", ".join(
                             f"{name} {tuple(t.shape)}"
                             for name, t, *_ in extra + tuple(ints)))
    return q, d, p


def _launch_tile(lib: str, x, y, ints, dtype, thr, gbits=None,
                 persistent=False):
    """Check the operands of tile kernel ``lib`` and launch it with
    threshold ``thr`` -> (cnt, bits, launched). ``ints`` are its int32
    operands as (name, tensor, "q" or "p": the rows of x or of y), in the
    order its C entry point takes them after x and y. A ghost kernel also
    takes ``gbits`` (q, mw) int32 right after y, and mw after d; a
    ``persistent`` one (``csrc/l2_pipe.cuh``) fp32 scratch for the rows'
    norms, (q,) and (p,), after bits, and the device's SM count after the
    threshold."""
    q, d, p = _check_tile(f"{lib}_cuda", x, y, ints, dtype, gbits)
    nw = -(-p // 32)
    cnt = torch.zeros(q, dtype=torch.int32, device=x.device)
    # every kernel stores every word of its (q, nw) mask
    bits = torch.empty((q, nw), dtype=torch.int32, device=x.device)
    if q == 0 or p == 0:
        bits.zero_()
        return cnt, bits, False
    launch = _build.entry(lib)
    gb = () if gbits is None else (gbits.data_ptr(),)
    mw = () if gbits is None else (gbits.shape[1],)
    norms = (row_norm_scratch(q, p, x.device) if persistent else ())
    sms = (sm_count(x.device.index),) if persistent else ()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = launch(x.data_ptr(), y.data_ptr(), *gb,
                      *(t.data_ptr() for _, t, _ in ints),
                      cnt.data_ptr(), bits.data_ptr(),
                      *(t.data_ptr() for t in norms), q, p, d, *mw, thr,
                      *sms, stream)
    _build.check(lib, code)
    return cnt, bits, True


def nng_tile_cuda(x, y, y_valid, eps: float):
    """The L2 CUDA kernel: x (q, d), y (p, d) fp32, y_valid (p,) int32, all
    contiguous on one CUDA device -> (cnt (q,) int32, bits (q, ceil(p/32))
    int32). Any q, p and d, and any 4-byte aligned x and y (a row slice
    too): the kernel masks ragged edges, and bits past column p - 1 are
    zero. One launch of a persistent grid (``csrc/l2_pipe.cuh``), whose
    d² are those of the plain chain anchor (``l2_chain_d2_cuda``) bit for
    bit."""
    cnt, bits, launched = _launch_tile("nng_tile", x, y,
                                       (("y_valid", y_valid, "p"),),
                                       torch.float32, eps2_f32(eps),
                                       persistent=True)
    nng_tile_cuda.launches += launched
    return cnt, bits


def nng_tile_hamming_cuda(x, y, y_valid, eps: float):
    """The Hamming CUDA kernel: x (q, w), y (p, w) int32 words, y_valid
    (p,) int32, as ``nng_tile_cuda`` otherwise."""
    cnt, bits, launched = _launch_tile("nng_tile_hamming", x, y,
                                       (("y_valid", y_valid, "p"),),
                                       torch.int32, eps_int(eps))
    nng_tile_hamming_cuda.launches += launched
    return cnt, bits


def nng_tile_l1_cuda(x, y, y_valid, eps: float):
    """The L1 CUDA kernel: x (q, d), y (p, d) fp32, y_valid (p,) int32, as
    ``nng_tile_cuda`` otherwise."""
    cnt, bits, launched = _launch_tile("nng_tile_l1", x, y,
                                       (("y_valid", y_valid, "p"),),
                                       torch.float32, float(np.float32(eps)))
    nng_tile_l1_cuda.launches += launched
    return cnt, bits


def _grouped_ints(xg, yg, xid, yid):
    """The grouped kernels' int32 operands, as ``_check_tile`` takes them."""
    return (("x_group", xg, "q"), ("y_group", yg, "p"), ("x_ids", xid, "q"),
            ("y_ids", yid, "p"))


def _launch_grouped(lib, x, y, xg, yg, xid, yid, dtype, thr):
    return _launch_tile(lib, x, y, _grouped_ints(xg, yg, xid, yid), dtype,
                        thr)


def nng_tile_grouped_cuda(x, y, xg, yg, xid, yid, eps: float):
    """The grouped L2 CUDA kernel: x (q, d), y (p, d) fp32, groups and ids
    (q,) / (p,) int32, all contiguous on one CUDA device -> (cnt (q,) int32,
    bits (q, ceil(p/32)) int32), the function of ``nng_tile_grouped_ref``.
    Any q, p and d: the kernel masks ragged edges, and bits past column
    p - 1 are zero.

    One launch of a persistent grid (``csrc/l2_pipe.cuh``) over the live
    tiles of ``grouped_tile_plan``; the words of dead tiles stay zero. Its
    d² are those of ``nng_tile_cuda`` bit for bit."""
    q, _, p = _check_tile("nng_tile_grouped_cuda", x, y,
                          _grouped_ints(xg, yg, xid, yid), torch.float32)
    cnt = torch.zeros(q, dtype=torch.int32, device=x.device)
    bits = torch.zeros((q, -(-p // 32)), dtype=torch.int32, device=x.device)
    if q == 0 or p == 0:
        return cnt, bits
    grouped_launch(x, y, xg, yg, xid, yid, *grouped_tile_plan(xg, yg), eps,
                   cnt, bits)
    return cnt, bits


def grouped_launch(x, y, xg, yg, xid, yid, tiles, count, eps: float, cnt,
                   bits) -> None:
    """The launch alone of the grouped L2 kernel on checked operands and
    ``grouped_tile_plan``'s tile list and count: adds the live tiles' hits
    to cnt and stores their words in bits (zero where no live tile
    stores)."""
    (q, d), p = x.shape, y.shape[0]
    xsq, ysq = row_norm_scratch(q, p, x.device)
    launch = _build.entry("nng_tile_grouped")
    with torch.cuda.device(x.device):
        code = launch(x.data_ptr(), y.data_ptr(), xg.data_ptr(),
                      yg.data_ptr(), xid.data_ptr(), yid.data_ptr(),
                      tiles.data_ptr(), count.data_ptr(), cnt.data_ptr(),
                      bits.data_ptr(), xsq.data_ptr(), ysq.data_ptr(), q, p,
                      d, eps2_f32(eps), sm_count(x.device.index),
                      torch.cuda.current_stream().cuda_stream)
    _build.check("nng_tile_grouped", code)
    nng_tile_grouped_cuda.launches += 1


def nng_tile_grouped_hamming_cuda(x, y, xg, yg, xid, yid, eps: float):
    """The grouped Hamming CUDA kernel over int32 words, as
    ``nng_tile_grouped_cuda`` otherwise."""
    cnt, bits, launched = _launch_grouped("nng_tile_grouped_hamming", x, y,
                                          xg, yg, xid, yid, torch.int32,
                                          eps_int(eps))
    nng_tile_grouped_hamming_cuda.launches += launched
    return cnt, bits


def nng_tile_grouped_l1_cuda(x, y, xg, yg, xid, yid, eps: float):
    """The grouped L1 CUDA kernel, as ``nng_tile_grouped_cuda`` otherwise."""
    cnt, bits, launched = _launch_grouped("nng_tile_grouped_l1", x, y, xg,
                                          yg, xid, yid, torch.float32,
                                          float(np.float32(eps)))
    nng_tile_grouped_l1_cuda.launches += launched
    return cnt, bits


# the tile of the pipelined L2 core (csrc/l2_pipe.cuh): query rows x
# candidate columns
PIPE_TILE = (64, 256)


def grouped_tile_plan(x_group, y_group):
    """The grouped L2 kernel's tile list for one launch, on the groups'
    device and without a host sync: (tiles (T,) int32, the ``PIPE_TILE``
    tiles of the (q, p) output numbered row after row, the live ones
    first; count (1,) int32, the live ones). A tile is live where the
    valid-group [min, max] ranges of its rows and columns intersect
    (``ops.grouped_block_active`` at that geometry on the tile-padded
    groups, -1 as padding): every pair of the same valid group lies in
    one. The rows stay in the caller's order, which the callers sort by
    cell."""
    from .ops import _pad_rows, grouped_block_active   # ops imports this
    tq, tp = PIPE_TILE
    live = grouped_block_active(_pad_rows(x_group, tq, -1)[0],
                                _pad_rows(y_group, tp, -1)[0], tq, tp)
    return live_tiles_first(live.reshape(-1))


def ghost_local_keys(x_gbits, y_group):
    """Each row's ghost words restricted to the cells that occur in
    ``y_group`` (>= 0): (q, mw) int32, the words a ghost tile against those
    rows can use. A launch's local cells are its rank's, so the keys are
    computed per launch."""
    mw = x_gbits.shape[1]
    # a count of each cell's columns (index_add_: no host sync, unlike a
    # boolean mask's nonzero)
    seen = torch.zeros(mw * 32, dtype=torch.int32, device=x_gbits.device)
    seen.index_add_(0, y_group.clamp_min(0).long(),
                    (y_group >= 0).to(torch.int32))
    return x_gbits & pack_words((seen > 0)[None])


def _key_order(key):
    """The stable order of (q, mw) int32 keys: the zero keys last, the
    others ascending as unsigned numbers with word 0 the most significant
    (stable argsorts over the words, the last word first, so any mw
    works; word 0's pass carries the zero flag above its 32 bits). Rows
    with equal keys end up contiguous."""
    order = torch.arange(key.shape[0], device=key.device)
    zero = (key == 0).all(1).to(torch.int64) << 32
    for w in reversed(range(key.shape[1])):
        word = key[order, w].to(torch.int64) & 0xFFFFFFFF
        if w == 0:
            word |= zero[order]
        order = order[torch.argsort(word, stable=True)]
    return order


def ghost_row_order(x_gbits, y_group):
    """The ghost L2 kernel's row order for one launch: a permutation
    (q,) int64 of x's rows that sorts them by ``ghost_local_keys`` (equal
    keys contiguous, rows with no local ghost cell last). Against y sorted
    by cell, a 64-row tile of that order then has ghost bits in few y
    tiles' cell ranges, so most tiles are dead."""
    return _key_order(ghost_local_keys(x_gbits, y_group))


def ghost_tile_plan(x_gbits, y_group):
    """What the ghost L2 kernel's launch needs besides x and y, all on
    x_gbits' device and without a host sync: (rows (q,) int64, the
    ``ghost_row_order``; keys (q, mw) int32, the local keys in that order;
    tiles (T,) int32, the ``PIPE_TILE`` tiles of the (q, p) output
    numbered row after row, the live ones first (``ops.ghost_block_active``
    at that geometry on the ordered keys: some row has a key bit inside
    the tile's valid y-cell range); count (1,) int32, the live ones)."""
    from .ops import _pad_rows, ghost_block_active   # ops imports this
    tq, tp = PIPE_TILE
    key = ghost_local_keys(x_gbits, y_group)
    rows = _key_order(key)
    keys = key[rows].contiguous()
    live = ghost_block_active(_pad_rows(keys, tq)[0],
                              _pad_rows(y_group, tp, -1)[0], tq, tp)
    return (rows, keys) + live_tiles_first(live.reshape(-1))


def live_tiles_first(live):
    """A persistent walk's tile list from the (T,) bool live flags of
    tiles 0 .. T - 1: (tiles (T,) int32, the live ones first and then the
    dead ones, each in ascending order; count (1,) int32, the live ones),
    on the flags' device with no host sync. A stable partition by
    scatter: live tile t goes after the live tiles before it, dead tile t
    after all live ones and the dead ones before it."""
    n = live.shape[0]
    ramp = torch.arange(1, n + 1, dtype=torch.int32, device=live.device)
    n_live = torch.cumsum(live, 0, dtype=torch.int32)
    count = n_live[-1:]
    pos = torch.where(live, n_live, count + ramp - n_live) - 1
    tiles = torch.empty_like(ramp).scatter_(0, pos.long(), ramp - 1)
    return tiles, count


def nng_tile_ghost_cuda(x, y, x_gbits, y_group, eps: float):
    """The ghost L2 CUDA kernel: x (q, d), y (p, d) fp32, x_gbits (q, mw)
    int32 words (any mw), y_group (p,) int32, all contiguous on one CUDA
    device -> (cnt (q,) int32, bits (q, ceil(p/32)) int32), the function of
    ``nng_tile_ghost_ref``, in x's row order. Any q, p and d: the kernel
    masks ragged edges, and bits past column p - 1 are zero.

    One launch of a persistent grid (``csrc/l2_pipe.cuh``) over the live
    tiles of ``ghost_tile_plan`` on x gathered in ``ghost_row_order``; the
    words of dead tiles stay zero. Its d² are those of ``nng_tile_cuda``
    bit for bit."""
    return _ghost_pipe("nng_tile_ghost", x, y, x_gbits, y_group, eps)


def _ghost_pipe(lib: str, x, y, x_gbits, y_group, eps: float):
    """Check the operands of pipelined ghost kernel ``lib`` (fp32 x and y)
    and launch it once on ``ghost_tile_plan``'s order and live tiles ->
    (cnt, bits) in x's row order."""
    q, _, p = _check_tile(f"{lib}_cuda", x, y, (("y_group", y_group, "p"),),
                          torch.float32, x_gbits)
    cnt = torch.zeros(q, dtype=torch.int32, device=x.device)
    bits = torch.zeros((q, -(-p // 32)), dtype=torch.int32, device=x.device)
    if q == 0 or p == 0:
        return cnt, bits
    rows, keys, tiles, count = ghost_tile_plan(x_gbits, y_group)
    ghost_launch(lib, x[rows], y, keys, y_group, rows.to(torch.int32),
                 tiles, count, eps, cnt, bits)
    return cnt, bits


def ghost_launch(lib: str, xs, y, keys, y_group, rows, tiles, count,
                 eps: float, cnt, bits) -> None:
    """The launch alone of pipelined ghost kernel ``lib``
    ("nng_tile_ghost": L2, with fp32 scratch for the rows' norms and the
    threshold ``eps2_f32(eps)``; "nng_tile_ghost_l1": L1, no norms, eps in
    fp32), on ``ghost_tile_plan``'s operands: xs = x[rows] contiguous,
    keys, rows as int32, the tile list and its count; adds the live tiles'
    hits to cnt and stores their words in bits, both in x's row order
    (zero where no live tile stores)."""
    q, d = xs.shape
    p = y.shape[0]
    l2 = lib == "nng_tile_ghost"
    norms = row_norm_scratch(q, p, xs.device) if l2 else ()
    thr = eps2_f32(eps) if l2 else float(np.float32(eps))
    launch = _build.entry(lib)
    with torch.cuda.device(xs.device):
        code = launch(xs.data_ptr(), y.data_ptr(), keys.data_ptr(),
                      y_group.data_ptr(), rows.data_ptr(), tiles.data_ptr(),
                      count.data_ptr(), cnt.data_ptr(), bits.data_ptr(),
                      *(t.data_ptr() for t in norms), q, p, d, keys.shape[1],
                      thr, sm_count(xs.device.index),
                      torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code)
    _GHOST_PIPE[lib].launches += 1


def nng_tile_ghost_hamming_cuda(x, y, x_gbits, y_group, eps: float):
    """The ghost Hamming CUDA kernel over int32 words, as
    ``nng_tile_ghost_cuda`` otherwise."""
    cnt, bits, launched = _launch_tile("nng_tile_ghost_hamming", x, y,
                                       (("y_group", y_group, "p"),),
                                       torch.int32, eps_int(eps),
                                       gbits=x_gbits)
    nng_tile_ghost_hamming_cuda.launches += launched
    return cnt, bits


def nng_tile_ghost_l1_cuda(x, y, x_gbits, y_group, eps: float):
    """The ghost L1 CUDA kernel, as ``nng_tile_ghost_cuda`` otherwise: one
    launch over the live tiles of ``ghost_tile_plan`` on
    ``csrc/l1_pipe.cuh``, whose d are ``nng_tile_l1_cuda``'s bit for
    bit."""
    return _ghost_pipe("nng_tile_ghost_l1", x, y, x_gbits, y_group, eps)


nng_tile_cuda.launches = 0
nng_tile_hamming_cuda.launches = 0
nng_tile_l1_cuda.launches = 0
nng_tile_grouped_cuda.launches = 0
nng_tile_grouped_hamming_cuda.launches = 0
nng_tile_grouped_l1_cuda.launches = 0
nng_tile_ghost_cuda.launches = 0
nng_tile_ghost_hamming_cuda.launches = 0
nng_tile_ghost_l1_cuda.launches = 0

# the pipelined ghost kernels' wrappers, whose launch counts ghost_launch
# keeps
_GHOST_PIPE = {"nng_tile_ghost": nng_tile_ghost_cuda,
               "nng_tile_ghost_l1": nng_tile_ghost_l1_cuda}
