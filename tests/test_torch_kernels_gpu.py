"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA device:
the kernels have no CPU mode. The file imports neither JAX nor the
reference package, so it runs on a GPU machine that has neither:

    python -m pytest -m gpu tests/test_torch_kernels_gpu.py

``gap_safe_eps``, ``random_words``, ``hamming_points``, ``frontier_case``,
``range_deltas``, ``grouped_case`` and ``ghost_case`` are shared with the
CPU tests in ``test_torch_kernels.py`` (``frontier_case`` also with
``test_torch_frontier_plan.py``), ``sqdist_bound`` and ``count_eps``
with ``test_torch_distance_kernels.py``.

Tolerances: the Hamming kernels are exact integer arithmetic and must equal
their plain versions bit for bit on every input. The float kernels must
equal theirs on inputs whose every decision lies at least 1e-4·eps from its
threshold in float64: two fp32 summation orders differ by a few d·u·eps
(u = 2^-24; 7.6e-6·eps at d = 128), far inside that gap. The dense squared
distances must lie within 2·(d + 2)·u·(‖x_i‖² + ‖y_j‖²) of their plain
version's and of float64, elementwise.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.brute import brute_force_graph
from repro_torch.core.distributed import make_nng_mesh
from repro_torch.core.metrics import ieee_fp32
from repro_torch.data import synthetic_pointset
from repro_torch.kernels import bits_epilogue as tbe
from repro_torch.kernels import nng_tile as tnt
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import tree_frontier as ttf
from repro_torch.kernels.eps_count import eps_count_cuda, eps_count_plain
from repro_torch.kernels.pairwise_hamming import pairwise_hamming_cuda
from repro_torch.kernels.pairwise_l2 import (l2_chain_d2_cuda,
                                             pairwise_sqdist_cuda)
from repro_torch.nng import build_nng

SENTINEL = 2**31 - 1
U32 = 2.0 ** -24        # fp32 unit roundoff


def pair_dists(x, y, metric="euclidean"):
    """(q, p) float64 true distances: euclidean, manhattan, or hamming over
    uint32 word rows."""
    if metric == "hamming":
        xor = np.bitwise_xor(x.astype(np.uint32)[:, None, :],
                             y.astype(np.uint32)[None, :, :])
        return np.unpackbits(xor.view(np.uint8), axis=-1).sum(-1).astype(
            np.float64)
    diff = x.astype(np.float64)[:, None, :] - y.astype(np.float64)[None, :, :]
    if metric == "manhattan":
        return np.abs(diff).sum(-1)
    return np.sqrt((diff ** 2).sum(-1))


def gap_safe_eps(x, y, quantile=None, rel=1e-4, metric="euclidean",
                 window=200, target=None):
    """An eps in the widest gap between float64 pair distances within
    ``window`` pairs of the quantile (or of the distance ``target``), at
    least ``rel``·eps away from every pair."""
    d = pair_dists(x, y, metric).ravel()
    d.sort()
    k = (int(quantile * len(d)) if target is None
         else int(np.searchsorted(d, target)))
    lo, hi = max(k - window, 0), min(k + window, len(d) - 1)
    j = lo + int(np.argmax(d[lo + 1:hi + 1] - d[lo:hi]))
    eps = 0.5 * float(d[j] + d[j + 1])
    assert np.abs(d - eps).min() > rel * eps, "no gap-safe eps"
    return eps


def random_words(seed, m, w):
    """Rows of mixed density: dense, sparse, empty and full."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, size=(m, w), dtype=np.uint64).astype(np.uint32)
    sparse = words[1::3] & np.roll(words[1::3], 1, 1) & np.roll(words[1::3], 2, 1)
    words[1::3] = sparse & np.roll(sparse, 3, 1)
    words[::7] = 0
    words[5::11] = 0xFFFFFFFF
    return words


def hamming_points(rng, n, w, flip=0.08):
    """(n, w) uint32 word rows in 4 clusters, each point its centre with
    each bit flipped at rate ``flip``. Two centres are all ones and all
    sign bits (0xFFFFFFFF, 0x80000000: the words a uint32 -> int32 value
    cast would break), and some rows are all zero or all ones."""
    ctrs = rng.integers(0, 2**32, size=(4, w), dtype=np.uint64).astype(
        np.uint32)
    ctrs[0] = 0xFFFFFFFF
    ctrs[1] = 0x80000000
    flips = np.packbits(rng.random((n, w, 32)) < flip, axis=-1,
                        bitorder="little").view(np.uint32)[..., 0]
    pts = ctrs[rng.integers(0, 4, n)] ^ flips
    pts[3::17] = 0
    pts[5::19] = 0xFFFFFFFF
    return pts


def frontier_case(nq, n, d, seed, margin=1e-4, metric="euclidean"):
    """One frontier level's inputs (numpy) under ``metric``. Float metrics:
    every decision lies at least ``margin``·eps from its threshold in
    float64 — eps sits in a gap of the pair distances (leaf test), and each
    internal node's radius is redrawn until no d ± radius lies near eps
    (inclusion and expansion tests). Hamming (d words a row): exact, so eps
    is a pair distance plus 0.5 (``int(eps)`` truncates) and the radii are
    any fp32 values (the kernels truncate them). Active bits are random,
    with an all-zero block (a whole 128 x 128 kernel block where the shape
    has one) and all-zero rows."""
    rng = np.random.default_rng(seed)
    if metric == "hamming":
        q = hamming_points(rng, nq, d)
        c = hamming_points(rng, n, d)
    else:
        q = rng.normal(size=(nq, d)).astype(np.float32)
        c = rng.normal(size=(n, d)).astype(np.float32)
    dist = pair_dists(q, c, metric)
    if metric == "hamming":
        eps = float(np.quantile(dist, 0.05)) + 0.5
    else:
        # low in the distance distribution where pairs are many: gaps are
        # wider
        eps = gap_safe_eps(q, c, 0.01 if nq * n < 200_000 else 3e-4,
                           rel=margin, metric=metric)
    leaf = (rng.random(n) < 0.4).astype(np.int32)
    rad = np.zeros(n, np.float32)
    for j in np.flatnonzero(leaf == 0):
        while True:
            r = np.float32(abs(rng.normal()) * eps)
            near = np.minimum(np.abs(dist[:, j] + r - eps),
                              np.abs(dist[:, j] - r - eps))
            if metric == "hamming" or near.min() > margin * eps:
                rad[j] = r
                break
    act = rng.random((nq, n)) < 0.7
    act[:min(128, nq // 2), :min(128, n // 2)] = False
    act[nq // 2::5] = False
    return q, c, rad, leaf, act, eps


def range_deltas(nq, nl, seed):
    """±1 leaf-range deltas (with the traversal's trailing overflow column),
    leaf ids with SENTINEL slots, and query ids that hit some leaf ids."""
    rng = np.random.default_rng(seed)
    delta = np.zeros((nq, nl + 1), np.int32)
    for i in range(nq):
        for _ in range(int(rng.integers(0, 6))):
            lo, hi = np.sort(rng.integers(0, nl + 1, size=2))
            delta[i, lo] += 1
            delta[i, hi] -= 1
    delta[::9] = rng.integers(-1, 2, size=delta[::9].shape)
    leaf_ids = rng.permutation(10 * nl)[:nl].astype(np.int32)
    leaf_ids[::7] = SENTINEL
    qids = rng.choice(leaf_ids[leaf_ids != SENTINEL], size=nq).astype(np.int32)
    qids[::3] = rng.integers(10 * nl, 20 * nl, size=len(qids[::3]))
    return delta, leaf_ids, qids


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("q,p,d", [(37, 64, 3), (1000, 777, 100),
                                   (512, 1024, 128)])
def test_nng_tile_cuda_matches_plain(cuda_device, q, p, d):
    rng = np.random.default_rng(q)
    x = rng.normal(size=(q, d)).astype(np.float32)
    y = rng.normal(size=(p, d)).astype(np.float32)
    yv = (rng.random(p) > 0.1).astype(np.int32)
    # low in the distance distribution, where pairs are sparse enough for a
    # gap of 1e-4·eps to exist
    eps = gap_safe_eps(x, y, 0.001)
    xt, yt, yvt = (torch.from_numpy(a).to(cuda_device) for a in (x, y, yv))
    cnt, bits = tnt.nng_tile_cuda(xt, yt, yvt, eps)
    rc, rb = tops.nng_tile_bits(xt.cpu(), yt.cpu(), yvt.cpu(), eps)
    assert int(rc.sum()) > 0
    assert torch.equal(cnt.cpu(), rc)
    assert torch.equal(bits.cpu(), rb)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 7, 64, 300])
def test_bits_to_cols_cuda_matches_plain(cuda_device, k):
    words = torch.from_numpy(random_words(k, 500, 37).view(np.int32))
    got = tbe.bits_to_cols_cuda(words.to(cuda_device), k)
    assert torch.equal(got.cpu(), tbe.bits_to_cols_ref(words, k))


@pytest.mark.gpu
@pytest.mark.parametrize("nq,n,d", [(7, 32, 5), (300, 544, 16), (45, 100, 4),
                                    (1000, 1300, 128)])
def test_tree_frontier_cuda_matches_plain(cuda_device, nq, n, d):
    q, c, rad, leaf, act, eps = frontier_case(nq, n, d, nq + n)
    tq, tc, trad, tleaf = (torch.from_numpy(a) for a in (q, c, rad, leaf))
    tact = tnt.pack_words(torch.from_numpy(np.pad(act, ((0, 0),
                                                         (0, -n % 32)))))
    e0, x0 = tops.tree_frontier_step(tq, tc, trad, tleaf, tact, eps)
    e1, x1 = ttf.tree_frontier_cuda(*(a.to(cuda_device) for a in
                                      (tq, tc, trad, tleaf, tact)), eps)
    assert int(tnt.unpack_words(e0).sum()) > 0
    assert int(tnt.unpack_words(x0).sum()) > 0
    assert torch.equal(e1.cpu(), e0) and torch.equal(x1.cpu(), x0)


@pytest.mark.gpu
def test_tree_frontier_cuda_all_inactive(cuda_device):
    q = torch.randn(300, 16, device=cuda_device)
    c = torch.randn(544, 16, device=cuda_device)
    act = torch.zeros((300, 17), dtype=torch.int32, device=cuda_device)
    e, x = ttf.tree_frontier_cuda(
        q, c, torch.ones(544, device=cuda_device),
        torch.zeros(544, dtype=torch.int32, device=cuda_device), act, 5.0)
    assert not e.any() and not x.any()


# (nq, n, d, pattern) for the pipelined L2 and L1 frontiers (64 x 256 tiles
# over frontier_tile_plan's list): one live tile ("one"), no active word
# ("none": a zero count), ragged nq and n, d % 4 != 0 (the cp.async copies)
# and d % 4 == 0 (TMA), more tiles than the grid's resident blocks
# ("dense", 33 x 17 = 561 tiles), and the sparse random mask ("random")
PIPE_FRONTIER_CASES = [(200, 700, 17, "one"), (200, 700, 16, "one"),
                       (130, 300, 9, "none"), (130, 300, 9, "random"),
                       (65, 257, 12, "random"), (1000, 1300, 33, "random"),
                       (1000, 1300, 128, "random"), (2100, 4100, 5, "dense")]


def pipe_frontier_inputs(metric, nq, n, d, pattern):
    """A frontier case whose active mask follows ``pattern``, as tensors:
    (q, c, rad, leaf, act words, eps)."""
    q, c, rad, leaf, act, eps = frontier_case(nq, n, d, nq + n + d,
                                              metric=metric)
    if pattern == "one":
        keep = np.zeros_like(act)
        keep[64:128, 256:512] = True          # tile (1, 1) of 64 x 256
        act &= keep
    elif pattern == "none":
        act[:] = False
    elif pattern == "dense":
        act[:] = True
    words = tnt.pack_words(torch.from_numpy(np.pad(act, ((0, 0),
                                                         (0, -n % 32)))))
    return tuple(as_words(a) for a in (q, c, rad, leaf)) + (words, eps)


PIPE_FRONTIERS = {"euclidean": ttf.tree_frontier_cuda,
                  "manhattan": ttf.tree_frontier_l1_cuda,
                  "hamming": ttf.tree_frontier_hamming_cuda}


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["euclidean", "manhattan", "hamming"])
@pytest.mark.parametrize("nq,n,d,pattern", PIPE_FRONTIER_CASES)
def test_pipe_frontier_cuda_matches_plain(cuda_device, metric, nq, n, d,
                                          pattern):
    """tree_frontier, tree_frontier_l1 and tree_frontier_hamming (one
    launch over the live tiles; d is the Hamming rows' words) equal their
    plain versions bit for bit in emit and expand, and launch once."""
    kern = PIPE_FRONTIERS[metric]
    *ops, eps = pipe_frontier_inputs(metric, nq, n, d, pattern)
    tiles, count = ttf.frontier_tile_plan(ops[4], 64, 8)
    want_live = {"one": 1, "none": 0, "dense": len(tiles)}.get(pattern)
    assert want_live is None or int(count[0]) == want_live
    e0, x0 = tops.tree_frontier_step(*ops, eps, metric=metric)
    before = kern.launches
    e1, x1 = kern(*(a.to(cuda_device) for a in ops), eps)
    assert kern.launches == before + 1
    if pattern != "none":
        assert int(tnt.unpack_words(e0).sum()) > 0
        assert int(tnt.unpack_words(x0).sum()) > 0
    assert torch.equal(e1.cpu(), e0) and torch.equal(x1.cpu(), x0)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["euclidean", "manhattan", "hamming"])
@pytest.mark.parametrize("q,p,d", [(300, 700, 17), (1000, 777, 128),
                                   (129, 300, 9)])
def test_pipe_frontier_leaf_test_is_the_tiles(cuda_device, metric, q, p, d):
    """With every node a leaf and every pair active, the frontier's emit
    words equal the ε-tile's hit words bit for bit at an eps exactly on
    one pair's fp32 distance (nng_tile's d² on l2_pipe.cuh; nng_tile_l1's
    d on l1_tile.cuh; Hamming: an integer pair distance, nng_tile_hamming's
    on hamming_tile.cuh): the frontiers' per-pair arithmetic is the
    tiles'."""
    g = torch.Generator(device=cuda_device).manual_seed(q + p + d)
    x = torch.randn(q, d, generator=g, device=cuda_device)
    y = torch.randn(p, d, generator=g, device=cuda_device)
    ones = torch.ones(p, dtype=torch.int32, device=cuda_device)
    if metric == "hamming":
        x, y = (torch.randint(-2**31, 2**31 - 1, (r, d), generator=g,
                              dtype=torch.int32, device=cuda_device)
                for r in (q, p))
        eps = float(torch.quantile(tnt.hamming_dist(x, y).flatten()[
            :1 << 20].float(), 0.02))
        _, bits = tnt.nng_tile_hamming_cuda(x, y, ones, eps)
        kern = ttf.tree_frontier_hamming_cuda
    elif metric == "euclidean":
        eps = eps_on_pair(pairwise_sqdist_cuda(x, y), 0.02)
        assert eps is not None
        _, bits = tnt.nng_tile_cuda(x, y, ones, eps)
        kern = ttf.tree_frontier_cuda
    else:
        # an fp32 L1 distance of a pair, as the tile computes it
        dist = tnt.l1_dist(x, y)
        eps = float(torch.quantile(dist.flatten()[:1 << 20], 0.02))
        eps = float(dist.flatten()[(dist.flatten() - eps).abs().argmin()])
        _, bits = tnt.nng_tile_l1_cuda(x, y, ones, eps)
        kern = ttf.tree_frontier_l1_cuda
    every = torch.zeros((q, p + (-p % 32)), dtype=torch.bool,
                        device=cuda_device)
    every[:, :p] = True
    act = tnt.pack_words(every)
    emit, expand = kern(x, y, torch.zeros(p, device=cuda_device), ones, act,
                        eps)
    assert int(tnt.unpack_words(bits).sum()) > 0
    assert torch.equal(emit, bits) and not expand.any()


@pytest.mark.gpu
@pytest.mark.parametrize("w", [1, 9, 25, 33])
@pytest.mark.parametrize("nq,n,pattern", [(130, 700, "random"),
                                          (1000, 1300, "random"),
                                          (65, 257, "one"), (200, 700, "one"),
                                          (130, 300, "none"),
                                          (300, 544, "dense")])
def test_hamming_frontier_cuda_word_counts(cuda_device, w, nq, n, pattern):
    """tree_frontier_hamming on the pipelined walk equals its plain version
    bit for bit for w = 1, 9, 25 and 33 words a row (4-byte copies; TMA
    never, as w % 4 != 0), ragged nq and n, one live tile, an all-inactive
    mask (a zero live-tile count) and every pair active."""
    *ops, eps = pipe_frontier_inputs("hamming", nq, n, w, pattern)
    tiles, count = ttf.frontier_tile_plan(ops[4], 64, 8)
    want_live = {"one": 1, "none": 0, "dense": len(tiles)}.get(pattern)
    assert want_live is None or int(count[0]) == want_live
    e0, x0 = tops.tree_frontier_step(*ops, eps, metric="hamming")
    kern = ttf.tree_frontier_hamming_cuda
    before = kern.launches
    e1, x1 = kern(*(a.to(cuda_device) for a in ops), eps)
    assert kern.launches == before + 1
    if pattern in ("random", "dense"):
        assert int(tnt.unpack_words(e0).sum()) > 0
        assert int(tnt.unpack_words(x0).sum()) > 0
    if pattern == "none":
        assert not e1.any() and not x1.any()
    assert torch.equal(e1.cpu(), e0) and torch.equal(x1.cpu(), x0)


@pytest.mark.gpu
@pytest.mark.parametrize("nq,nl", [(5, 32), (130, 544), (1000, 4096)])
def test_leaf_range_pack_cuda_matches_plain(cuda_device, nq, nl):
    delta, leaf_ids, qids = (torch.from_numpy(a) for a in
                             range_deltas(nq, nl, nq + nl))
    c0, b0 = tbe.leaf_range_pack_ref(delta[:, :nl], leaf_ids, qids)
    c1, b1 = tbe.leaf_range_pack_cuda(delta.to(cuda_device),
                                      leaf_ids.to(cuda_device),
                                      qids.to(cuda_device))
    assert int(c0.sum()) > 0
    assert torch.equal(c1.cpu(), c0) and torch.equal(b1.cpu(), b0)


# ---------------------------------------------------------------------------
# the Hamming and L1 kernels
# ---------------------------------------------------------------------------

def tile_case(metric, q, p, d, seed):
    """x, y, y_valid (numpy) and an eps for one ε-tile under ``metric``:
    Hamming word rows (d words) with eps a pair distance plus 0.5, or fp32
    rows with a gap-safe eps low in the distance distribution."""
    rng = np.random.default_rng(seed)
    if metric == "hamming":
        x, y = hamming_points(rng, q, d), hamming_points(rng, p, d)
        eps = float(np.quantile(pair_dists(x, y, metric), 0.1)) + 0.5
    else:
        x = rng.normal(size=(q, d)).astype(np.float32)
        y = rng.normal(size=(p, d)).astype(np.float32)
        eps = gap_safe_eps(x, y, 0.01 if q * p < 200_000 else 0.001,
                           metric=metric)
    yv = (rng.random(p) > 0.1).astype(np.int32)
    return x, y, yv, eps


def as_words(a):
    """numpy uint32 words -> the port's int32 tensor (a bit view)."""
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


TILE_KERNELS = {"hamming": tnt.nng_tile_hamming_cuda,
                "manhattan": tnt.nng_tile_l1_cuda}
FRONTIER_KERNELS = {"hamming": ttf.tree_frontier_hamming_cuda,
                    "manhattan": ttf.tree_frontier_l1_cuda}


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["hamming", "manhattan"])
@pytest.mark.parametrize("q,p,d", [(37, 64, 3), (1000, 777, 25),
                                   (512, 1024, 128), (130, 300, 9)])
def test_metric_tile_cuda_matches_plain(cuda_device, metric, q, p, d):
    """Hamming bit for bit; L1 off the knife (gap-safe eps)."""
    x, y, yv, eps = tile_case(metric, q, p, d, q + d)
    xt, yt, yvt = (as_words(a) for a in (x, y, yv))
    before = TILE_KERNELS[metric].launches
    cnt, bits = TILE_KERNELS[metric](*(t.to(cuda_device) for t in
                                       (xt, yt, yvt)), eps)
    assert TILE_KERNELS[metric].launches == before + 1
    rc, rb = tops.nng_tile_bits(xt, yt, yvt, eps, metric=metric)
    assert int(rc.sum()) > 0
    assert torch.equal(cnt.cpu(), rc)
    assert torch.equal(bits.cpu(), rb)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["hamming", "manhattan"])
@pytest.mark.parametrize("nq,n,d", [(7, 32, 5), (300, 544, 16), (45, 100, 3),
                                    (1000, 1300, 25)])
def test_metric_frontier_cuda_matches_plain(cuda_device, metric, nq, n, d):
    q, c, rad, leaf, act, eps = frontier_case(nq, n, d, nq + n,
                                              metric=metric)
    tq, tc, trad, tleaf = (as_words(a) for a in (q, c, rad, leaf))
    tact = tnt.pack_words(torch.from_numpy(np.pad(act, ((0, 0),
                                                         (0, -n % 32)))))
    e0, x0 = tops.tree_frontier_step(tq, tc, trad, tleaf, tact, eps,
                                     metric=metric)
    e1, x1 = FRONTIER_KERNELS[metric](*(a.to(cuda_device) for a in
                                        (tq, tc, trad, tleaf, tact)), eps)
    assert int(tnt.unpack_words(e0).sum()) > 0
    assert int(tnt.unpack_words(x0).sum()) > 0
    assert torch.equal(e1.cpu(), e0) and torch.equal(x1.cpu(), x0)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["hamming", "manhattan"])
def test_metric_frontier_cuda_all_inactive(cuda_device, metric):
    q, c, rad, leaf, _, eps = frontier_case(300, 544, 9, 3, metric=metric)
    act = torch.zeros((300, 17), dtype=torch.int32, device=cuda_device)
    e, x = FRONTIER_KERNELS[metric](
        *(as_words(a).to(cuda_device) for a in (q, c, rad, leaf)), act, eps)
    assert not e.any() and not x.any()


# ---------------------------------------------------------------------------
# the grouped tiles (the landmark engine's cell-scoped W x W and G x W)
# ---------------------------------------------------------------------------

def grouped_case(metric, q, p, d, seed, pattern="random"):
    """x, y, groups, ids (numpy) and an eps for one grouped tile.

    ``pattern``: "random" groups in [-1, 6) (-1 is padding); "sorted"
    groups in [0, 50), ascending, with trailing padding rows, as the
    engine's cell-sorted buffers; "disjoint" x groups in [0, 4) and y
    groups in [10, 14), so no pair may hit; "one" group 0 on x rows
    [0, 40) and y rows [0, 200) and padding elsewhere, so one 64 x 256
    tile is live; "none" every x row padding; "single" every row of both
    sides in group 0. The first 4 x ids equal the first 4 y ids (the
    self-pair exclusion must fire). Points as
    and eps as ``tile_case``, but on a small float tile eps higher in the
    distance distribution (only one pair in several shares a group)."""
    x, y, _, eps = tile_case(metric, q, p, d, seed)
    if metric != "hamming" and q * p < 20_000:
        eps = gap_safe_eps(x, y, 0.05, metric=metric, window=20)
    rng = np.random.default_rng(seed + 1)
    if pattern == "random":
        xg = rng.integers(-1, 6, size=q)
        yg = rng.integers(-1, 6, size=p)
    elif pattern == "sorted":
        xg = np.sort(rng.integers(0, 50, size=q))
        yg = np.sort(rng.integers(0, 50, size=p))
        xg[q - q // 15:] = -1
        yg[p - p // 17:] = -1
    elif pattern == "one":
        xg, yg = np.full(q, -1), np.full(p, -1)
        xg[:40], yg[:200] = 0, 0
    elif pattern == "none":
        xg, yg = np.full(q, -1), rng.integers(0, 6, size=p)
    elif pattern == "single":
        xg, yg = np.zeros(q, np.int32), np.zeros(p, np.int32)
    else:
        xg = rng.integers(0, 4, size=q)
        yg = rng.integers(10, 14, size=p)
    xid = np.arange(q, dtype=np.int32)
    yid = np.arange(37, 37 + p, dtype=np.int32)
    xid[:4] = yid[:4]
    return (x, y, xg.astype(np.int32), yg.astype(np.int32), xid, yid, eps)


GROUPED_KERNELS = {"euclidean": tnt.nng_tile_grouped_cuda,
                   "hamming": tnt.nng_tile_grouped_hamming_cuda,
                   "manhattan": tnt.nng_tile_grouped_l1_cuda}


def on_card(t, dev, shift=None):
    """A CPU tensor's copy on the card, contiguous: at an aligned base
    (``shift`` None), in rows 1.. of a (rows + 1, d) matrix ("row": not
    16-byte aligned unless d % 4 == 0) or one element past the base
    ("elem"): both take the L2 pipelined kernels' 4-byte copies."""
    if shift is None:
        return t.to(dev)
    r, d = t.shape
    if shift == "row":
        out = torch.empty((r + 1, d), dtype=t.dtype, device=dev)[1:]
    else:
        out = torch.empty(r * d + 1, dtype=t.dtype, device=dev)[1:].view(r, d)
    assert out.is_contiguous() and out.data_ptr() % 16
    return out.copy_(t)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["euclidean", "hamming", "manhattan"])
@pytest.mark.parametrize("q,p,d,pattern,shift", [
    (37, 64, 3, "random", None), (1000, 777, 25, "random", None),
    (512, 1024, 128, "random", None), (600, 1200, 9, "sorted", None),
    (300, 515, 40, "disjoint", None), (300, 600, 16, "one", None),
    (300, 600, 16, "none", None), (2100, 4100, 3, "single", None),
    (600, 1200, 17, "sorted", "row"), (512, 1024, 128, "random", "elem")])
def test_grouped_tile_cuda_matches_plain(cuda_device, metric, q, p, d,
                                         pattern, shift):
    """Hamming bit for bit; L2 and L1 off the knife (gap-safe eps). The
    all-disjoint and all-padding patterns store zero words everywhere. The
    L2 kernel's live-tile list (``grouped_tile_plan``) holds one tile for
    "one", none for "disjoint" and "none", and more than the resident
    blocks for "single"; "row" and "elem" operands take its 4-byte copies,
    aligned ones at d % 4 == 0 its TMA copies."""
    case = grouped_case(metric, q, p, d, q + d, pattern)
    args = [as_words(a) for a in case[:6]]
    eps = case[6]
    kern = GROUPED_KERNELS[metric]
    before = kern.launches
    cnt, bits = kern(on_card(args[0], cuda_device, shift),
                     on_card(args[1], cuda_device, shift),
                     *(t.to(cuda_device) for t in args[2:]), eps)
    assert kern.launches == before + 1
    rc, rb, _, _ = tops.nng_tile_bits_grouped(*args, eps, metric=metric)
    assert torch.equal(cnt.cpu(), rc)
    assert torch.equal(bits.cpu(), rb)
    if pattern in ("disjoint", "none"):
        assert not bits.any() and not cnt.any()
    else:
        assert int(rc.sum()) > 0
    if metric == "euclidean":
        live = int(tnt.grouped_tile_plan(args[2].to(cuda_device),
                                         args[3].to(cuda_device))[1][0])
        resident = 2 * tnt.sm_count(cuda_device.index or 0)
        assert {"one": live == 1, "disjoint": live == 0, "none": live == 0,
                "single": live > resident}.get(pattern, live > 0)


# ---------------------------------------------------------------------------
# the ghost tiles (the landmark engine's ghost ring)
# ---------------------------------------------------------------------------

def pack_cells(mask):
    """(q, m) bool cell sets -> (q, ceil(m/32)) uint32 words, bit c of word
    c // 32 (the ``pack_words`` layout)."""
    q, m = mask.shape
    padded = np.zeros((q, -(-m // 32) * 32), bool)
    padded[:, :m] = mask
    return np.packbits(padded, axis=1, bitorder="little").view(np.uint32)


def ghost_case(metric, q, p, d, m, seed, pattern="random"):
    """x, y, x_gbits (uint32 words), y_group (numpy) and an eps for one
    ghost tile over ``m`` cells.

    ``pattern``: "random" y cells in [-1, m) (-1 is padding) and x cell sets
    of density 0.3; "sorted" y cells ascending with trailing padding, as
    the engine's cell-sorted W, and x sets of 1-3 cells near row i's
    share of the cells (i·m/q), so that row blocks see few cells; "disjoint" y cells in [m/2, m) and x sets inside [0, m/2), so no block
    is live; "interleave" sorted y and row i's cells {7i, 7i + 1} mod m,
    so that equal sets interleave in x's order; "zero" y cells even and
    x sets odd, so no row has a bit among y's cells though its words are
    set inside y's cell range; "sparse" sorted y and three cells on every
    20th row only, so that the L2 kernel's ghost order leaves fewer live
    tiles than resident blocks; "one" sorted y and one cell (among the
    first 256 columns' cells) on every seventh of the first 280 rows
    only, so that the ghost order leaves exactly one live 64 x 256 tile
    where p <= 256.
    Points and eps as ``grouped_case``."""
    x, y, _, eps = tile_case(metric, q, p, d, seed)
    if metric != "hamming" and q * p < 20_000:
        eps = gap_safe_eps(x, y, 0.05, metric=metric, window=20)
    rng = np.random.default_rng(seed + 2)
    if pattern == "random":
        yg = rng.integers(-1, m, size=p)
        sets = rng.random((q, m)) < 0.3
    elif pattern in ("sorted", "interleave", "sparse"):
        yg = np.sort(rng.integers(0, m, size=p))
        yg[p - p // 17:] = -1
        sets = np.zeros((q, m), bool)
        for i in range(q):
            if pattern == "sorted":
                near = i * m // q + rng.integers(-2, 3,
                                                 size=rng.integers(1, 4))
            elif pattern == "interleave":
                near = np.array([7 * i, 7 * i + 1]) % m
            else:
                near = (rng.integers(0, m, 3) if i % 20 == 0
                        else np.zeros(0, np.int64))
            sets[i, np.clip(near, 0, m - 1)] = True
    elif pattern == "one":
        yg = np.sort(rng.integers(0, m, size=p))
        sets = np.zeros((q, m), bool)
        sets[:280:7, yg[min(p, 256) // 2]] = True
    elif pattern == "zero":
        yg = 2 * rng.integers(0, m // 2, size=p)
        sets = rng.random((q, m)) < 0.3
        sets[:, ::2] = False
    else:
        yg = rng.integers(m // 2, m, size=p)
        sets = rng.random((q, m)) < 0.3
        sets[:, m // 2:] = False
    sets[::9] = False                       # rows with no ghost cell
    return x, y, pack_cells(sets), yg.astype(np.int32), eps


GHOST_KERNELS = {"euclidean": tnt.nng_tile_ghost_cuda,
                 "hamming": tnt.nng_tile_ghost_hamming_cuda,
                 "manhattan": tnt.nng_tile_ghost_l1_cuda}


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["euclidean", "hamming", "manhattan"])
@pytest.mark.parametrize("q,p,d,m,pattern", [
    (37, 64, 3, 32, "random"), (1000, 777, 25, 70, "random"),
    (512, 1024, 128, 32, "sorted"), (600, 1200, 9, 70, "sorted"),
    (300, 515, 40, 70, "disjoint"), (260, 300, 7, 2000, "random"),
    (700, 1500, 32, 32, "interleave"), (500, 900, 16, 32, "zero"),
    (400, 1500, 64, 40, "sorted"), (300, 600, 24, 32, "sparse")])
def test_ghost_tile_cuda_matches_plain(cuda_device, metric, q, p, d, m,
                                       pattern):
    """Hamming bit for bit; L2 and L1 off the knife (gap-safe eps). m = 32
    is one ghost word a row, 40 two, 70 three and 2000 sixty-three. The
    all-disjoint and zero-key patterns store zero words everywhere; the
    L2 kernel's rows are reordered inside the launch, its outputs are in
    the caller's order."""
    x, y, gb, yg, eps = ghost_case(metric, q, p, d, m, q + d, pattern)
    args = [as_words(a) for a in (x, y, gb, yg)]
    kern = GHOST_KERNELS[metric]
    before = kern.launches
    cnt, bits = kern(*(t.to(cuda_device) for t in args), eps)
    assert kern.launches == before + 1
    rc, rb, _, _ = tops.nng_tile_bits_ghost(*args, eps, metric=metric)
    assert torch.equal(cnt.cpu(), rc)
    assert torch.equal(bits.cpu(), rb)
    if pattern in ("disjoint", "zero"):
        assert not bits.any() and not cnt.any()
    else:
        assert int(rc.sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("q,p,d,m,pattern", [
    (37, 64, 3, 32, "random"), (1000, 777, 25, 70, "random"),
    (600, 1200, 9, 70, "sorted"), (300, 515, 40, 70, "disjoint"),
    (500, 900, 16, 32, "zero"), (300, 200, 12, 5, "one"),
    (300, 250, 7, 40, "one"), (700, 1500, 32, 32, "interleave"),
    (400, 1500, 64, 40, "sorted"), (300, 600, 24, 32, "sparse")])
def test_ghost_l1_cuda_exact(cuda_device, q, p, d, m, pattern):
    """The L1 ghost kernel (ghost row order, live-tile walk on
    l1_pipe.cuh) equals its plain version bit for bit at an eps exactly on
    a needed pair's fp32 distance, not only off the knife: both sum in
    l1_tile.cuh's order. It also equals nng_tile_l1's hits (the old core,
    l1_tile.cuh) under the plain ghost test. Ragged q, p and d (d % 4 != 0:
    the 4-byte copies), one ghost word a row (m = 5, 32) and more (40,
    70); the disjoint and zero-key patterns store nothing and list no live
    tile, and "one" lists exactly one."""
    x, y, gb, yg, _ = ghost_case("manhattan", q, p, d, m, q + d + 1, pattern)
    xt, yt, gbt, ygt = (as_words(a).to(cuda_device) for a in (x, y, gb, yg))
    need = tnt.ghost_hit(torch.ones((q, p), dtype=torch.bool,
                                    device=cuda_device), gbt, ygt)
    dist = tnt.l1_dist(xt, yt)
    pool = dist[need] if bool(need.any()) else dist.flatten()
    eps = float(pool.sort().values[len(pool) // 3])       # a pair's own d
    live = int(tnt.ghost_tile_plan(gbt, ygt)[3][0])
    want_live = {"one": 1, "disjoint": 0, "zero": 0}.get(pattern)
    assert want_live is None or live == want_live
    kern = tnt.nng_tile_ghost_l1_cuda
    before = kern.launches
    cnt, bits = kern(xt, yt, gbt, ygt, eps)
    assert kern.launches == before + 1
    rc, rb, _, _ = tops.nng_tile_bits_ghost(*(as_words(a) for a in
                                              (x, y, gb, yg)), eps,
                                            metric="manhattan")
    assert torch.equal(cnt.cpu(), rc) and torch.equal(bits.cpu(), rb)
    _, hb = tnt.nng_tile_l1_cuda(xt, yt, torch.ones(p, dtype=torch.int32,
                                                    device=cuda_device), eps)
    hit = tnt.ghost_hit(tnt.unpack_words(hb)[:, :p], gbt, ygt)
    assert torch.equal(cnt, hit.sum(1, dtype=torch.int32))
    assert torch.equal(bits, tnt.pack_words(torch.nn.functional.pad(
        hit, (0, -p % 32))))
    if pattern in ("disjoint", "zero"):
        assert not bits.any() and not cnt.any()
    else:
        assert int(rc.sum()) > 0


# ---------------------------------------------------------------------------
# the distance-kernel API
# ---------------------------------------------------------------------------

def sqdist_bound(x, y):
    """(q, p) elementwise bound 2·(d + 2)·u·(‖x_i‖² + ‖y_j‖²) on two fp32
    evaluations of the expansion, from the fp32 inputs in float64."""
    x64 = x.astype(np.float32).astype(np.float64)
    y64 = y.astype(np.float32).astype(np.float64)
    s = (x64 * x64).sum(1)[:, None] + (y64 * y64).sum(1)[None, :]
    return 2 * (x.shape[1] + 2) * U32 * s


def count_eps(x, y, target=None, quantiles=(None,)):
    """A gap-safe eps (at least 1e-5·eps from every pair) near ``target``
    or the first of ``quantiles`` that has one, whose every pair's float64
    d² lies farther from eps² than ``sqdist_bound``: no two fp32
    expansions, nor an expansion and the direct form, can count a pair
    differently."""
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    d2 = ((x64[:, None, :] - y64[None, :, :]) ** 2).sum(-1)
    bound = sqdist_bound(x, y)
    for quantile in quantiles:
        try:
            eps = gap_safe_eps(x, y, quantile, rel=1e-5, target=target)
        except AssertionError:
            continue
        if (np.abs(d2 - eps * eps) > bound).all():
            return eps
    raise AssertionError("no eps clear of the expansion bound")


RAGGED_QP = [(1, 1), (1, 300), (127, 129), (129, 127), (300, 1), (300, 300)]


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 17, 700])
@pytest.mark.parametrize("q,p", RAGGED_QP)
def test_pairwise_sqdist_cuda_matches_plain(cuda_device, q, p, d):
    """Within the expansion bound of the plain version and of float64."""
    rng = np.random.default_rng(q + p + d)
    x = rng.normal(size=(q, d)).astype(np.float32)
    y = (rng.normal(size=(p, d)) + 0.5).astype(np.float32)
    xt, yt = torch.from_numpy(x).to(cuda_device), torch.from_numpy(y).to(
        cuda_device)
    before = pairwise_sqdist_cuda.launches
    got = pairwise_sqdist_cuda(xt, yt)
    assert pairwise_sqdist_cuda.launches == before + 1
    with ieee_fp32():
        plain = tref.pairwise_sqdist_blas3_ref(xt, yt)
    bound = sqdist_bound(x, y)
    got64 = got.cpu().double().numpy()
    assert (np.abs(got64 - plain.cpu().double().numpy()) <= bound).all()
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    exact = ((x64[:, None, :] - y64[None, :, :]) ** 2).sum(-1)
    assert (np.abs(got64 - exact) <= bound).all()
    assert (got64 >= 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("w", [1, 25, 26])
@pytest.mark.parametrize("q,p", RAGGED_QP)
def test_pairwise_hamming_cuda_matches_plain(cuda_device, q, p, w):
    """Bit for bit, on words of every density."""
    x = as_words(random_words(q + w, q, w))
    y = as_words(random_words(p + w + 1, p, w))
    before = pairwise_hamming_cuda.launches
    got = pairwise_hamming_cuda(x.to(cuda_device), y.to(cuda_device))
    assert pairwise_hamming_cuda.launches == before + 1
    assert torch.equal(got.cpu(), tref.pairwise_hamming_ref(x, y))


@pytest.mark.gpu
def test_pairwise_hamming_cuda_output_past_2_31(cuda_device):
    """An output of more than 2^31 elements: the rows whose offsets pass
    2^31 hold their own distances (64-bit offsets)."""
    q, p = 8192, 262400
    assert q * p > 2**31
    x = as_words(random_words(1, q, 1)).to(cuda_device)
    y = as_words(random_words(2, p, 1)).to(cuda_device)
    got = pairwise_hamming_cuda(x, y)
    for rows in (slice(0, 4), slice(2**31 // p - 2, 2**31 // p + 2),
                 slice(q - 4, q)):
        assert torch.equal(got[rows], tref.pairwise_hamming_ref(x[rows], y))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 17, 700])
@pytest.mark.parametrize("q,p", RAGGED_QP[1:])
def test_eps_count_cuda_matches_plain(cuda_device, q, p, d):
    """Equal to the plain expansion and the direct oracle at an eps no
    fp32 evaluation can split, and to nng_tile's cnt bit for bit."""
    rng = np.random.default_rng(q * p + d)
    x = rng.normal(size=(q, d)).astype(np.float32)
    y = rng.normal(size=(p, d)).astype(np.float32)
    eps = count_eps(x, y, quantiles=(0.05, 0.01, 0.002))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    before = eps_count_cuda.launches
    got = eps_count_cuda(xt.to(cuda_device), yt.to(cuda_device), eps)
    assert eps_count_cuda.launches == before + 1
    assert int(got.sum()) > 0
    assert torch.equal(got.cpu(), eps_count_plain(xt, yt, eps))
    assert torch.equal(got.cpu(), tref.eps_count_ref(xt, yt, eps))
    cnt, _ = tnt.nng_tile_cuda(xt.to(cuda_device), yt.to(cuda_device),
                               torch.ones(p, dtype=torch.int32,
                                          device=cuda_device), eps)
    assert torch.equal(got, cnt)


@pytest.mark.gpu
@pytest.mark.parametrize("q,p,d", [(1000, 777, 128), (300, 4100, 3)])
def test_eps_count_cuda_equals_nng_tile_cnt_on_pairs(cuda_device, q, p, d):
    """At an eps that is one pair's own fp32 distance (a knife-edge pair),
    the counts still equal nng_tile's cnt bit for bit: the same products,
    the same d², the same threshold."""
    g = torch.Generator(device=cuda_device).manual_seed(q + d)
    x = torch.randn(q, d, generator=g, device=cuda_device)
    y = torch.randn(p, d, generator=g, device=cuda_device)
    eps = float(torch.cdist(x[:1], y[:1]).item())
    got = eps_count_cuda(x, y, eps)
    cnt, _ = tnt.nng_tile_cuda(x, y, torch.ones(p, dtype=torch.int32,
                                                device=cuda_device), eps)
    assert int(got.sum()) > 0
    assert torch.equal(got, cnt)


def eps_on_pair(d2, quantile):
    """An eps whose ``eps2_f32(eps)`` is exactly one pair's fp32 d² (that
    pair on the knife edge): the first positive d² at or above
    ``quantile`` of them that is the fp32 square of an fp32, or None."""
    v = np.unique(d2.cpu().numpy().ravel())
    v = v[v > 0]
    for val in v[int(quantile * max(len(v) - 1, 0)):]:
        e = np.float32(np.sqrt(np.float64(val)))
        for cand in (e, np.nextafter(e, np.float32(np.inf)),
                     np.nextafter(e, np.float32(0))):
            if tnt.eps2_f32(float(cand)) == float(val):
                return float(cand)
    return None


# (q, p, d, shift): the ragged shapes; grids with more tiles than resident
# blocks (561 and 1024 tiles against at most 2 a SM); row slices whose rows
# are not 16-byte aligned ("row": rows 1.. of a (q + 1, d) matrix) and a
# base one element off ("elem", with d % 4 == 0)
L2_PIPE_CASES = ([(q, p, d, None) for q, p in RAGGED_QP for d in (1, 17, 700)]
                 + [(2100, 4100, 17, None), (4096, 4096, 128, None),
                    (300, 300, 17, "row"), (1000, 777, 17, "row"),
                    (300, 257, 128, "elem")])


@pytest.mark.gpu
@pytest.mark.parametrize("q,p,d,shift", L2_PIPE_CASES)
def test_l2_pipe_kernels_equal_old_core(cuda_device, q, p, d, shift):
    """The kernels on ``csrc/l2_pipe.cuh`` equal, bit for bit, the plain
    fp32 chain kernel that anchors them (``l2_chain_d2_cuda``, in the
    place of the old core they replaced) at an eps exactly on one pair's
    fp32 d²: nng_tile's cnt and words its hits with y_valid applied;
    nng_tile_grouped's its hits under the group and id test (random
    groups with padding, shared ids; and one group with disjoint ids);
    eps_count its row sums; ``pairwise_sqdist_cuda(x, y)`` its d² after
    the clamp at 0, and so its hits."""
    g = torch.Generator(device=cuda_device).manual_seed(7 * q + p + d)

    def operand(rows):
        if shift == "row":
            return torch.randn(rows + 1, d, generator=g,
                               device=cuda_device)[1:]
        if shift == "elem":
            return torch.randn(rows * d + 1, generator=g,
                               device=cuda_device)[1:].view(rows, d)
        return torch.randn(rows, d, generator=g, device=cuda_device)

    eps = None
    while eps is None:          # a tiny draw may hold no such pair
        x, y = operand(q), operand(p)
        before = l2_chain_d2_cuda.launches
        d2 = l2_chain_d2_cuda(x, y)
        assert l2_chain_d2_cuda.launches == before + 1
        eps = eps_on_pair(d2, 0.02)
    assert x.is_contiguous() and y.is_contiguous()
    if shift is not None:
        assert x.data_ptr() % 16 and y.data_ptr() % 16
    yv = (torch.rand(p, generator=g, device=cuda_device) > 0.2).to(
        torch.int32)
    e2 = tnt.eps2_f32(eps)
    hit = d2 <= e2
    assert bool((d2 == e2).any())
    i32 = dict(dtype=torch.int32, device=cuda_device)
    xg = torch.randint(-1, 3, (q,), generator=g, device=cuda_device).to(
        torch.int32)
    yg = torch.randint(-1, 3, (p,), generator=g, device=cuda_device).to(
        torch.int32)
    xid, yid = torch.arange(q, **i32), torch.arange(p, **i32)

    def words(h):
        return tnt.pack_words(torch.nn.functional.pad(h, (0, -p % 32)))

    before = (tnt.nng_tile_cuda.launches, eps_count_cuda.launches,
              tnt.nng_tile_grouped_cuda.launches)
    cnt, bits = tnt.nng_tile_cuda(x, y, yv, eps)
    got = eps_count_cuda(x, y, eps)
    gcnt, gbits = tnt.nng_tile_grouped_cuda(x, y, xg, yg, xid, yid, eps)
    ocnt, obits = tnt.nng_tile_grouped_cuda(
        x, y, torch.zeros(q, **i32), torch.zeros(p, **i32), xid, yid + q,
        eps)
    assert (tnt.nng_tile_cuda.launches, eps_count_cuda.launches,
            tnt.nng_tile_grouped_cuda.launches) == (
                before[0] + 1, before[1] + 1, before[2] + 2)
    valid = hit & (yv != 0)[None, :]
    assert torch.equal(cnt, valid.sum(1, dtype=torch.int32))
    assert torch.equal(bits, words(valid))
    assert torch.equal(got, hit.sum(1, dtype=torch.int32))
    ghit = tnt.grouped_hit(hit, xg, yg, xid, yid)
    assert torch.equal(gcnt, ghit.sum(1, dtype=torch.int32))
    assert torch.equal(gbits, words(ghit))
    assert torch.equal(ocnt, got) and torch.equal(obits, words(hit))
    sq = pairwise_sqdist_cuda(x, y)
    assert torch.equal(sq, d2.clamp_min(0))
    assert torch.equal(sq <= e2, hit)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 17, 700])
@pytest.mark.parametrize("q,p", RAGGED_QP)
def test_l2_chain_cuda_within_fp32_bound(cuda_device, q, p, d):
    """The chain anchor's d² lies within the expansion bound
    2·(d + 2)·u·(‖x‖² + ‖y‖²) of float64 (unclamped: it may dip below 0
    by no more than that), and its norms are the fp32 chains: a pair of
    equal rows has d² exactly 0."""
    rng = np.random.default_rng(q + p + d + 1)
    x = rng.normal(size=(q, d)).astype(np.float32)
    y = (rng.normal(size=(p, d)) + 0.5).astype(np.float32)
    y[0] = x[0]
    got = l2_chain_d2_cuda(torch.from_numpy(x).to(cuda_device),
                           torch.from_numpy(y).to(cuda_device))
    assert got.shape == (q, p) and got.dtype == torch.float32
    got64 = got.cpu().double().numpy()
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    exact = ((x64[:, None, :] - y64[None, :, :]) ** 2).sum(-1)
    assert (np.abs(got64 - exact) <= sqdist_bound(x, y)).all()
    assert got64[0, 0] == 0.0


@pytest.mark.gpu
def test_distance_api_on_the_card(cuda_device):
    """The public wrappers launch the kernels for CUDA tensors and for
    numpy input by default; float16 is cast to fp32 first."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(300, 20)).astype(np.float16)
    y = rng.normal(size=(129, 20)).astype(np.float16)
    counts = (pairwise_sqdist_cuda.launches, eps_count_cuda.launches,
              pairwise_hamming_cuda.launches)
    d2 = tops.pairwise_sqdist(x, y)
    cnt = tops.eps_count(torch.from_numpy(x).to(cuda_device), y, 5.0)
    ham = tops.pairwise_hamming(random_words(3, 300, 25),
                                random_words(4, 129, 25))
    assert (pairwise_sqdist_cuda.launches, eps_count_cuda.launches,
            pairwise_hamming_cuda.launches) == tuple(c + 1 for c in counts)
    assert d2.is_cuda and d2.dtype == torch.float32 and d2.shape == (300, 129)
    assert cnt.is_cuda and cnt.shape == (300,)
    assert ham.is_cuda and ham.dtype == torch.int32
    x32, y32 = (torch.from_numpy(a.astype(np.float32)) for a in (x, y))
    assert (np.abs(d2.cpu().double().numpy() - tops.pairwise_sqdist(
        x32, y32).double().numpy()) <= sqdist_bound(x, y)).all()


# ---------------------------------------------------------------------------
# IEEE fp32 products whatever the process's matmul precision
# ---------------------------------------------------------------------------

def precision_state():
    return (torch.get_float32_matmul_precision(),
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@pytest.fixture
def default_precision():
    """Each test starts from torch's defaults and leaves them behind."""
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    yield
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True


@pytest.mark.parametrize("setting", ["default", "high", "medium", "tf32",
                                     "cudnn_off"])
def test_ieee_fp32_sets_and_restores(default_precision, setting):
    """Inside the guard: "highest" and no TF32; after it, even when the
    block raises, the process's settings read as they did before."""
    if setting in ("high", "medium"):
        torch.set_float32_matmul_precision(setting)
    elif setting == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
    elif setting == "cudnn_off":
        torch.backends.cudnn.allow_tf32 = False
    before = precision_state()
    with ieee_fp32():
        assert precision_state() == ("highest", False, False)
    assert precision_state() == before
    with pytest.raises(KeyError):
        with ieee_fp32():
            raise KeyError("inside")
    assert precision_state() == before


def precision_points(kind, n):
    """Points off the origin, where a TF32 product's error (about 2^-11 of
    ‖x‖·‖c‖) dwarfs the Lemma-1 slack: "offset", 8-d Gaussians at 3 ± 0.6,
    or "synthetic", 64-d ``synthetic_pointset`` rows (‖x‖ about 45)."""
    if kind == "offset":
        rng = np.random.default_rng(3)
        return (rng.normal(size=(n, 8)) * 0.6 + 3.0).astype(np.float32)
    return synthetic_pointset(n, 64, seed=3).astype(np.float32)


def knife_safe_eps(pts, target):
    """The eps nearest ``target`` whose every pair's float64 d² lies
    outside 20 fp32 units of ‖x‖² + ‖y‖² (the expansion's knife) plus
    1e-4·eps²."""
    x64 = pts.astype(np.float64)
    sq = (x64 * x64).sum(1)
    iu = np.triu_indices(len(pts), 1)
    d2 = np.maximum(sq[:, None] + sq[None, :] - 2 * x64 @ x64.T, 0)[iu]
    knife = 20 * U32 * (sq[:, None] + sq[None, :])[iu]
    dist = np.sort(np.sqrt(d2))
    k = int(np.searchsorted(dist, target))
    lo, hi = max(k - 200, 0), min(k + 200, len(dist) - 1)
    cands = 0.5 * (dist[lo:hi] + dist[lo + 1:hi + 1])
    near = np.abs(d2 - target * target) < 2 * target * target
    margin = np.array([(np.abs(d2[near] - e * e) - knife[near]
                        - 1e-4 * e * e).min() for e in cands])
    ok = cands[margin > 0]
    assert len(ok), "no knife-safe eps"
    eps = float(ok[np.argmin(np.abs(ok - target))])
    assert (np.abs(d2 - eps * eps) - knife - 1e-4 * eps * eps).min() > 0, \
        "no knife-safe eps"
    return eps


def test_build_nng_restores_high_precision_cpu(default_precision):
    """The CPU twin: a process at "high" gets the exact graph from the
    spatial engine and reads "high" again after the call."""
    torch.set_float32_matmul_precision("high")
    pts = precision_points("offset", 300)
    eps = knife_safe_eps(pts, 1.2)
    g = build_nng(pts, eps, partition="spatial",
                  mesh=make_nng_mesh(4, device="cpu"))
    assert torch.get_float32_matmul_precision() == "high"
    assert g == brute_force_graph(pts, eps)
    assert g.num_edges > 0


@pytest.mark.gpu
@pytest.mark.parametrize("kind,n,target", [("offset", 1200, 0.9),
                                           ("synthetic", 4096, 0.84)])
def test_build_nng_ieee_under_high_precision(cuda_device, default_precision,
                                             kind, n, target):
    """A process at "high" (TF32 products) still gets the float64 edge set
    from the spatial engine on the card, and reads "high" after."""
    torch.set_float32_matmul_precision("high")
    pts = precision_points(kind, n)
    eps = knife_safe_eps(pts, target)
    g = build_nng(pts, eps, partition="spatial", mesh=make_nng_mesh(4))
    assert torch.get_float32_matmul_precision() == "high"
    assert g == brute_force_graph(pts, eps)
    assert g.num_edges > 0


@pytest.mark.gpu
def test_build_nng_plan_unchanged_under_high_precision(cuda_device,
                                                       default_precision):
    """At 2^16 x 128 (the smoke points' shape, cut) TF32 centre distances
    change the device planner's capacities; under the guard, a process at
    "high" gets the plan and the graph that a process at "highest" gets."""
    pts = synthetic_pointset(1 << 16, 128, seed=0)
    mesh = make_nng_mesh(8)
    want = build_nng(pts, 2.98, partition="spatial", mesh=mesh, k_cap=1024)
    torch.set_float32_matmul_precision("high")
    got = build_nng(pts, 2.98, partition="spatial", mesh=mesh, k_cap=1024)
    assert torch.get_float32_matmul_precision() == "high"
    assert got.meta["plan"] == want.meta["plan"]
    assert np.array_equal(got.edge_key(), want.edge_key())
    assert got.num_edges > 0
