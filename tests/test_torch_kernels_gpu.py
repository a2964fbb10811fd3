"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA device:
the kernels have no CPU mode. The file imports neither JAX nor the
reference package, so it runs on a GPU machine that has neither:

    python -m pytest -m gpu tests/test_torch_kernels_gpu.py

``gap_safe_eps``, ``random_words``, ``frontier_case`` and ``range_deltas``
are shared with the CPU tests in ``test_torch_kernels.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import bits_epilogue as tbe
from repro_torch.kernels import nng_tile as tnt
from repro_torch.kernels import ops as tops
from repro_torch.kernels import tree_frontier as ttf

SENTINEL = 2**31 - 1


def gap_safe_eps(x, y, quantile, rel=1e-4):
    """An eps in the widest gap between float64 pair distances near the
    quantile, at least ``rel``·eps away from every pair."""
    x64 = x.astype(np.float64)
    y64 = y.astype(np.float64)
    d = np.sqrt(((x64[:, None, :] - y64[None, :, :]) ** 2).sum(-1)).ravel()
    d.sort()
    k = int(quantile * len(d))
    lo, hi = max(k - 200, 0), min(k + 200, len(d) - 1)
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


def frontier_case(nq, n, d, seed, margin=1e-4):
    """One frontier level's inputs (numpy) whose every decision lies at
    least ``margin``·eps from its threshold in float64: eps sits in a gap of
    the pair distances (leaf test), and each internal node's radius is
    redrawn until no d ± radius lies near eps (inclusion and expansion
    tests). Active bits are random, with an all-zero block (a whole 128 x
    128 kernel block where the shape has one) and all-zero rows."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    c = rng.normal(size=(n, d)).astype(np.float32)
    dist = np.sqrt(((q.astype(np.float64)[:, None, :]
                     - c.astype(np.float64)[None, :, :]) ** 2).sum(-1))
    # low in the distance distribution where pairs are many: gaps are wider
    eps = gap_safe_eps(q, c, 0.01 if nq * n < 200_000 else 3e-4,
                       rel=margin)
    leaf = (rng.random(n) < 0.4).astype(np.int32)
    rad = np.zeros(n, np.float32)
    for j in np.flatnonzero(leaf == 0):
        while True:
            r = np.float32(abs(rng.normal()) * eps)
            near = np.minimum(np.abs(dist[:, j] + r - eps),
                              np.abs(dist[:, j] - r - eps))
            if near.min() > margin * eps:
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
