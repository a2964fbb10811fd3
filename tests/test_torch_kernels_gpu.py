"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA device:
the kernels have no CPU mode. The file imports neither JAX nor the
reference package, so it runs on a GPU machine that has neither:

    python -m pytest -m gpu tests/test_torch_kernels_gpu.py

``gap_safe_eps`` and ``random_words`` are shared with the CPU tests in
``test_torch_kernels.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import bits_epilogue as tbe
from repro_torch.kernels import nng_tile as tnt
from repro_torch.kernels import ops as tops


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
