"""The port's distance-kernel API against the JAX reference, on the CPU.

The same numpy inputs, made from a seed, go through the reference's public
wrappers (``repro.kernels.pairwise_sqdist``, ``pairwise_hamming``,
``eps_count``) with their Pallas kernels in interpret mode, through the
reference's ``kernels/ref.py`` oracles, and through the port's wrappers,
whose CPU tensors take the plain versions. The shapes and dtypes are the
reference test's (``tests/test_kernels.py``).

Tolerances:
  - ``pairwise_sqdist``: within 2·(d + 2)·u·(‖x_i‖² + ‖y_j‖²) (u = 2⁻²⁴)
    of the reference kernel and of its ``pairwise_sqdist_blas3_ref``,
    elementwise: the expansions sum their products and norms in different
    orders (XLA's CPU dot, the Pallas kernel's 512-feature steps, torch),
    so bit equality cannot hold. Against the direct (x − y)² oracle, the
    reference test's own atol = 5e-3·scale, rtol = 1e-3.
  - ``pairwise_hamming``: bit for bit (exact integers).
  - ``eps_count``: equal counts at an eps near the reference test's, in a
    gap of the float64 pair distances at least 1e-5·eps from every pair
    (``gap_safe_eps``; near the reference's eps the pairs are too dense
    for gaps of 1e-4·eps), and checked to hold every pair's float64 d²
    farther from eps² than the bound above (``count_eps``).
"""
import numpy as np
import pytest
import torch

import repro.kernels as jk
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import kernels as tk
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.eps_count import eps_count_cuda, eps_count_plain
from repro_torch.kernels.pairwise_hamming import pairwise_hamming_cuda
from repro_torch.kernels.pairwise_l2 import pairwise_sqdist_cuda
from tests.test_torch_kernels_gpu import count_eps, sqdist_bound

U32 = 2.0 ** -24        # fp32 unit roundoff

SQDIST_SHAPES = [(1, 1, 1), (7, 13, 3), (128, 128, 32), (300, 260, 130),
                 (256, 256, 512), (100, 513, 700)]
HAMMING_SHAPES = [(1, 1, 1), (5, 9, 3), (130, 200, 25), (128, 128, 8),
                  (64, 300, 26)]
EPS_COUNT_CASES = [(10, 33, 4, 1.0), (100, 333, 20, 5.5), (256, 256, 64, 8.0)]


@pytest.fixture
def interpret(monkeypatch):
    """The reference's wrappers run their Pallas kernels in interpret mode
    for this test only (its mode is read at every call)."""
    monkeypatch.setenv("REPRO_PALLAS", "interpret")


def float_case(q, p, d, dtype, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(q, d)).astype(dtype),
            rng.normal(size=(p, d)).astype(dtype))


def word_case(q, p, w, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2**32, size=(q, w), dtype=np.uint32),
            rng.integers(0, 2**32, size=(p, w), dtype=np.uint32))


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("q,p,d", SQDIST_SHAPES)
def test_pairwise_sqdist_matches_reference(interpret, q, p, d, dtype):
    x, y = float_case(q, p, d, dtype, q + p + d)
    got = tops.pairwise_sqdist(x, y, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (q, p)
    got = got.numpy().astype(np.float64)
    kernel = np.asarray(jk.pairwise_sqdist(x, y), dtype=np.float64)
    blas3 = np.asarray(jref.pairwise_sqdist_blas3_ref(x, y), dtype=np.float64)
    bound = sqdist_bound(x, y)
    assert (np.abs(got - kernel) <= bound).all()
    assert (np.abs(got - blas3) <= bound).all()
    assert (got >= 0).all()
    want = np.asarray(jref.pairwise_sqdist_ref(x, y))
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=5e-3 * scale, rtol=1e-3)


@pytest.mark.parametrize("q,p,w", HAMMING_SHAPES)
def test_pairwise_hamming_matches_reference(interpret, q, p, w):
    x, y = word_case(q, p, w, q + p + w)
    got = tops.pairwise_hamming(x, y, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (q, p)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jk.pairwise_hamming(x, y)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jref.pairwise_hamming_ref(x, y)))


@pytest.mark.parametrize("q,p,d,target", EPS_COUNT_CASES)
def test_eps_count_matches_reference(interpret, q, p, d, target):
    x, y = float_case(q, p, d, np.float32, q + p + d)
    eps = count_eps(x, y, target=target)
    got = tops.eps_count(x, y, eps, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (q,)
    assert int(got.sum()) > 0
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jk.eps_count(x, y, eps)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jref.eps_count_ref(x, y, eps)))


@pytest.mark.parametrize("q,p,d,target", EPS_COUNT_CASES)
def test_torch_oracles_match_reference_oracles(q, p, d, target):
    """The port's ``kernels/ref.py`` against the reference's, one oracle
    each: the direct form within fp32 rounding of its sums, the expansion
    within the bound, Hamming and the counts exactly."""
    x, y = float_case(q, p, d, np.float32, q * p + d)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    want = np.asarray(jref.pairwise_sqdist_ref(x, y))
    np.testing.assert_allclose(tref.pairwise_sqdist_ref(xt, yt).numpy(),
                               want, rtol=4 * d * U32, atol=0)
    blas3 = tref.pairwise_sqdist_blas3_ref(xt, yt).numpy().astype(np.float64)
    assert (np.abs(blas3 - np.asarray(jref.pairwise_sqdist_blas3_ref(x, y)))
            <= sqdist_bound(x, y)).all()
    eps = count_eps(x, y, target=target)
    np.testing.assert_array_equal(tref.eps_count_ref(xt, yt, eps).numpy(),
                                  np.asarray(jref.eps_count_ref(x, y, eps)))
    np.testing.assert_array_equal(eps_count_plain(xt, yt, eps).numpy(),
                                  np.asarray(jref.eps_count_ref(x, y, eps)))
    a, b = word_case(q, p, d, d)
    np.testing.assert_array_equal(
        tref.pairwise_hamming_ref(torch.from_numpy(a.view(np.int32)),
                                  torch.from_numpy(b.view(np.int32))).numpy(),
        np.asarray(jref.pairwise_hamming_ref(a, b)))


def test_direct_oracles_walk_row_chunks(monkeypatch):
    """The direct forms give the same values whether their (rows, p, d)
    temporaries are cut into one-row chunks or not."""
    x, y = float_case(37, 50, 9, np.float32, 5)
    a, b = (torch.from_numpy(t.view(np.int32)) for t in word_case(37, 50, 3, 5))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    whole = (tref.pairwise_sqdist_ref(xt, yt), tref.eps_count_ref(xt, yt, 4.0),
             tref.pairwise_hamming_ref(a, b))
    monkeypatch.setattr(tref, "_CUBE", 1)
    rows = (tref.pairwise_sqdist_ref(xt, yt), tref.eps_count_ref(xt, yt, 4.0),
            tref.pairwise_hamming_ref(a, b))
    assert all(torch.equal(u, v) for u, v in zip(whole, rows))


def test_rowwise_helpers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(50, 7)).astype(np.float32)
    y = rng.normal(size=(50, 7)).astype(np.float32)
    np.testing.assert_allclose(tops.rowwise_sqdist(x, y, device="cpu").numpy(),
                               np.asarray(jops.rowwise_sqdist(x, y)),
                               rtol=1e-6)
    a, b = word_case(20, 20, 5, 1)
    got = tops.rowwise_hamming(a, b, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jops.rowwise_hamming(a, b)))


def test_package_reexports_reference_names():
    """``repro_torch.kernels`` exports what ``repro.kernels`` does."""
    names = [n for n in dir(jk) if not n.startswith("_")
             and callable(getattr(jk, n))]
    assert names
    for name in names:
        assert getattr(tk, name) is getattr(tops, name), name


def test_cpu_tensors_never_touch_the_build(monkeypatch):
    """A CPU tensor takes the plain version without building or loading a
    kernel; the CUDA wrappers refuse it before they would."""
    def no_build(*_a, **_k):
        raise AssertionError("the CPU path reached the kernel build")
    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_build, "entry", no_build)
    x, y = (torch.from_numpy(t) for t in float_case(9, 40, 5, np.float32, 2))
    a, b = (torch.from_numpy(t.view(np.int32)) for t in word_case(9, 40, 2, 2))
    before = (pairwise_sqdist_cuda.launches, pairwise_hamming_cuda.launches,
              eps_count_cuda.launches)
    assert tk.pairwise_sqdist(x, y).shape == (9, 40)
    assert tk.pairwise_hamming(a, b).shape == (9, 40)
    assert tk.eps_count(x, y, 3.0).shape == (9,)
    assert tk.eps_count(x.numpy(), y.numpy(), 3.0, device="cpu").shape == (9,)
    for fn, args in ((pairwise_sqdist_cuda, (x, y)),
                     (pairwise_hamming_cuda, (a, b)),
                     (eps_count_cuda, (x, y, 3.0))):
        with pytest.raises(ValueError, match="must be a CUDA tensor"):
            fn(*args)
    assert (pairwise_sqdist_cuda.launches, pairwise_hamming_cuda.launches,
            eps_count_cuda.launches) == before


def test_numpy_input_defaults_to_the_card():
    """numpy input runs on the CUDA card unless ``device`` says otherwise:
    without a card that raises rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    x, y = float_case(4, 6, 3, np.float32, 3)
    for call in (lambda: tk.pairwise_sqdist(x, y),
                 lambda: tk.eps_count(x, y, 1.0),
                 lambda: tk.pairwise_hamming(*word_case(4, 6, 2, 3))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
