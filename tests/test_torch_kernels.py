"""The port's tile kernels against the JAX reference, on the CPU.

The same numpy inputs, made from a seed, go through the reference's
``*_ref`` oracle and its Pallas kernel in interpret mode, and through the
port's plain PyTorch version (the path every CPU tensor takes). Float tiles
use a gap-safe eps — no pair distance within 1e-4·eps of it — so the
different fp32 summation orders cannot flip a pair; the bit-only epilogue
must agree on every input. The CUDA kernels themselves are tested on the
card in ``test_torch_kernels_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bits_epilogue as jbe
from repro.kernels import nng_tile as jnt
from repro.kernels import ops as jops
from repro_torch.kernels import bits_epilogue as tbe
from repro_torch.kernels import nng_tile as tnt
from repro_torch.kernels import ops as tops
from tests.test_torch_kernels_gpu import gap_safe_eps, random_words


def as_u32(words):
    """Port words (int32 torch) -> the reference's uint32 numpy words."""
    return words.numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# threshold and word layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eps", [1e-3, 0.1, 1.0, 2.98, 3.3333333, 175.0])
def test_eps2_f32_matches_reference(eps):
    assert tnt.eps2_f32(eps) == jnt._eps2_f32(eps)
    assert tnt.eps2_f32(eps) == float(np.float32(eps) ** 2)


def test_pack_words_layout():
    hit = torch.zeros((2, 64), dtype=torch.bool)
    hit[0, [0, 5, 31, 32, 63]] = True
    hit[1, 33] = True
    words = as_u32(tnt.pack_words(hit))
    assert words.tolist() == [[1 | 1 << 5 | 1 << 31, 1 | 1 << 31],
                              [0, 1 << 1]]
    ref = np.asarray(jnt._pack_words(jnp.asarray(hit.numpy())))
    np.testing.assert_array_equal(words, ref)
    assert torch.equal(tnt.unpack_words(tnt.pack_words(hit)), hit)


# ---------------------------------------------------------------------------
# the fused tile
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q,p,d,tq,tp", [(64, 256, 16, 32, 128),
                                         (32, 128, 3, 32, 128)])
def test_nng_tile_ref_matches_reference(q, p, d, tq, tp):
    rng = np.random.default_rng(q + p + d)
    x = rng.normal(size=(q, d)).astype(np.float32)
    y = rng.normal(size=(p, d)).astype(np.float32)
    yv = (rng.random(p) > 0.2).astype(np.int32)
    eps = gap_safe_eps(x, y, 0.05)
    cnt, bits = tnt.nng_tile_ref(torch.from_numpy(x), torch.from_numpy(y),
                                 torch.from_numpy(yv), eps)
    jc, jb = jnt.nng_tile_ref(jnp.asarray(x), jnp.asarray(y),
                              jnp.asarray(yv), eps)
    pc, pb = jnt.nng_tile_pallas(jnp.asarray(x), jnp.asarray(y),
                                 jnp.asarray(yv), eps, tq=tq, tp=tp,
                                 interpret=True)
    assert int(cnt.sum()) > 0
    for rc, rb in ((jc, jb), (pc, pb)):
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(rc))
        np.testing.assert_array_equal(as_u32(bits), np.asarray(rb))


@pytest.mark.parametrize("q,p,d", [(37, 64, 3), (100, 77, 10), (5, 33, 2),
                                   (1, 1, 1)])
def test_nng_tile_bits_ragged_matches_reference(q, p, d):
    rng = np.random.default_rng(7 * q + p)
    x = rng.normal(size=(q, d)).astype(np.float32)
    y = rng.normal(size=(p, d)).astype(np.float32)
    yv = (rng.random(p) > 0.1).astype(np.int32)
    eps = gap_safe_eps(x, y, 0.3) if q * p > 1 else 1.0
    cnt, bits = tops.nng_tile_bits(torch.from_numpy(x), torch.from_numpy(y),
                                   torch.from_numpy(yv), eps)
    jc, jb = jops.nng_tile_bits(jnp.asarray(x), jnp.asarray(y),
                                jnp.asarray(yv), eps)
    assert bits.shape == (q, -(-p // 32))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(as_u32(bits), np.asarray(jb))


# ---------------------------------------------------------------------------
# the bitmask epilogue
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [8, 64, 136])
def test_bits_to_cols_ref_matches_reference(k):
    words = random_words(k, 64, 5)
    got = tbe.bits_to_cols_ref(torch.from_numpy(words.view(np.int32)), k)
    ref = jbe.bits_to_cols_ref(jnp.asarray(words), k)
    pal = jbe.bits_to_cols_pallas(jnp.asarray(words), k, tq=32, kc=8,
                                  interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pal))


@pytest.mark.parametrize("k", [1, 7, 300])
def test_bits_to_ids_matches_reference(k):
    words = random_words(100 + k, 40, 11)
    got = tops.bits_to_ids(torch.from_numpy(words.view(np.int32)), 1000, k)
    ref = jops.bits_to_ids(jnp.asarray(words), 1000, k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# dispatch: CPU tensors take the plain versions, the wrappers refuse them
# ---------------------------------------------------------------------------

def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tnt.nng_tile_cuda(x, x, torch.ones(4, dtype=torch.int32), 1.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tbe.bits_to_cols_cuda(torch.zeros((4, 2), dtype=torch.int32), 3)


def test_cpu_dispatch_takes_plain_version():
    before = (tnt.nng_tile_cuda.launches, tbe.bits_to_cols_cuda.launches)
    x = torch.randn(10, 3)
    cnt, bits = tops.nng_tile_bits(x, x, torch.ones(10, dtype=torch.int32), 1.0)
    tops.bits_to_ids(bits, 0, 4)
    assert (tnt.nng_tile_cuda.launches,
            tbe.bits_to_cols_cuda.launches) == before
