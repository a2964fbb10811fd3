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
from repro.kernels import tree_frontier as jtf
from repro_torch.kernels import bits_epilogue as tbe
from repro_torch.kernels import nng_tile as tnt
from repro_torch.kernels import ops as tops
from repro_torch.kernels import tree_frontier as ttf
from tests.test_torch_kernels_gpu import (frontier_case, gap_safe_eps,
                                          random_words, range_deltas)


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
# the tree frontier and the leaf-range epilogue
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nq,n,d", [(7, 32, 5), (70, 96, 3), (300, 544, 16),
                                    (45, 100, 4)])
def test_tree_frontier_matches_reference(monkeypatch, nq, n, d):
    """Plain version and wrapper against the reference's oracle and its
    Pallas kernel (interpret mode), bit for bit, on inputs whose every
    decision is 1e-4·eps off its threshold. N = 100 is ragged: the port's
    wrapper masks the pad nodes, the reference gets them padded."""
    q, c, rad, leaf, act, eps = frontier_case(nq, n, d, nq + n)
    pad = -n % 32
    cp = np.pad(c, ((0, pad), (0, 0)))
    radp, leafp = np.pad(rad, (0, pad)), np.pad(leaf, (0, pad))
    actp = np.pad(act, ((0, 0), (0, pad)))
    words = np.asarray(jnt._pack_words(jnp.asarray(actp)))
    want = jtf.tree_frontier_ref(jnp.asarray(q), jnp.asarray(cp),
                                 jnp.asarray(radp), jnp.asarray(leafp),
                                 jnp.asarray(words), eps)
    monkeypatch.setenv("REPRO_PALLAS", "interpret")
    pallas = jops.tree_frontier_step(q, cp, radp, leafp, words, eps)
    got = tops.tree_frontier_step(
        torch.from_numpy(q), torch.from_numpy(c), torch.from_numpy(rad),
        torch.from_numpy(leaf), torch.from_numpy(words.view(np.int32)), eps)
    assert np.asarray(want[0]).any() and np.asarray(want[1]).any()
    for ref in (want, pallas):
        for ours, theirs in zip(got, ref):
            np.testing.assert_array_equal(as_u32(ours), np.asarray(theirs))
    if pad == 0:
        plain = ttf.tree_frontier_ref(
            torch.from_numpy(q), torch.from_numpy(c), torch.from_numpy(rad),
            torch.from_numpy(leaf), torch.from_numpy(words.view(np.int32)),
            eps)
        for ours, theirs in zip(plain, want):
            np.testing.assert_array_equal(as_u32(ours), np.asarray(theirs))


def test_tree_frontier_generic_path_matches_reference():
    """A metric with no frontier kernel: true distances over ``cdist`` and
    the shared float epilogue, as the reference's generic path."""
    from repro.core.metrics import Metric as RefMetric
    from repro.core.metrics_host import get_host_metric as ref_host
    from repro_torch.core.metrics import Metric, get_metric
    q, c, rad, leaf, act, eps = frontier_case(70, 96, 3, 11)
    words = np.asarray(jnt._pack_words(jnp.asarray(act)))
    eu = get_metric("euclidean")
    ours = Metric(name="l2-generic", host=eu.host, cdist=eu.cdist,
                  true_device=eu.true_device)
    ref_eu = __import__("repro.core.metrics", fromlist=["x"]).get_metric(
        "euclidean")
    theirs = RefMetric(name="l2-generic", host=ref_host("euclidean"),
                       cdist=ref_eu.cdist, true_device=ref_eu.true_device)
    got = tops.tree_frontier_step(
        torch.from_numpy(q), torch.from_numpy(c), torch.from_numpy(rad),
        torch.from_numpy(leaf), torch.from_numpy(words.view(np.int32)), eps,
        metric=ours)
    want = jops.tree_frontier_step(q, c, rad, leaf, words, eps,
                                   metric=theirs)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(as_u32(a), np.asarray(b))


@pytest.mark.parametrize("nq,nl", [(5, 32), (130, 544), (64, 1024)])
def test_leaf_range_pack_matches_reference(monkeypatch, nq, nl):
    """Bit-identical on every input: SENTINEL slots, queries whose id is a
    leaf id, negative running sums and the trailing overflow column."""
    delta, leaf_ids, qids = range_deltas(nq, nl, nq + nl)
    got = tops.leaf_range_pack(torch.from_numpy(delta),
                               torch.from_numpy(leaf_ids),
                               torch.from_numpy(qids))
    plain = tbe.leaf_range_pack_ref(torch.from_numpy(delta[:, :nl]),
                                    torch.from_numpy(leaf_ids),
                                    torch.from_numpy(qids))
    want = jbe.leaf_range_pack_ref(jnp.asarray(delta[:, :nl]),
                                   jnp.asarray(leaf_ids), jnp.asarray(qids))
    monkeypatch.setenv("REPRO_PALLAS", "interpret")
    pallas = jops.leaf_range_pack(delta, leaf_ids, qids)
    assert int(np.asarray(want[0]).sum()) > 0
    for ref in (want, pallas):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(as_u32(got[1]), np.asarray(ref[1]))
        np.testing.assert_array_equal(plain[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_array_equal(as_u32(plain[1]), np.asarray(ref[1]))


@pytest.mark.parametrize("k", [1, 9, 70])
def test_bits_to_gathered_ids_matches_reference(k):
    words = random_words(k + 3, 60, 4)
    ids_row = np.random.default_rng(k).permutation(5000)[:128].astype(np.int32)
    ids_row[::5] = 2**31 - 1
    got = tops.bits_to_gathered_ids(torch.from_numpy(words.view(np.int32)),
                                    torch.from_numpy(ids_row), k)
    want = jops.bits_to_gathered_ids(jnp.asarray(words), jnp.asarray(ids_row),
                                     k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_nng_tile_bits_pair_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(50, 6)).astype(np.float32)
    y = rng.normal(size=(70, 6)).astype(np.float32)
    eps = gap_safe_eps(x, y, 0.1)
    got = tops.nng_tile_bits_pair(torch.from_numpy(x), torch.from_numpy(y),
                                  eps)
    want = jops.nng_tile_bits_pair(jnp.asarray(x), jnp.asarray(y), eps)
    for a, b in zip(got, want):
        a = a.numpy()
        np.testing.assert_array_equal(a.view(np.uint32) if a.ndim == 2
                                      else a, np.asarray(b))


# ---------------------------------------------------------------------------
# dispatch: CPU tensors take the plain versions, the wrappers refuse them
# ---------------------------------------------------------------------------

def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros((4, 3))
    i4 = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tnt.nng_tile_cuda(x, x, torch.ones(4, dtype=torch.int32), 1.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tbe.bits_to_cols_cuda(torch.zeros((4, 2), dtype=torch.int32), 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ttf.tree_frontier_cuda(x, x, torch.zeros(4), i4,
                               torch.zeros((4, 1), dtype=torch.int32), 1.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tbe.leaf_range_pack_cuda(torch.zeros((4, 33), dtype=torch.int32),
                                 torch.zeros(32, dtype=torch.int32), i4)


def test_cpu_dispatch_takes_plain_version():
    def counts():
        return (tnt.nng_tile_cuda.launches, tbe.bits_to_cols_cuda.launches,
                ttf.tree_frontier_cuda.launches,
                tbe.leaf_range_pack_cuda.launches)
    before = counts()
    x = torch.randn(10, 3)
    cnt, bits = tops.nng_tile_bits(x, x, torch.ones(10, dtype=torch.int32), 1.0)
    tops.bits_to_ids(bits, 0, 4)
    tops.tree_frontier_step(x, torch.randn(32, 3), torch.ones(32),
                            torch.zeros(32, dtype=torch.int32),
                            torch.full((10, 1), -1, dtype=torch.int32), 1.0)
    tops.leaf_range_pack(torch.zeros((10, 33), dtype=torch.int32),
                         torch.arange(32, dtype=torch.int32),
                         torch.arange(10, dtype=torch.int32))
    assert counts() == before
