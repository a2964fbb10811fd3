"""The port's tile kernels against the JAX reference, on the CPU.

The same numpy inputs, made from a seed, go through the reference's
``*_ref`` oracle and its Pallas kernel in interpret mode, and through the
port's plain PyTorch version (the path every CPU tensor takes). Float tiles
(L2, L1) use a gap-safe eps — no pair distance within 1e-4·eps of it — so
the different fp32 summation orders cannot flip a pair; the Hamming tiles
and the bit-only epilogue must agree bit for bit on every input. The CUDA
kernels themselves are tested on the card in ``test_torch_kernels_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bits_epilogue as jbe
from repro.kernels import nng_tile as jnt
from repro.kernels import ops as jops
from repro.kernels import tree_frontier as jtf
from repro_torch.core.metrics import get_metric
from repro_torch.kernels import bits_epilogue as tbe
from repro_torch.kernels import nng_tile as tnt
from repro_torch.kernels import ops as tops
from repro_torch.kernels import tree_frontier as ttf
from tests.test_torch_kernels_gpu import (as_words, frontier_case,
                                          gap_safe_eps, ghost_case,
                                          grouped_case, hamming_points,
                                          pack_cells, pair_dists,
                                          random_words, range_deltas)

U32 = 2.0 ** -24        # fp32 unit roundoff


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
# the Hamming and L1 tiles and frontiers
# ---------------------------------------------------------------------------

def _reference_modes(monkeypatch, fn):
    """``fn()`` under the reference's plain jnp oracle and under its Pallas
    kernel in interpret mode."""
    out = []
    for mode in ("jnp", "interpret"):
        monkeypatch.setenv("REPRO_PALLAS", mode)
        out.append(fn())
    return out


@pytest.mark.parametrize("q,p,w", [(64, 256, 8), (37, 70, 3),
                                   (130, 300, 25)])
def test_hamming_tile_matches_reference(monkeypatch, q, p, w):
    """Bit for bit on every input: words with the sign bit set and all
    ones included, eps a pair distance plus 0.5 (``int(eps)``)."""
    rng = np.random.default_rng(q + w)
    x, y = hamming_points(rng, q, w), hamming_points(rng, p, w)
    assert (x == 0xFFFFFFFF).any() and (x >= 2**31).any()
    yv = (rng.random(p) > 0.1).astype(np.int32)
    eps = float(np.quantile(pair_dists(x, y, "hamming"), 0.1)) + 0.5
    got = tops.nng_tile_bits(as_words(x), as_words(y), torch.from_numpy(yv),
                             eps, metric="hamming")
    pad = -p % 32
    plain = tnt.nng_tile_hamming_ref(
        as_words(x), as_words(np.pad(y, ((0, pad), (0, 0)))),
        torch.from_numpy(np.pad(yv, (0, pad))), eps)
    want = jnt.nng_tile_hamming_ref(jnp.asarray(x), jnp.asarray(y),
                                    jnp.asarray(yv), eps) if pad == 0 else None
    refs = _reference_modes(monkeypatch, lambda: jops.nng_tile_bits(
        x, y, yv, eps, metric="hamming"))
    assert int(got[0].sum()) > 0
    for rc, rb in refs + ([want] if want is not None else []):
        for ours in (got, plain):
            np.testing.assert_array_equal(ours[0].numpy(), np.asarray(rc))
            np.testing.assert_array_equal(as_u32(ours[1])[:, :rb.shape[1]],
                                          np.asarray(rb))


@pytest.mark.parametrize("q,p,d", [(64, 256, 16), (37, 70, 3),
                                   (130, 300, 20)])
def test_l1_tile_matches_reference(monkeypatch, q, p, d):
    """Hit masks equal at a gap-safe eps (1e-4·eps from every pair, far
    beyond the d·u·eps two fp32 summation orders can differ by); prints
    the largest distance difference from the reference's ``_l1_tile_d``
    in units of u·d."""
    rng = np.random.default_rng(q + d)
    x = rng.normal(size=(q, d)).astype(np.float32)
    y = rng.normal(size=(p, d)).astype(np.float32)
    yv = (rng.random(p) > 0.1).astype(np.int32)
    eps = gap_safe_eps(x, y, 0.05, metric="manhattan")
    dp = tnt.l1_dist(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    dr = np.asarray(jnt._l1_tile_d(jnp.asarray(x), jnp.asarray(y), 8))
    print(f"max |d_port - d_ref| = {np.max(np.abs(dp - dr) / (U32 * dr)):.3g}"
          f" u·d_ref")
    assert np.max(np.abs(dp - dr)) <= 2 * d * U32 * dr.max()
    got = tops.nng_tile_bits(torch.from_numpy(x), torch.from_numpy(y),
                             torch.from_numpy(yv), eps, metric="manhattan")
    pad = -p % 32
    plain = tnt.nng_tile_l1_ref(
        torch.from_numpy(x), torch.from_numpy(np.pad(y, ((0, pad), (0, 0)))),
        torch.from_numpy(np.pad(yv, (0, pad))), eps)
    refs = _reference_modes(monkeypatch, lambda: jops.nng_tile_bits(
        x, y, yv, eps, metric="manhattan"))
    assert int(got[0].sum()) > 0
    for rc, rb in refs:
        for ours in (got, plain):
            np.testing.assert_array_equal(ours[0].numpy(), np.asarray(rc))
            np.testing.assert_array_equal(as_u32(ours[1])[:, :rb.shape[1]],
                                          np.asarray(rb))


@pytest.mark.parametrize("metric", ["hamming", "manhattan"])
@pytest.mark.parametrize("nq,n,d", [(7, 32, 5), (70, 96, 3), (300, 544, 16),
                                    (45, 100, 4)])
def test_metric_frontier_matches_reference(monkeypatch, metric, nq, n, d):
    """Plain versions and wrapper against the reference's oracle and its
    Pallas kernel (interpret mode), bit for bit: Hamming on every input,
    L1 on inputs whose every decision is 1e-4·eps off its threshold. N =
    100 is ragged, as in the L2 test."""
    q, c, rad, leaf, act, eps = frontier_case(nq, n, d, nq + n,
                                              metric=metric)
    pad = -n % 32
    cp = np.pad(c, ((0, pad), (0, 0)))
    radp, leafp = np.pad(rad, (0, pad)), np.pad(leaf, (0, pad))
    words = np.asarray(jnt._pack_words(jnp.asarray(
        np.pad(act, ((0, 0), (0, pad))))))
    refs = _reference_modes(monkeypatch, lambda: jops.tree_frontier_step(
        q, cp, radp, leafp, words, eps, metric=metric))
    got = tops.tree_frontier_step(
        as_words(q), as_words(c), torch.from_numpy(rad),
        torch.from_numpy(leaf), as_words(words), eps, metric=metric)
    plain_fn = {"hamming": ttf.tree_frontier_hamming_ref,
                "manhattan": ttf.tree_frontier_l1_ref}[metric]
    plain = plain_fn(as_words(q), as_words(cp), torch.from_numpy(radp),
                     torch.from_numpy(leafp), as_words(words), eps)
    assert np.asarray(refs[0][0]).any() and np.asarray(refs[0][1]).any()
    for ref in refs:
        for ours in (got, plain):
            for a, b in zip(ours, ref):
                np.testing.assert_array_equal(as_u32(a), np.asarray(b))


# ---------------------------------------------------------------------------
# the grouped tiles (the landmark engine)
# ---------------------------------------------------------------------------

def _quantile_eps(x, y, metric):
    """An eps low in the pair distances (3% on a small tile, 0.3% on a
    large one, where gaps are narrower): for the float metrics in the
    widest float64 gap near there, at least 1e-4·eps from every pair (so two
    fp32 summation orders cannot split a pair); for Hamming a pair
    distance plus 0.5 (exact)."""
    small = x.shape[0] * y.shape[0] < 50_000
    quantile = 0.03 if small else 0.003
    if metric == "hamming":
        return float(np.quantile(pair_dists(x, y, metric), quantile)) + 0.5
    return gap_safe_eps(x, y, quantile, metric=metric,
                        window=20 if small else 200)


GROUPED_REF = {"euclidean": (tnt.nng_tile_grouped_ref,
                             jnt.nng_tile_grouped_ref),
               "hamming": (tnt.nng_tile_grouped_hamming_ref,
                           jnt.nng_tile_grouped_hamming_ref),
               "manhattan": (tnt.nng_tile_grouped_l1_ref,
                             jnt.nng_tile_grouped_l1_ref)}


@pytest.mark.parametrize("metric,q,p,d", [
    ("euclidean", 256, 512, 16), ("euclidean", 70, 130, 6),
    ("euclidean", 300, 515, 40), ("hamming", 128, 256, 8),
    ("hamming", 100, 190, 5), ("manhattan", 128, 256, 8),
    ("manhattan", 100, 190, 5),
])
def test_grouped_tile_matches_reference(monkeypatch, metric, q, p, d):
    """The shapes of the reference's ``test_nng_tile_grouped_fused`` cases,
    with eps low in the pair distances (``_quantile_eps``: its own eps
    leaves some of these tiles without a hit): random groups with padding (-1),
    shared ids. The wrapper and the plain version against the reference's
    oracle, its Pallas kernel in interpret mode and its ``*_ref``, bit for
    bit; the block counters too."""
    rng = np.random.default_rng(q + p + d)
    if metric == "hamming":
        x = rng.integers(0, 2**32, size=(q, d), dtype=np.uint32)
        y = rng.integers(0, 2**32, size=(p, d), dtype=np.uint32)
    else:
        x = rng.normal(size=(q, d)).astype(np.float32)
        y = rng.normal(size=(p, d)).astype(np.float32)
    xg = rng.integers(-1, 6, size=q).astype(np.int32)
    yg = rng.integers(-1, 6, size=p).astype(np.int32)
    xid = np.arange(q, dtype=np.int32)
    yid = np.arange(37, 37 + p, dtype=np.int32)
    xid[:4] = yid[:4]
    eps = _quantile_eps(x, y, metric)
    args = [as_words(a) for a in (x, y, xg, yg, xid, yid)]
    got = tops.nng_tile_bits_grouped(*args, eps, metric=metric)
    pad = -p % 32
    plain_fn, ref_fn = GROUPED_REF[metric]
    padded = [np.pad(y, ((0, pad), (0, 0))), np.pad(yg, (0, pad),
                                                    constant_values=-1),
              np.pad(yid, (0, pad), constant_values=-1)]
    plain = plain_fn(args[0], as_words(padded[0]), args[2],
                     as_words(padded[1]), args[4], as_words(padded[2]), eps)
    refs = _reference_modes(monkeypatch, lambda: jops.nng_tile_bits_grouped(
        x, y, xg, yg, xid, yid, eps, metric=metric))
    direct = ref_fn(jnp.asarray(x), jnp.asarray(padded[0]), jnp.asarray(xg),
                    jnp.asarray(padded[1]), jnp.asarray(xid),
                    jnp.asarray(padded[2]), eps)
    assert int(got[0].sum()) > 0
    nw = -(-p // 32)
    for rc, rb in [r[:2] for r in refs] + [direct]:
        for ours in (got, plain):
            np.testing.assert_array_equal(ours[0].numpy(), np.asarray(rc))
            np.testing.assert_array_equal(as_u32(ours[1])[:, :nw],
                                          np.asarray(rb)[:, :nw])
    for ref in refs:
        assert (int(got[2]), int(got[3])) == (int(ref[2]), int(ref[3]))


@pytest.mark.parametrize("q,p,tq,tp", [(600, 1200, 256, 512),
                                       (600, 1200, 128, 256),
                                       (96, 300, 32, 128), (40, 256, 8, 128)])
def test_grouped_block_active_matches_reference(q, p, tq, tp):
    """Cell-sorted groups with trailing padding (the engine's layout): the
    live-block map equals the reference's, and it skips blocks."""
    rng = np.random.default_rng(q + tq)
    xg = np.sort(rng.integers(0, 50, size=q)).astype(np.int32)
    yg = np.sort(rng.integers(0, 50, size=p)).astype(np.int32)
    xg[q - q // 10:] = -1
    yg[p - p // 7:] = -1
    xg = np.pad(xg, (0, -q % tq), constant_values=-1)
    yg = np.pad(yg, (0, -p % tp), constant_values=-1)
    ours = tops.grouped_block_active(torch.from_numpy(xg),
                                     torch.from_numpy(yg), tq, tp)
    ref = jops.grouped_block_active(jnp.asarray(xg), jnp.asarray(yg), tq, tp)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert not ours.all()


@pytest.mark.parametrize("metric", ["euclidean", "hamming", "manhattan"])
def test_grouped_tile_sorted_and_disjoint(metric):
    """The shared cases of the card's test, on the plain path: cell-sorted
    rows skip blocks and keep their hits; all-disjoint groups hit nothing.
    The plain version against the reference's oracle."""
    for q, p, d, pattern in ((600, 1200, 9, "sorted"),
                             (300, 515, 40, "disjoint")):
        x, y, xg, yg, xid, yid, eps = grouped_case(metric, q, p, d, q + d,
                                                   pattern)
        cnt, bits, sched, skip = tops.nng_tile_bits_grouped(
            *(as_words(a) for a in (x, y, xg, yg, xid, yid)), eps,
            metric=metric)
        rc, rb, rs, rk = jops.nng_tile_bits_grouped(x, y, xg, yg, xid, yid,
                                                    eps, metric=metric)
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(rc))
        np.testing.assert_array_equal(as_u32(bits), np.asarray(rb))
        assert (int(sched), int(skip)) == (int(rs), int(rk))
        assert 0 < int(skip) <= int(sched)
        if pattern == "disjoint":
            assert int(skip) == int(sched) and not bits.any()
        else:
            assert int(cnt.sum()) > 0


# ---------------------------------------------------------------------------
# the ghost tiles (the landmark engine's ghost ring)
# ---------------------------------------------------------------------------

GHOST_REF = {"euclidean": (tnt.nng_tile_ghost_ref, jnt.nng_tile_ghost_ref,
                           jnt.nng_tile_ghost_pallas),
             "hamming": (tnt.nng_tile_ghost_hamming_ref,
                         jnt.nng_tile_ghost_hamming_ref,
                         jnt.nng_tile_ghost_hamming_pallas),
             "manhattan": (tnt.nng_tile_ghost_l1_ref,
                           jnt.nng_tile_ghost_l1_ref,
                           jnt.nng_tile_ghost_l1_pallas)}


@pytest.mark.parametrize("m", [32, 70])
@pytest.mark.parametrize("metric,q,p,d", [
    ("euclidean", 256, 512, 16), ("euclidean", 70, 130, 6),
    ("hamming", 128, 256, 8), ("hamming", 100, 190, 5),
    ("manhattan", 128, 256, 8), ("manhattan", 100, 190, 5),
])
def test_ghost_tile_matches_reference(monkeypatch, metric, q, p, d, m):
    """Random y cells with padding (-1) and random x cell words over m = 32
    (one word) and 70 (three) cells, on tile-aligned and ragged shapes:
    the wrapper and the plain version against the reference's oracle
    (``*_ref``), its Pallas kernel called directly in interpret mode (on
    the aligned shapes) and its ``nng_tile_bits_ghost`` under both modes,
    bit for bit, the block counters too. Hamming on any input; L2 and L1
    at an eps low in the pair distances and 1e-4·eps from every pair."""
    rng = np.random.default_rng(q + p + d + m)
    if metric == "hamming":
        x = rng.integers(0, 2**32, size=(q, d), dtype=np.uint32)
        y = rng.integers(0, 2**32, size=(p, d), dtype=np.uint32)
    else:
        x = rng.normal(size=(q, d)).astype(np.float32)
        y = rng.normal(size=(p, d)).astype(np.float32)
    gb = pack_cells(rng.random((q, m)) < 0.3)
    gb[::9] = 0
    yg = rng.integers(-1, m, size=p).astype(np.int32)
    eps = _quantile_eps(x, y, metric)
    args = [as_words(a) for a in (x, y, gb, yg)]
    got = tops.nng_tile_bits_ghost(*args, eps, metric=metric)
    pad = -p % 32
    plain_fn, ref_fn, pallas_fn = GHOST_REF[metric]
    yp, ygp = np.pad(y, ((0, pad), (0, 0))), np.pad(yg, (0, pad),
                                                    constant_values=-1)
    plain = plain_fn(args[0], as_words(yp), args[2], as_words(ygp), eps)
    refs = _reference_modes(monkeypatch, lambda: jops.nng_tile_bits_ghost(
        x, y, gb, yg, eps, metric=metric))
    direct = [ref_fn(jnp.asarray(x), jnp.asarray(yp), jnp.asarray(gb),
                     jnp.asarray(ygp), eps)]
    tq, tp = get_metric(metric).tile_shape(q, p)
    if q % tq == 0 and p % tp == 0:
        direct.append(pallas_fn(jnp.asarray(x), jnp.asarray(y),
                                jnp.asarray(gb), jnp.asarray(yg), eps, tq=tq,
                                tp=tp, interpret=True))
    assert int(got[0].sum()) > 0
    nw = -(-p // 32)
    for rc, rb in [r[:2] for r in refs] + direct:
        for ours in (got, plain):
            np.testing.assert_array_equal(ours[0].numpy(), np.asarray(rc))
            np.testing.assert_array_equal(as_u32(ours[1])[:, :nw],
                                          np.asarray(rb)[:, :nw])
    for ref in refs:
        assert (int(got[2]), int(got[3])) == (int(ref[2]), int(ref[3]))


@pytest.mark.parametrize("m", [32, 70])
def test_ghost_hit_and_unpack_match_reference(m):
    """The direct bit test equals the reference's one-hot contraction
    (``_ghost_hit``) and ``unpack_words`` its ``_ghost_unpack``."""
    rng = np.random.default_rng(m)
    gb = pack_cells(rng.random((50, m)) < 0.4)
    yg = rng.integers(-1, m, size=96).astype(np.int32)
    d_ok = rng.random((50, 96)) < 0.7
    xb = jnt._ghost_unpack(jnp.asarray(gb))
    np.testing.assert_array_equal(tnt.unpack_words(as_words(gb)).numpy(),
                                  np.asarray(xb))
    ours = tnt.ghost_hit(torch.from_numpy(d_ok), as_words(gb),
                         torch.from_numpy(yg))
    ref = jnt._ghost_hit(jnp.asarray(d_ok), xb, jnp.asarray(yg),
                         jnp.asarray(yg) >= 0)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert ours.any() and not ours.all()


@pytest.mark.parametrize("q,p,tq,tp,m", [(600, 1200, 256, 512, 32),
                                         (600, 1200, 128, 256, 70),
                                         (96, 300, 32, 128, 70),
                                         (40, 256, 8, 128, 32)])
def test_ghost_block_active_matches_reference(q, p, tq, tp, m):
    """Cell-sorted y with trailing padding and sparse x cell sets near each
    row's share of the cells (the engine's layout): the live-block map
    equals the reference's, and it both keeps and skips blocks."""
    rng = np.random.default_rng(q + tq + m)
    yg = np.sort(rng.integers(0, m, size=p)).astype(np.int32)
    yg[p - p // 7:] = -1
    sets = np.zeros((q, m), bool)
    for i in range(0, q, 3):
        sets[i, np.clip(i * m // q + rng.integers(-2, 3, size=2), 0,
                        m - 1)] = True
    gb = np.pad(pack_cells(sets), ((0, -q % tq), (0, 0)))
    yg = np.pad(yg, (0, -p % tp), constant_values=-1)
    ours = tops.ghost_block_active(as_words(gb), torch.from_numpy(yg), tq,
                                   tp)
    ref = jops.ghost_block_active(jnp.asarray(gb), jnp.asarray(yg), tq, tp)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert ours.any() and not ours.all()


@pytest.mark.parametrize("metric", ["euclidean", "hamming", "manhattan"])
def test_ghost_tile_sorted_and_disjoint(metric):
    """The shared cases of the card's test, on the plain path: cell-sorted
    y skips blocks and keeps its hits; disjoint cell sets hit nothing. The
    plain version against the reference's oracle."""
    for q, p, d, m, pattern in ((600, 1200, 9, 70, "sorted"),
                                (300, 515, 40, 70, "disjoint")):
        x, y, gb, yg, eps = ghost_case(metric, q, p, d, m, q + d, pattern)
        cnt, bits, sched, skip = tops.nng_tile_bits_ghost(
            *(as_words(a) for a in (x, y, gb, yg)), eps, metric=metric)
        rc, rb, rs, rk = jops.nng_tile_bits_ghost(x, y, gb, yg, eps,
                                                  metric=metric)
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(rc))
        np.testing.assert_array_equal(as_u32(bits), np.asarray(rb))
        assert (int(sched), int(skip)) == (int(rs), int(rk))
        assert 0 < int(skip) <= int(sched)
        if pattern == "disjoint":
            assert int(skip) == int(sched) and not bits.any()
        else:
            assert int(cnt.sum()) > 0


def test_ghost_tile_generic_path_matches_plain():
    """A user metric with only ``cdist`` (here L2's own) takes the generic
    path (``ghost_hit`` over ``metric.cdist``) and gives the plain L2
    version's bits."""
    from repro_torch.core.metrics import Metric
    euc = get_metric("euclidean")
    user = Metric(name="l2-user", host=euc.host, cdist=euc.cdist)
    x, y, gb, yg, eps = ghost_case("euclidean", 70, 130, 6, 70, 5)
    args = [as_words(a) for a in (x, y, gb, yg)]
    got = tops.nng_tile_bits_ghost(*args, eps, metric=user)
    want = tops.nng_tile_bits_ghost(*args, eps, metric="euclidean")
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[0].sum()) > 0


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
    w = torch.zeros((4, 3), dtype=torch.int32)
    for fn, pts in ((tnt.nng_tile_hamming_cuda, w), (tnt.nng_tile_l1_cuda, x)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(pts, pts, i4, 1.0)
    for fn, pts in ((ttf.tree_frontier_hamming_cuda, w),
                    (ttf.tree_frontier_l1_cuda, x)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(pts, pts, torch.zeros(4), i4,
               torch.zeros((4, 1), dtype=torch.int32), 1.0)
    for fn, pts in ((tnt.nng_tile_grouped_cuda, x),
                    (tnt.nng_tile_grouped_hamming_cuda, w),
                    (tnt.nng_tile_grouped_l1_cuda, x)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(pts, pts, i4, i4, i4, i4, 1.0)
    for fn, pts in ((tnt.nng_tile_ghost_cuda, x),
                    (tnt.nng_tile_ghost_hamming_cuda, w),
                    (tnt.nng_tile_ghost_l1_cuda, x)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(pts, pts, torch.zeros((4, 1), dtype=torch.int32), i4, 1.0)


def test_cpu_dispatch_takes_plain_version():
    def counts():
        return (tnt.nng_tile_cuda.launches, tbe.bits_to_cols_cuda.launches,
                ttf.tree_frontier_cuda.launches,
                tbe.leaf_range_pack_cuda.launches,
                tnt.nng_tile_hamming_cuda.launches,
                tnt.nng_tile_l1_cuda.launches,
                ttf.tree_frontier_hamming_cuda.launches,
                ttf.tree_frontier_l1_cuda.launches,
                tnt.nng_tile_grouped_cuda.launches,
                tnt.nng_tile_grouped_hamming_cuda.launches,
                tnt.nng_tile_grouped_l1_cuda.launches,
                tnt.nng_tile_ghost_cuda.launches,
                tnt.nng_tile_ghost_hamming_cuda.launches,
                tnt.nng_tile_ghost_l1_cuda.launches)
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
    w = torch.randint(-2**31, 2**31 - 1, (10, 3), dtype=torch.int32)
    for metric, pts in (("hamming", w), ("manhattan", x)):
        tops.nng_tile_bits(pts, pts, torch.ones(10, dtype=torch.int32), 1.0,
                           metric=metric)
        tops.tree_frontier_step(pts, pts[:8], torch.ones(8),
                                torch.zeros(8, dtype=torch.int32),
                                torch.full((10, 1), -1, dtype=torch.int32),
                                1.0, metric=metric)
    g = torch.zeros(10, dtype=torch.int32)
    for metric, pts in (("euclidean", x), ("hamming", w), ("manhattan", x)):
        tops.nng_tile_bits_grouped(pts, pts, g, g, torch.arange(10),
                                   torch.arange(10), 1.0, metric=metric)
        tops.nng_tile_bits_ghost(pts, pts, torch.ones((10, 1),
                                                  dtype=torch.int32), g, 1.0,
                                 metric=metric)
    assert counts() == before
