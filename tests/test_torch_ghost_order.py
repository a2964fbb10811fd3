"""The ghost L2 and L1 kernels' row order and live-tile list, on the CPU.

``nng_tile_ghost_cuda`` and ``nng_tile_ghost_l1_cuda`` order the visiting
rows by their ghost cells among this launch's local ones
(``ghost_row_order``), list the live 64 x 256 tiles of that order
(``ghost_tile_plan``) and compute those tiles only, storing each row's
words in the caller's order. None of that needs the card: here the plan
runs on CPU tensors, and a torch emulation of the launch (the plain
version on the gathered rows, the dead tiles' pairs dropped, the rows
mapped back) stands in for the kernel. Both are held to the reference's
``nng_tile_ghost_ref`` (L2) and ``nng_tile_ghost_l1_ref`` (L1) on the same
numpy inputs, bit for bit, at gap-safe eps.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import nng_tile as jnt
from repro_torch.kernels import nng_tile as tnt
from tests.test_torch_kernels_gpu import as_words, gap_safe_eps, pack_cells

TQ, TP = tnt.PIPE_TILE


def order_case(q, p, m, pattern, seed):
    """x cell words (q, ceil(m/32)) uint32 and y cells (p,) int32.

    "sorted": y cells ascending with trailing padding (-1), the engine's
    cell-sorted W, and each row 1-3 cells near its share of the cells;
    "interleave": y sorted, row i's cells {7i mod m, 7i + 1 mod m}, so that
    keys interleave in the caller's order; "random": unsorted y cells in
    [-1, m) and random sets of density 0.3; "dead": y cells in [m/2, m) and
    sets inside [0, m/2), so every key is zero; "live": every y row valid
    and every set full, so every tile is live. Every ninth row has no
    cell in the first three patterns."""
    rng = np.random.default_rng(seed)
    sets = np.zeros((q, m), bool)
    if pattern in ("sorted", "interleave"):
        yg = np.sort(rng.integers(0, m, size=p))
        yg[p - p // 7:] = -1
        for i in range(q):
            near = (i * m // q + rng.integers(-2, 3, size=rng.integers(1, 4))
                    if pattern == "sorted" else
                    np.array([7 * i, 7 * i + 1]) % m)
            sets[i, np.clip(near, 0, m - 1)] = True
    elif pattern == "random":
        yg = rng.integers(-1, m, size=p)
        sets = rng.random((q, m)) < 0.3
    elif pattern == "dead":
        yg = rng.integers(m // 2, m, size=p)
        sets = rng.random((q, m)) < 0.3
        sets[:, m // 2:] = False
    else:
        yg = rng.integers(0, m, size=p)
        sets[:] = True
    if pattern in ("sorted", "interleave", "random"):
        sets[::9] = False
    return pack_cells(sets), yg.astype(np.int32)


SHAPES = [(1, 1), (63, 255), (65, 257), (300, 700), (129, 1300)]
PATTERNS = ["sorted", "interleave", "random", "dead", "live"]


def local_keys_np(gb, yg):
    """The reference's words restricted to the cells present in y."""
    mw = gb.shape[1]
    local = np.zeros(mw * 32, bool)
    local[yg[yg >= 0]] = True
    return gb & pack_cells(local[None])[0]


@pytest.mark.parametrize("m", [5, 32, 40])
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("q,p", SHAPES)
def test_ghost_row_order_groups_keys(q, p, m, pattern):
    """A permutation of x's rows; the keys are the words restricted to y's
    cells, equal keys contiguous, the zero keys last."""
    gb, yg = order_case(q, p, m, pattern, q + p + m)
    keys = tnt.ghost_local_keys(as_words(gb), torch.from_numpy(yg))
    np.testing.assert_array_equal(keys.numpy().view(np.uint32),
                                  local_keys_np(gb, yg))
    rows = tnt.ghost_row_order(as_words(gb), torch.from_numpy(yg))
    assert rows.dtype == torch.int64
    np.testing.assert_array_equal(np.sort(rows.numpy()), np.arange(q))
    ordered = [tuple(k) for k in keys[rows].numpy()]
    runs = sum(1 for i, k in enumerate(ordered) if i == 0
               or k != ordered[i - 1])
    assert runs == len(set(ordered))
    zero = [not any(k) for k in ordered]
    assert zero == sorted(zero)
    if pattern == "dead":
        assert all(zero)


def live_tiles_brute(keys, yg):
    """The 64 x 256 tiles of keys (in their order) x yg where some row's
    key has a bit inside the valid y cells' [min, max], tile by tile."""
    q, p = keys.shape[0], yg.shape[0]
    bits = np.unpackbits(keys.view(np.uint8), axis=1, bitorder="little")
    nt = -(-p // TP)
    live = set()
    for a in range(0, q, TQ):
        for b in range(0, p, TP):
            cells = yg[b:b + TP]
            cells = cells[cells >= 0]
            if len(cells) and bits[a:a + TQ, cells.min():cells.max() + 1
                                   ].any():
                live.add(a // TQ * nt + b // TP)
    return live


@pytest.mark.parametrize("m", [5, 32, 40])
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("q,p", SHAPES)
def test_ghost_tile_plan_covers_every_needed_pair(q, p, m, pattern):
    """At the kernel's 64 x 256 geometry under ``ghost_row_order``: the
    list holds every tile once, the live ones first, in row-major order,
    ``count`` of them, exactly the tiles of the block-skip rule; and every
    pair the function needs (row i, column j with bit yg[j] of gb[i])
    lies in a live tile. All-dead and all-live cases included."""
    gb, yg = order_case(q, p, m, pattern, 3 * q + p + m)
    rows, keys, tiles, count = tnt.ghost_tile_plan(as_words(gb),
                                                   torch.from_numpy(yg))
    mt, nt = -(-q // TQ), -(-p // TP)
    assert tiles.dtype == torch.int32 and count.dtype == torch.int32
    assert count.shape == (1,)
    n_live = int(count[0])
    t = tiles.numpy()
    np.testing.assert_array_equal(np.sort(t), np.arange(mt * nt))
    assert list(t[:n_live]) == sorted(t[:n_live])
    assert list(t[n_live:]) == sorted(t[n_live:])
    np.testing.assert_array_equal(keys.numpy(),
                                  local_keys_np(gb, yg).view(np.int32)[
                                      rows.numpy()])
    live = set(t[:n_live].tolist())
    assert live == live_tiles_brute(keys.numpy().view(np.uint32), yg)
    need = tnt.ghost_hit(torch.ones((q, p), dtype=torch.bool),
                         as_words(gb), torch.from_numpy(yg)).numpy()
    pos = np.empty(q, np.int64)
    pos[rows.numpy()] = np.arange(q)
    i, j = need.nonzero()
    assert {int(x) for x in pos[i] // TQ * nt + j // TP} <= live
    if pattern == "dead":
        assert n_live == 0 and not need.any()
    if pattern == "live":
        assert n_live == mt * nt


# metric -> (the port's plain ghost tile, the reference's oracle)
GHOST_REFS = {"euclidean": (tnt.nng_tile_ghost_ref, jnt.nng_tile_ghost_ref),
              "manhattan": (tnt.nng_tile_ghost_l1_ref,
                            jnt.nng_tile_ghost_l1_ref)}


def emulate_launch(x, y, gb, yg, eps, metric="euclidean"):
    """The ghost launch of ``nng_tile_ghost_cuda`` (L2) or
    ``nng_tile_ghost_l1_cuda`` (``metric="manhattan"``) on CPU tensors: the
    plain version over x gathered in the plan's order against y with the
    ordered keys for words, every pair outside the live tiles dropped, the
    counts and words stored at each row's place in x's order. Returns
    (cnt, bits) over p columns padded to 32."""
    q, p = x.shape[0], y.shape[0]
    rows, keys, tiles, count = tnt.ghost_tile_plan(gb, yg)
    pad = -p % 32
    yp = torch.nn.functional.pad(y, (0, 0, 0, pad))
    ygp = torch.nn.functional.pad(yg, (0, pad), value=-1)
    _, b = GHOST_REFS[metric][0](x[rows], yp, keys, ygp, eps)
    hit = tnt.unpack_words(b)
    nt = -(-p // TP)
    keep = torch.zeros_like(hit)
    for t in tiles[:int(count[0])].tolist():
        a, c = t // nt * TQ, t % nt * TP
        keep[a:a + TQ, c:c + TP] = True
    hit &= keep
    out = torch.zeros_like(hit)
    out[rows] = hit
    return out.sum(1, dtype=torch.int32), tnt.pack_words(out)


REORDER_CASES = [(63, 255, 3, 0.02), (300, 700, 9, 0.01),
                 (129, 1300, 16, 0.005)]


def check_reordered_maps_back(metric, q, p, d, quantile, m, pattern):
    """The ghost plain version of ``metric`` on the reordered rows (with the
    gathered words, or with the ordered keys as the kernel reads them),
    mapped back through ``rows``, and the emulated launch, each equal to
    the reference's oracle on the original rows, bit for bit, at a
    gap-safe eps."""
    gb, yg = order_case(q, p, m, pattern, q + 5 * p + m)
    rng = np.random.default_rng(q + d + m)
    x = rng.normal(size=(q, d)).astype(np.float32)
    y = rng.normal(size=(p, d)).astype(np.float32)
    eps = gap_safe_eps(x, y, quantile, metric=metric,
                       window=int(q * p * quantile / 4))
    pad = -p % 32
    yp = np.pad(y, ((0, pad), (0, 0)))
    ygp = np.pad(yg, (0, pad), constant_values=-1)
    plain, oracle = GHOST_REFS[metric]
    rc, rb = oracle(jnp.asarray(x), jnp.asarray(yp), jnp.asarray(gb),
                    jnp.asarray(ygp), eps)
    rc, rb = np.asarray(rc), np.asarray(rb).view(np.int32)
    xt, gbt, ygt = torch.from_numpy(x), as_words(gb), torch.from_numpy(yg)
    ypt, ygpt = torch.from_numpy(yp), torch.from_numpy(ygp)
    rows, keys, _, _ = tnt.ghost_tile_plan(gbt, ygt)
    for words in (gbt[rows], keys):
        c, b = plain(xt[rows], ypt, words, ygpt, eps)
        cb, bb = torch.empty_like(c), torch.empty_like(b)
        cb[rows], bb[rows] = c, b
        np.testing.assert_array_equal(cb.numpy(), rc)
        np.testing.assert_array_equal(bb.numpy(), rb)
    c, b = emulate_launch(xt, torch.from_numpy(y), gbt, ygt, eps, metric)
    np.testing.assert_array_equal(c.numpy(), rc)
    np.testing.assert_array_equal(b.numpy(), rb)
    if pattern == "dead":
        assert not rc.any()
    elif pattern != "live" or q * p > 20_000:
        assert rc.sum() > 0


@pytest.mark.parametrize("m", [5, 32, 40])
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("q,p,d,quantile", REORDER_CASES)
def test_reordered_ghost_ref_maps_back(q, p, d, quantile, m, pattern):
    """``nng_tile_ghost_ref`` on the reordered rows (with the gathered
    words, or with the ordered keys as the kernel reads them), mapped back
    through ``rows``, equals it on the original rows, and so does the
    emulated launch (dead tiles dropped): all equal to the reference's
    ``nng_tile_ghost_ref``, bit for bit, at a gap-safe eps."""
    check_reordered_maps_back("euclidean", q, p, d, quantile, m, pattern)


@pytest.mark.parametrize("m", [5, 32, 40])
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("q,p,d,quantile", REORDER_CASES)
def test_reordered_ghost_l1_ref_maps_back(q, p, d, quantile, m, pattern):
    """The same for the L1 kernel's launch: ``nng_tile_ghost_l1_ref`` on
    ``ghost_tile_plan``'s rows and keys, mapped back, and the emulated
    live-tile launch, both equal to the reference's
    ``nng_tile_ghost_l1_ref``, bit for bit, at a gap-safe L1 eps."""
    check_reordered_maps_back("manhattan", q, p, d, quantile, m, pattern)
