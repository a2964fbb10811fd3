"""The grouped L2 kernel's live-tile list, on the CPU.

``nng_tile_grouped_cuda`` lists the 64 x 256 tiles of its (q, p) output
whose rows and columns can share a valid group (``grouped_tile_plan``: the
block-skip rule of ``ops.grouped_block_active`` at that geometry, the live
tiles first) and computes those tiles only; the words of the others stay
zero. None of that needs the card: here the plan runs on CPU tensors, and
a torch emulation of the launch (the plain version with every pair outside
the listed live tiles dropped) stands in for the kernel. The emulation is
held to the port's ``nng_tile_grouped_ref`` and to the reference's
``nng_tile_grouped`` (its jnp oracle and its Pallas kernel in interpret
mode, through ``repro.kernels.nng_tile_bits_grouped``, as the reference's
own tests run it on the CPU), bit for bit, at gap-safe eps.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import nng_tile as jnt
from repro.kernels import ops as jops
from repro_torch.kernels import nng_tile as tnt
from tests.test_torch_kernels_gpu import gap_safe_eps

TQ, TP = tnt.PIPE_TILE


def group_case(q, p, pattern, seed):
    """Groups (q,), (p,) and ids (q,), (p,), int32 numpy.

    "random": unsorted groups in [-1, 6); "sorted": ascending groups in
    [0, 40) with trailing padding (-1) on both sides, the engine's
    cell-sorted W and G; "disjoint": x groups in [0, 4), y groups in
    [10, 14), so no pair may hit; "single": every row of both sides in
    group 0; "padding": every x row padding (-1). The first 4 x ids equal
    the first 4 y ids (the self-pair exclusion must fire)."""
    rng = np.random.default_rng(seed)
    if pattern == "random":
        xg, yg = rng.integers(-1, 6, size=q), rng.integers(-1, 6, size=p)
    elif pattern == "sorted":
        xg = np.sort(rng.integers(0, 40, size=q))
        yg = np.sort(rng.integers(0, 40, size=p))
        xg[q - q // 15:] = -1
        yg[p - p // 17:] = -1
    elif pattern == "disjoint":
        xg, yg = rng.integers(0, 4, size=q), rng.integers(10, 14, size=p)
    elif pattern == "single":
        xg, yg = np.zeros(q, np.int64), np.zeros(p, np.int64)
    else:
        xg, yg = np.full(q, -1), rng.integers(0, 6, size=p)
    xid = np.arange(q)
    yid = np.arange(37, 37 + p)
    xid[:min(4, q, p)] = yid[:min(4, q, p)]
    return tuple(a.astype(np.int32) for a in (xg, yg, xid, yid))


def needed(xg, yg, xid, yid):
    """(q, p) bool: the pairs the grouped function needs (same valid
    group, distinct ids)."""
    return ((xg[:, None] == yg[None, :]) & (yg >= 0)[None, :]
            & (xid[:, None] != yid[None, :]))


def live_tiles_brute(xg, yg):
    """The 64 x 256 tiles whose valid-group [min, max] ranges intersect,
    tile by tile."""
    q, p = len(xg), len(yg)
    nt = -(-p // TP)
    live = set()
    for a in range(0, q, TQ):
        gx = xg[a:a + TQ][xg[a:a + TQ] >= 0]
        for b in range(0, p, TP):
            gy = yg[b:b + TP][yg[b:b + TP] >= 0]
            if (len(gx) and len(gy) and gx.min() <= gy.max()
                    and gy.min() <= gx.max()):
                live.add(a // TQ * nt + b // TP)
    return live


SHAPES = [(1, 1), (63, 255), (65, 257), (300, 700), (129, 1300)]
PATTERNS = ["random", "sorted", "disjoint", "single", "padding"]


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("q,p", SHAPES)
def test_grouped_tile_plan_covers_every_needed_pair(q, p, pattern):
    """At the kernel's 64 x 256 geometry: the list holds every tile once,
    the live ones first, each part in ascending order, ``count`` of them,
    exactly the tiles of the block-skip rule; every pair the function
    needs lies in a live tile. All-dead and all-live cases included."""
    xg, yg, xid, yid = group_case(q, p, pattern, 3 * q + p)
    tiles, count = tnt.grouped_tile_plan(torch.from_numpy(xg),
                                         torch.from_numpy(yg))
    mt, nt = -(-q // TQ), -(-p // TP)
    assert tiles.dtype == torch.int32 and count.dtype == torch.int32
    assert count.shape == (1,)
    n_live = int(count[0])
    t = tiles.numpy()
    np.testing.assert_array_equal(np.sort(t), np.arange(mt * nt))
    assert list(t[:n_live]) == sorted(t[:n_live])
    assert list(t[n_live:]) == sorted(t[n_live:])
    live = set(t[:n_live].tolist())
    assert live == live_tiles_brute(xg, yg)
    i, j = needed(xg, yg, xid, yid).nonzero()
    assert {int(v) for v in i // TQ * nt + j // TP} <= live
    if pattern in ("disjoint", "padding"):
        assert n_live == 0 and len(i) == 0
    if pattern == "single":
        assert n_live == mt * nt


def emulate_launch(x, y, xg, yg, xid, yid, eps):
    """The launch of ``nng_tile_grouped_cuda`` on CPU tensors: the plain
    version over the whole output, every pair outside the plan's live
    tiles dropped (their words stay zero). Returns (cnt, bits) over p
    columns padded to 32."""
    p = y.shape[0]
    tiles, count = tnt.grouped_tile_plan(xg, yg)
    pad = -p % 32
    yp = torch.nn.functional.pad(y, (0, 0, 0, pad))
    ygp = torch.nn.functional.pad(yg, (0, pad), value=-1)
    yidp = torch.nn.functional.pad(yid, (0, pad), value=-1)
    _, b = tnt.nng_tile_grouped_ref(x, yp, xg, ygp, xid, yidp, eps)
    hit = tnt.unpack_words(b)
    nt = -(-p // TP)
    keep = torch.zeros_like(hit)
    for t in tiles[:int(count[0])].tolist():
        a, c = t // nt * TQ, t % nt * TP
        keep[a:a + TQ, c:c + TP] = True
    hit &= keep
    return hit.sum(1, dtype=torch.int32), tnt.pack_words(hit)


# (q, p, d, quantile of the pair distances for eps, the reference's Pallas
# kernel in interpret mode too)
WALK_CASES = [(63, 255, 3, 0.05, True), (300, 700, 9, 0.02, False),
              (129, 1300, 16, 0.01, True)]


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("q,p,d,quantile,interpret", WALK_CASES)
def test_emulated_grouped_walk_matches_reference(monkeypatch, q, p, d,
                                                 quantile, interpret,
                                                 pattern):
    """The emulated live-tile launch equals the port's plain version and
    the reference's ``nng_tile_grouped_ref`` (and its Pallas kernel in
    interpret mode, through ``nng_tile_bits_grouped``), bit for bit in
    counts and words, at a gap-safe eps."""
    xg, yg, xid, yid = group_case(q, p, pattern, q + 5 * p + d)
    rng = np.random.default_rng(q + d)
    x = rng.normal(size=(q, d)).astype(np.float32)
    y = rng.normal(size=(p, d)).astype(np.float32)
    eps = gap_safe_eps(x, y, quantile, window=int(q * p * quantile / 4))
    nw = -(-p // 32)
    pad = -p % 32
    padded = [np.pad(y, ((0, pad), (0, 0))),
              np.pad(yg, (0, pad), constant_values=-1),
              np.pad(yid, (0, pad), constant_values=-1)]
    rc, rb = jnt.nng_tile_grouped_ref(
        jnp.asarray(x), jnp.asarray(padded[0]), jnp.asarray(xg),
        jnp.asarray(padded[1]), jnp.asarray(xid), jnp.asarray(padded[2]),
        eps)
    refs = [(np.asarray(rc), np.asarray(rb).view(np.int32)[:, :nw])]
    if interpret:
        monkeypatch.setenv("REPRO_PALLAS", "interpret")
        c, b, _, _ = jops.nng_tile_bits_grouped(x, y, xg, yg, xid, yid, eps)
        refs.append((np.asarray(c), np.asarray(b).view(np.int32)[:, :nw]))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    gt = [torch.from_numpy(a) for a in (xg, yg, xid, yid)]
    c, b = emulate_launch(xt, yt, *gt, eps)
    pc, pb = tnt.nng_tile_grouped_ref(
        xt, torch.from_numpy(padded[0]), gt[0], torch.from_numpy(padded[1]),
        gt[2], torch.from_numpy(padded[2]), eps)
    for ours in ((c, b), (pc, pb)):
        for want_c, want_b in refs:
            np.testing.assert_array_equal(ours[0].numpy(), want_c)
            np.testing.assert_array_equal(ours[1].numpy()[:, :nw], want_b)
    want = needed(xg, yg, xid, yid)
    if pattern in ("disjoint", "padding"):
        assert not refs[0][0].any()
    else:
        assert want.any() and refs[0][0].sum() > 0
