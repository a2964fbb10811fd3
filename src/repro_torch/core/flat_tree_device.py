"""On-card cover-forest construction (Alg. 1 + 2) in torch.

The port of the reference's on-device builder: it makes the same decisions
as ``covertree.build_covertree`` + ``flat_tree.flatten_forest`` and emits
the levelized ``FlatCoverTree`` tables as tensors directly, so the forest
never exists as host objects and no table crosses from the host. The host
path stays the float64 oracle (``flat_tree.build_block_forests`` and
``build_cell_forests`` with ``backend="host"``).

Formulation (the host build's decision sequence, so the two paths give
structurally identical tables at matching precision). Every rank's tree is
built at once: the ranks are the leading axis of every tensor.

- Point state is the host's (D, L) pair plus ``pslot`` — the flat SLOT of
  the node that currently owns the point (hub slots while splitting, dump
  slots for members pending leaf emission, -1 once retired into a leaf).
- Alg. 1 is a loop of farthest-point picks, one per unfinished hub per
  iteration: a segmented max of D over ``pslot`` (``scatter_reduce_``
  "amax"), the lowest-index tie break by a segmented "amin" of the point
  index, then one batched row-aligned TRUE distance through the ``Metric``
  registry (diff form, so radii carry no cancellation at large coordinate
  scale). Only the points of unfinished hubs are evaluated; the loop ends
  when no hub is unfinished (the card reports it once per iteration).
- Alg. 2 groups points by (pslot, L) with a stable double sort — the sort
  order IS the BFS child order of the host flatten (parent-slot major,
  center ascending) — and reduces each group's center / radius / size with
  segmented scatters. Child slot ranges are the exclusive cumsum of
  per-parent child counts.
- Dump groups reuse the group machinery: members get (D, L) = (0, self),
  so each reappears one level down as a singleton leaf child in ascending
  point order — the host's Alg. 2 lines 10-12 emission.
- DFS leaf ranges come from a bottom-up per-level leaf-count pass and a
  top-down prefix-offset pass (leaf_lo[g] = leaf_lo[parent] + leaves of the
  preceding siblings); leaf_ids scatter level by level.

Levels are produced until no point is left in a hub. The level tables
start at ``max_levels`` (``estimate_max_levels``) and regrow by doubling
when the build needs more, capped at 512; then they are trimmed to the
levels and width in use.

Online maintenance works on the stacked tables in place of the
reference's jit + vmap scatter: ``insert_stacked_device`` appends each new
point as a singleton root of its rank's forest (torch scatters on the
tables' device; on overflow the padding doubles, ``_grow_stacked``, and
the insert retries) and ``tombstone_stacked_device`` masks deleted ids out
of ``leaf_ids``.
"""
from __future__ import annotations

import numpy as np
import torch

from .metrics import Metric, get_metric

PAD = -1
SENTINEL_ID = 2**31 - 1
MAX_LEVELS_CAP = 512


def _round_up(v: int, mult: int) -> int:
    return ((v + mult - 1) // mult) * mult


def _as_device_metric(metric) -> Metric:
    if isinstance(metric, Metric):
        return metric
    if isinstance(metric, str):
        return get_metric(metric)
    return get_metric(metric.name)        # HostMetric carries its name


def _seg(idx, src, n_out: int, fill, reduce: str):
    """Per-rank segmented reduction: out[r, idx[r, i]] (reduce)= src[r, i]
    over an (R, n_out + 1) table started at ``fill``; index n_out is the
    spill slot for masked entries and is cut off."""
    out = torch.full((idx.shape[0], n_out + 1), fill, dtype=src.dtype,
                     device=src.device)
    if reduce == "sum":
        out.scatter_add_(1, idx.long(), src)
    else:
        out.scatter_reduce_(1, idx.long(), src, reduce=reduce,
                            include_self=True)
    return out[:, :n_out]


def _take(table, idx):
    """Per-rank gather: table (R, M), idx (R, K) -> (R, K)."""
    return torch.gather(table, 1, idx.long())


def _build_stacked(pts, cells, gids, tslot, met: Metric, leaf_size: int,
                   max_levels: int = 8, include_child_ranges: bool = False,
                   agree=None):
    """All ranks' padded member sets -> their stacked levelized tables.

    pts (R, P, d) coordinates (local rows), cells (R, P) int32 per-point
    cell id (PAD rows = padding), gids (R, P) int32 global point ids, tslot
    (R, P) int32 level-0 tree slot per point (-1 = padding); P % 32 == 0.
    Returns the ``stack_device_forests`` dict schema as tensors with a
    leading rank axis. ``include_child_ranges`` also keeps ``child_lo`` /
    ``child_hi`` (the traversal follows parent slots and does not read
    them; the structural parity tests do).

    Each rank's tree is built on its own, so a build of some of the ranks
    gives their rows of the build of all, once both trim to the same
    levels and width: ``agree(levels, width)`` returns the ones to trim
    to (the maxima over the processes that build the other ranks). Levels
    past a rank's last hold what a finished rank's do in the build of
    all: no valid slot, every slot's coordinates its first point's.
    """
    R, P = tslot.shape
    dim = pts.shape[2:]
    dev = pts.device
    N = P                                    # level width bound
    i32 = torch.int32
    pidx = torch.arange(P, dtype=i32, device=dev).expand(R, P)
    flat_pts = pts.reshape((R * P,) + tuple(dim))

    def rowwise_at(ranks, rows, cols):
        """True distances pts[ranks[i], rows[i]] to pts[ranks[i], cols[i]]."""
        base = ranks.long() * P
        return met.rowwise_true(flat_pts[base + rows.long()],
                                flat_pts[base + cols.long()]).to(
                                    torch.float32)

    # ---- level 0: one root slot per tree -----------------------------------
    valid = tslot >= 0
    ts = torch.where(valid, tslot, N)
    tsc = tslot.clamp(0, N - 1)
    root = _seg(ts, torch.where(valid, pidx, P), N, P, "amin")
    tsize = _seg(ts, valid.to(i32), N, 0, "sum")
    rp = torch.where(valid, _take(root, tsc), 0)
    rr = torch.arange(R, device=dev)[:, None].expand(R, P)
    D = torch.where(valid, rowwise_at(rr.reshape(-1), pidx.reshape(-1),
                                      rp.clamp(0, P - 1).reshape(-1))
                    .reshape(R, P), 0.0)
    L = torch.where(valid, rp, 0).to(i32)
    hubr = _seg(ts, torch.where(valid, D, 0.0), N, 0.0, "amax")
    kind = torch.where(tsize == 0, -1, torch.where(tsize == 1, 0, 1))
    pslot = torch.where(valid & (_take(kind, tsc) == 1), tslot, -1).to(i32)

    rootc = root.clamp(0, P - 1)
    ptidx_t = [torch.where(kind >= 0, root, -1).to(i32)]
    rad_t = [hubr]
    cell_t = [torch.where(kind >= 0, _take(cells, rootc), PAD).to(i32)]
    leaf_t = [(kind == 0).to(i32)]
    par_t = [torch.zeros((R, N), dtype=i32, device=dev)]
    clo_t, chi_t = [], []

    # ---- level loop: produce level lvl + 1 from level lvl -------------------
    lvl = 0
    while True:
        psc = pslot.clamp(0, N - 1)
        active_pt = pslot >= 0
        if not bool(active_pt.any()):
            break
        if lvl + 1 >= max_levels:
            if max_levels >= MAX_LEVELS_CAP:
                raise RuntimeError(
                    f"device forest build exceeded {MAX_LEVELS_CAP} levels")
            max_levels = min(2 * max_levels, MAX_LEVELS_CAP)

        # Alg. 1: one farthest-point pick per unfinished hub per iteration
        is_hub = kind == 1
        done = torch.where(is_hub, hubr <= 0.0, True)
        for _ in range(P):
            pv = active_pt & _take(is_hub, psc) & ~_take(done, psc)
            hmax = _seg(torch.where(pv, pslot, N),
                        torch.where(pv, D, -1.0), N, -1.0, "amax")
            done = done | (~done & (hmax <= hubr * 0.5))
            pa = active_pt & _take(is_hub & ~done, psc)
            r_i, p_i = pa.nonzero(as_tuple=True)
            if r_i.numel() == 0:
                break
            cand = pa & (D >= _take(hmax, psc))
            cen = _seg(torch.where(cand, pslot, N),
                       torch.where(cand, pidx, P), N, P, "amin")
            c_i = cen[r_i, pslot[r_i, p_i].long()]
            dnew = rowwise_at(r_i, p_i, c_i)
            d_old, l_old = D[r_i, p_i], L[r_i, p_i]
            upd = dnew < d_old
            iscen = p_i.to(i32) == c_i
            D[r_i, p_i] = torch.where(iscen, 0.0,
                                      torch.where(upd, dnew, d_old))
            L[r_i, p_i] = torch.where(iscen, p_i.to(i32),
                                      torch.where(upd, c_i, l_old))

        # Alg. 2: group by (pslot, L) — the stable double sort is BFS order
        Lm = torch.where(active_pt, L, P)
        Pm = torch.where(active_pt, pslot, N)
        o1 = torch.argsort(Lm, dim=1, stable=True)
        o2 = torch.argsort(_take(Pm, o1), dim=1, stable=True)
        order = _take(o1, o2)
        s_ps = _take(Pm, order)
        s_L = _take(Lm, order)
        s_valid = torch.gather(active_pt, 1, order)
        first_col = torch.full((R, 1), -9, dtype=i32, device=dev)
        prev_ps = torch.cat([first_col, s_ps[:, :-1]], dim=1)
        prev_L = torch.cat([first_col, s_L[:, :-1]], dim=1)
        newg = s_valid & ((s_ps != prev_ps) | (s_L != prev_L))
        gidx = torch.cumsum(newg.to(i32), dim=1, dtype=i32) - 1
        gsl = torch.where(s_valid, gidx, N)
        gcen = _seg(gsl, torch.where(s_valid, s_L, -1), N, -1, "amax")
        gpar = _seg(gsl, torch.where(s_valid, s_ps, 0), N, 0, "amax")
        grad = _seg(gsl, torch.where(s_valid, _take(D, order), 0.0), N, 0.0,
                    "amax")
        gsize = _seg(gsl, s_valid.to(i32), N, 0, "sum")
        gvalid = gsize > 0
        pgroup = torch.zeros((R, P), dtype=i32, device=dev).scatter_(
            1, order, gsl.to(i32))

        # child slot ranges on the current level (exclusive cumsum of
        # per-parent child counts — empty ranges at the running position)
        ccount = _seg(torch.where(gvalid, gpar, N), gvalid.to(i32), N, 0,
                      "sum")
        clo_cur = torch.cumsum(ccount, dim=1, dtype=i32) - ccount
        cur_valid = kind >= 0
        clo_t.append(torch.where(cur_valid, clo_cur, 0))
        chi_t.append(torch.where(cur_valid, clo_cur + ccount, 0))

        # classify: singleton -> leaf; big & spread -> hub; else dump
        gleaf = gvalid & (gsize == 1)
        ghub = gvalid & (gsize > leaf_size) & (grad > 0.0)
        kind_n = torch.where(gleaf, 0, torch.where(
            ghub, 1, torch.where(gvalid, 2, -1)))
        gparc = gpar.clamp(0, N - 1)
        ptidx_t.append(torch.where(gvalid, gcen, -1).to(i32))
        rad_t.append(grad)
        cell_t.append(torch.where(gvalid, _take(cell_t[lvl], gparc),
                                  PAD).to(i32))
        leaf_t.append(gleaf.to(i32))
        par_t.append(torch.where(gvalid, gpar, 0).to(i32))

        # point state: leaves retire; dump members become their own centers
        kp = torch.where(active_pt, _take(kind_n, pgroup.clamp(0, N - 1)), -1)
        pslot = torch.where(kp <= 0, -1, pgroup).to(i32)
        dumpm = kp == 2
        L = torch.where(dumpm, pidx, L)
        D = torch.where(dumpm, 0.0, D)
        kind, hubr = kind_n, grad
        lvl += 1
    # the last level's nodes are all leaves: empty child ranges
    zeros = torch.zeros((R, N), dtype=i32, device=dev)
    clo_t.append(zeros)
    chi_t.append(zeros)
    M = len(cell_t)

    # ---- DFS leaf ranges: bottom-up counts, top-down prefix offsets --------
    valid_n = [c != PAD for c in cell_t]
    lc = [None] * M
    for lv in range(M - 1, -1, -1):
        own = (valid_n[lv] & (leaf_t[lv] != 0)).to(i32)
        if lv + 1 < M:
            own = own + _seg(torch.where(valid_n[lv + 1], par_t[lv + 1], N),
                             lc[lv + 1], N, 0, "sum")
        lc[lv] = own
    ll = [torch.cumsum(lc[0], dim=1, dtype=i32) - lc[0]]
    for lv in range(1, M):
        C = torch.cumsum(lc[lv], dim=1, dtype=i32) - lc[lv]
        par = par_t[lv].clamp(0, N - 1)
        first = _take(clo_t[lv - 1], par).clamp(0, N - 1)
        ll.append(_take(ll[lv - 1], par) + C - _take(C, first))
    leaf_lo_t = [torch.where(v, a, 0) for v, a in zip(valid_n, ll)]
    leaf_hi_t = [torch.where(v, a + c, 0) for v, a, c in zip(valid_n, ll, lc)]

    leaf_ids = torch.full((R, P + 1), SENTINEL_ID, dtype=i32, device=dev)
    for lv in range(M):
        isleaf = valid_n[lv] & (leaf_t[lv] != 0)
        pos = torch.where(isleaf, leaf_lo_t[lv], P)
        gid_lvl = _take(gids, ptidx_t[lv].clamp(0, P - 1))
        leaf_ids.scatter_(1, pos.long(),
                          torch.where(isleaf, gid_lvl, SENTINEL_ID))
    leaf_ids = leaf_ids[:, :P].contiguous()

    # trim to the levels and width in use (valid slots are a prefix of every
    # level, so cutting the width to the forest-wide max is range-safe)
    vn = torch.stack(valid_n, dim=1)                     # (R, M, N)
    used = vn.any(2)
    Lu = max(int(used.sum(1).max()), 1)
    W = _round_up(max(int(vn.sum(2).max()), 1), 32)
    if agree is not None:
        Lu, W = agree(Lu, W)
    for t, fill in ((ptidx_t, -1), (cell_t, PAD), (rad_t, 0), (leaf_t, 0),
                    (par_t, 0), (leaf_lo_t, 0), (leaf_hi_t, 0), (clo_t, 0),
                    (chi_t, 0)):
        t += [torch.full_like(t[-1], fill) for _ in range(Lu - len(t))]

    def stack(ts):
        return torch.stack(ts[:Lu], dim=1)[:, :, :W].contiguous()

    ptidx = stack(ptidx_t).clamp(0, P - 1)
    coords = torch.gather(
        pts, 1, ptidx.reshape(R, -1, 1).long().expand(-1, -1, *dim)
    ).reshape((R, Lu, W) + tuple(dim))
    tabs = {
        "coords": coords,
        "radius": stack(rad_t),
        "cell": stack(cell_t),
        "leaf": stack(leaf_t),
        "parent": stack(par_t),
        "leaf_lo": stack(leaf_lo_t),
        "leaf_hi": stack(leaf_hi_t),
    }
    if include_child_ranges:
        tabs["child_lo"] = stack(clo_t)
        tabs["child_hi"] = stack(chi_t)
    tabs["leaf_ids"] = leaf_ids
    return tabs


# ---------------------------------------------------------------------------
# public builder (the backend="device" path of flat_tree.build_block_forests)
# ---------------------------------------------------------------------------

def _local_build(mesh, nranks: int):
    """(the rows of the ranks to build, ``agree``) for ``mesh``: every
    rank, or on a mesh over processes only this process's ranks, trimmed
    to the levels and width that all processes' builds agree on (one
    all-reduce), so each process's tables equal its rows of the build of
    all."""
    if mesh is None or mesh.world == 1:
        return slice(None), None
    if mesh.size != nranks:
        raise ValueError(f"a forest of {nranks} ranks on a mesh of "
                         f"{mesh.size}")
    from .distributed import comm
    loc = mesh.local_ranks
    return (slice(loc.start, loc.stop),
            lambda levels, width: comm.all_max(mesh, levels, width))


def estimate_max_levels(points, met, sample: int = 256) -> int:
    """Host-side first size of the level tables.

    The hub split halves the radius every level (Alg. 1 ends a hub at
    ``hmax <= hubr * 0.5``), so the forest depth is ~log2(span / leaf
    spacing). Both scales come from a small sample: ``r0`` = max true
    distance from the sample's first point, ``delta`` = median nearest-
    neighbour distance within the sample; +1 level of headroom, clamped to
    [4, 64]. An underestimate only regrows the tables."""
    n = len(points)
    if n < 2:
        return 4
    idx = np.linspace(0, n - 1, min(sample, n)).astype(np.int64)
    if torch.is_tensor(points):     # copy only the sample to the host
        sub = points[torch.from_numpy(idx).to(points.device)].cpu().numpy()
    else:
        sub = np.asarray(points)[idx]
    hm = met.host
    dm = np.asarray(hm.true(hm.cdist(sub, sub)), np.float64)
    r0 = float(dm[0].max())
    np.fill_diagonal(dm, np.inf)
    delta = float(np.median(dm.min(axis=1)))
    if not np.isfinite(delta) or delta <= 0.0 or r0 <= delta:
        return 8
    return int(np.clip(int(np.ceil(np.log2(r0 / delta))) + 1, 4, 64))


def build_block_forests_device(points, nranks: int, metric="euclidean",
                               leaf_size: int = 10,
                               max_levels: int | None = None, *,
                               include_child_ranges: bool = False,
                               device=None, mesh=None):
    """Systolic engine forests on the card: one tree per contiguous block.

    Same partitioning contract as ``flat_tree.build_block_forests``;
    returns the stacked device-tables dict (tensors on ``device``, default
    the CUDA card, leading rank axis) that ``stack_device_forests`` would
    produce from the host path. On a ``mesh`` over processes each process
    builds its own ranks' trees only (its rows of that dict)."""
    met = _as_device_metric(metric)
    if device is None:
        device = points.device if torch.is_tensor(points) else "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: pass device='cpu' "
                           "to build the forest with torch on the CPU")
    pts = met.as_device(points, dev)
    if max_levels is None:
        max_levels = estimate_max_levels(pts, met)
    n = pts.shape[0]
    assert n % nranks == 0, (n, nranks)
    n_loc = n // nranks
    P = _round_up(n_loc, 32)
    ptsb = torch.zeros((nranks, P) + tuple(pts.shape[1:]), dtype=met.dtype,
                       device=dev)
    ptsb[:, :n_loc] = pts.reshape((nranks, n_loc) + tuple(pts.shape[1:]))
    cellsb = torch.full((nranks, P), PAD, dtype=torch.int32, device=dev)
    cellsb[:, :n_loc] = 0
    gidsb = torch.zeros((nranks, P), dtype=torch.int32, device=dev)
    gidsb[:, :n_loc] = torch.arange(n, dtype=torch.int32,
                                    device=dev).reshape(nranks, n_loc)
    tslotb = torch.full((nranks, P), -1, dtype=torch.int32, device=dev)
    tslotb[:, :n_loc] = 0
    sel, agree = _local_build(mesh, nranks)
    return _build_stacked(ptsb[sel], cellsb[sel], gidsb[sel], tslotb[sel],
                          met, int(leaf_size), int(max_levels),
                          include_child_ranges, agree)


def build_cell_forests_device(points, cell, f, nranks: int,
                              metric="euclidean", leaf_size: int = 10,
                              max_levels: int | None = None, *,
                              include_child_ranges: bool = False,
                              device=None, mesh=None):
    """Landmark engine forests on the card: per rank, one tree per owned
    cell (``f``: cell -> rank), in ascending cell id, its nodes stamped with
    the cell; a rank that owns no points gets the 1-node placeholder tree
    of cell -2 — the forest ``flat_tree.build_cell_forests`` builds on the
    host. ``cell`` (n,) is the Voronoi assignment. The member packing (rank
    major, cell ascending, point ascending) runs on ``device`` too, so no
    point crosses to the host. Returns the stacked device-tables dict (on
    a ``mesh`` over processes, this process's ranks' rows of it)."""
    met = _as_device_metric(metric)
    if device is None:
        device = points.device if torch.is_tensor(points) else "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: pass device='cpu' "
                           "to build the forest with torch on the CPU")
    pts = met.as_device(points, dev)
    if max_levels is None:
        max_levels = estimate_max_levels(pts, met)
    n = pts.shape[0]
    cell_t = torch.as_tensor(np.asarray(cell) if not torch.is_tensor(cell)
                             else cell, device=dev).long()
    f_t = torch.as_tensor(np.asarray(f) if not torch.is_tensor(f) else f,
                          device=dev).long()
    m = f_t.shape[0]
    rank = f_t[cell_t]
    order = torch.argsort(rank * m + cell_t, stable=True)
    counts = torch.bincount(rank, minlength=nranks)
    r_sorted = rank[order]
    pos = (torch.arange(n, device=dev)
           - (torch.cumsum(counts, 0) - counts)[r_sorted])
    # a cell's tree slot: the non-empty cells of its rank below it
    nonempty = (torch.bincount(cell_t, minlength=m) > 0).long()
    corder = torch.argsort(f_t * m + torch.arange(m, device=dev), stable=True)
    ne_sorted = nonempty[corder]
    ne_rank = torch.zeros(nranks, dtype=torch.long, device=dev)
    ne_rank.index_add_(0, f_t, nonempty)
    tslot_cell = torch.empty(m, dtype=torch.long, device=dev)
    tslot_cell[corder] = (torch.cumsum(ne_sorted, 0) - ne_sorted
                          - (torch.cumsum(ne_rank, 0) - ne_rank)[f_t[corder]])
    P = _round_up(max(int(counts.max()) if n else 0, 1), 32)
    ptsb = torch.zeros((nranks, P) + tuple(pts.shape[1:]), dtype=met.dtype,
                       device=dev)
    cellsb = torch.full((nranks, P), PAD, dtype=torch.int32, device=dev)
    gidsb = torch.zeros((nranks, P), dtype=torch.int32, device=dev)
    tslotb = torch.full((nranks, P), -1, dtype=torch.int32, device=dev)
    ptsb[r_sorted, pos] = pts[order]
    cellsb[r_sorted, pos] = cell_t[order].to(torch.int32)
    gidsb[r_sorted, pos] = order.to(torch.int32)
    tslotb[r_sorted, pos] = tslot_cell[cell_t[order]].to(torch.int32)
    # placeholder trees: point 0 under the unmatchable cell -2
    empty = counts == 0
    ptsb[empty, 0] = pts[0]
    cellsb[empty, 0] = -2
    gidsb[empty, 0] = 0
    tslotb[empty, 0] = 0
    sel, agree = _local_build(mesh, nranks)
    return _build_stacked(ptsb[sel], cellsb[sel], gidsb[sel], tslotb[sel],
                          met, int(leaf_size), int(max_levels),
                          include_child_ranges, agree)


# ---------------------------------------------------------------------------
# online maintenance on the stacked tables (repro_torch.stream's device
# insert backend)
# ---------------------------------------------------------------------------

def _grow_stacked(tabs: dict) -> dict:
    """Double both the level width and the leaf capacity of stacked tables
    (the builder's regrow-on-overflow doubling): PAD cells, SENTINEL leaf
    ids, zeros elsewhere, on the tables' device."""
    out = {}
    for k, a in tabs.items():
        a = torch.as_tensor(a)
        if k == "leaf_ids":
            out[k] = torch.cat([a, torch.full_like(a, SENTINEL_ID)], dim=1)
        else:
            pad = torch.full_like(a, PAD if k == "cell" else 0)
            out[k] = torch.cat([a, pad], dim=2)
    return out


def _insert_roots(tabs: dict, newp, newg, newc, newr):
    """Scatter each batch point as a singleton root of its owning rank:
    level-0 slot ``used0 + k`` (the rank's k-th new point), leaf position
    ``usedl + k``. Returns the new tables, or None when a rank's level 0 or
    leaf table has no room (nothing is written then)."""
    cell = tabs["cell"]
    R, _, N = cell.shape
    nl = tabs["leaf_ids"].shape[1]
    used0 = (cell[:, 0] != PAD).sum(1)                       # (R,)
    usedl = tabs["leaf_hi"].reshape(R, -1).amax(1).long()     # (R,)
    onehot = torch.nn.functional.one_hot(newr, R)             # (b, R)
    cnt = onehot.sum(0)
    if bool(((used0 + cnt > N) | (usedl + cnt > nl)).any()):
        return None
    k = (torch.cumsum(onehot, 0) - 1).gather(1, newr[:, None])[:, 0]
    sl = used0[newr] + k
    lp = usedl[newr] + k
    zero = torch.zeros_like(newr)
    at = (newr, zero, sl)
    out = {key: a.clone() for key, a in tabs.items()}
    out["coords"][at] = newp
    out["radius"][at] = 0
    out["cell"][at] = newc.to(out["cell"].dtype)
    out["leaf"][at] = 1
    out["parent"][at] = 0
    out["leaf_lo"][at] = lp.to(out["leaf_lo"].dtype)
    out["leaf_hi"][at] = (lp + 1).to(out["leaf_hi"].dtype)
    out["leaf_ids"][newr, lp] = newg.to(out["leaf_ids"].dtype)
    return out


def insert_stacked_device(tabs: dict, new_points, new_gids, new_ranks,
                          new_cells=None) -> dict:
    """Batched incremental insert into stacked forest tables, as torch ops
    on the tables' device.

    Each new point is appended as a singleton ROOT of its owning rank's
    forest (cell ``new_cells``, default 0): exact by construction (roots
    are always on the traversal frontier), at the cost of one more root
    per insert until the next full rebuild; the host descent path
    (``FlatCoverTree.insert_host``) is the structure-preserving variant.
    When a rank's padded width or leaf table overflows, both double
    (``_grow_stacked``) and the insert retries. Returns new tables; the
    input tables are left as they were."""
    dev = torch.as_tensor(tabs["cell"]).device
    tabs = {k: torch.as_tensor(v, device=dev) for k, v in tabs.items()}
    # uint32 word rows (numpy tables of the Hamming metric) are scattered
    # as their int32 bit view, which torch can index, and returned as given
    words = tabs["coords"].dtype == torch.uint32
    if words:
        tabs["coords"] = tabs["coords"].view(torch.int32)
    newp = torch.as_tensor(np.asarray(new_points) if not
                           torch.is_tensor(new_points) else new_points)
    if newp.dtype == torch.uint32:
        newp = newp.view(torch.int32)
    newp = newp.to(device=dev, dtype=tabs["coords"].dtype)
    newg = torch.as_tensor(np.asarray(new_gids, np.int64), device=dev)
    newr = torch.as_tensor(np.asarray(new_ranks, np.int64), device=dev)
    newc = (torch.zeros_like(newg) if new_cells is None else
            torch.as_tensor(np.asarray(new_cells, np.int64), device=dev))
    while True:
        out = _insert_roots(tabs, newp, newg, newc, newr)
        if out is not None:
            if words:
                out["coords"] = out["coords"].view(torch.uint32)
            return out
        tabs = _grow_stacked(tabs)


def tombstone_stacked_device(tabs: dict, dead_ids) -> dict:
    """Mask deleted points in stacked tables: every emission on the card
    flows through leaf ranges (``leaf_range_pack`` drops SENTINEL entries),
    so rewriting ``leaf_ids`` alone hides them; dead singleton roots' and
    leaves' coordinates stay as harmless routing pivots. Returns new
    tables."""
    lid = torch.as_tensor(tabs["leaf_ids"])
    dead = torch.as_tensor(np.asarray(dead_ids, np.int64), device=lid.device)
    out = dict(tabs)
    out["leaf_ids"] = torch.where(torch.isin(lid.long(), dead),
                                  torch.full_like(lid, SENTINEL_ID), lid)
    return out
