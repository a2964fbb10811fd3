"""The cases of ``test_torch_dist.py``: each runs one call of the port on a
mesh and returns what the test compares. The test runs every case twice:
in processes started by ``repro_torch.launch.dist.spawn`` (gloo, a mesh
over the world) and, on the same inputs, on a ``RingMesh`` of as many
ranks in the test process. Imports no JAX."""
from __future__ import annotations

import contextlib
import hashlib

import numpy as np
import torch

from repro_torch.core.distributed import RingMesh, comm, make_nng_mesh
from repro_torch.core.flat_tree import build_block_forests
from repro_torch.core.flat_tree_device import (build_block_forests_device,
                                               build_cell_forests_device)
from repro_torch.core.landmark import lpt_assignment, select_centers
from repro_torch.core.metrics_host import get_host_metric
from repro_torch.data import synthetic_pointset
from repro_torch.nng import build_nng, delta_run

N, DIM, SEED = 203, 6, 13
K_CAP = 512                 # above every case's degree: no grow
BATCH = 16                  # the delta case's inserted points


def points(metric="euclidean"):
    if metric == "hamming":
        return synthetic_pointset(N, 3, "hamming", seed=SEED)
    return synthetic_pointset(N, DIM, seed=SEED)


def quantile_eps(metric, q=0.08):
    """An eps near the ``q`` quantile of the pair distances: for Hamming
    that distance (an integer), else the middle of the widest gap between
    distances near it."""
    pts = points(metric)
    hm = get_host_metric(metric)
    d = np.asarray(hm.true(hm.cdist(pts, pts)), np.float64)
    d = np.sort(d[np.triu_indices(len(pts), 1)])
    k = int(q * len(d))
    if metric == "hamming":
        return float(d[k])
    j = k - 50 + int(np.argmax(d[k - 49:k + 51] - d[k - 50:k + 50]))
    return 0.5 * float(d[j] + d[j + 1])


def _nbytes(payload) -> int:
    parts = payload if isinstance(payload, tuple) else (payload,)
    return sum(t.numel() * t.element_size() for t in parts)


@contextlib.contextmanager
def count_bytes():
    """Count the bytes of every rank-to-rank move, per channel, in-process
    moves included, as ``RunStats.comm_bytes`` models them: a permute's
    payload per (src, dst) pair, an all-gather's rows once, an all-to-all's
    send buffers, a broadcast once per receiving rank. Counts this
    process's ranks' sends; the flags and counters of the control channel
    are not modelled, and a move under no channel counts under None."""
    tally = {}
    orig = {k: getattr(comm, k) for k in ("permute", "all_gather",
                                          "all_to_all", "broadcast")}

    def add(channel, nbytes):
        if channel != comm.CONTROL:
            tally[channel] = tally.get(channel, 0) + nbytes

    def permute(mesh, blocks, perm, *, channel=None):
        for src, _ in perm:
            if mesh.owner(src) == mesh.rank:
                add(channel, _nbytes(blocks[src]))
        return orig["permute"](mesh, blocks, perm, channel=channel)

    def all_gather(mesh, local, *, channel=None):
        add(channel, _nbytes(local))
        return orig["all_gather"](mesh, local, channel=channel)

    def all_to_all(mesh, sends, *, channel=None):
        for s in mesh.local_ranks:
            add(channel, _nbytes(sends[s]))
        return orig["all_to_all"](mesh, sends, channel=channel)

    def broadcast(mesh, payload, *, channel=None):
        if mesh.rank == mesh.owner(0):
            add(channel, (mesh.size - 1) * _nbytes(payload))
        return orig["broadcast"](mesh, payload, channel=channel)

    for k, fn in (("permute", permute), ("all_gather", all_gather),
                  ("all_to_all", all_to_all), ("broadcast", broadcast)):
        setattr(comm, k, fn)
    try:
        yield tally
    finally:
        for k, fn in orig.items():
            setattr(comm, k, fn)


def _graph_result(g, tally):
    st = g.stats
    return {
        "row_ptr": g.row_ptr, "col_ids": g.col_ids,
        "edge_sha": hashlib.sha256(g.edge_key().tobytes()).hexdigest(),
        "counters": {k: getattr(st, k) for k in (
            "tiles_scheduled", "tiles_skipped", "dists_evaluated",
            "nodes_pruned", "replans")},
        "comm_bytes": st.comm_bytes, "meta": g.meta, "tally": tally,
    }


def _build(mesh, eps, **kw):
    metric = kw.get("metric", "euclidean")
    mesh.stats.reset()
    with count_bytes() as tally:
        g = build_nng(points(metric), eps, mesh=mesh, **kw)
    return dict(_graph_result(g, tally), moved=dict(mesh.stats.moved))


def _delta(mesh, eps):
    """One batch of BATCH points near the first 200 points against the
    block forests of those 200 (built on the mesh: on a process mesh each
    process builds its own ranks')."""
    pts = points()
    corpus = pts[:200]
    rng = np.random.default_rng(5)
    batch = (corpus[rng.choice(200, BATCH, replace=False)]
             + rng.normal(scale=0.05, size=(BATCH, DIM))).astype(np.float32)
    ids = np.arange(200, 200 + BATCH)
    tabs = build_block_forests(corpus, mesh.size, "euclidean",
                               backend="device", device="cpu", mesh=mesh)
    mesh.stats.reset()
    with count_bytes() as tally:
        src, dst, st = delta_run(batch, ids, tabs, eps, mesh, k_cap=256)
    return {"pairs": sorted(zip(src.tolist(), dst.tolist())),
            "counters": {"dists_evaluated": st.dists_evaluated,
                         "nodes_pruned": st.nodes_pruned,
                         "replans": st.replans},
            "comm_bytes": st.comm_bytes, "tally": tally,
            "moved": dict(mesh.stats.moved)}


def _forests(mesh, eps):
    """Each process's forests built on its own ranks against its rows of
    the forests of every rank built in one process, table by table:
    True where bit for bit equal."""
    nranks = mesh.size
    x = torch.from_numpy(np.resize(points(), (N + (-N) % nranks, DIM)))
    loc = mesh.local_ranks
    out = {}
    full = build_block_forests_device(x, nranks, device="cpu",
                                      include_child_ranges=True)
    mine = build_block_forests_device(x, nranks, device="cpu",
                                      include_child_ranges=True, mesh=mesh)
    out.update({f"block {k}": torch.equal(mine[k], v[loc.start:loc.stop])
                for k, v in full.items()})
    centers = x.numpy()[select_centers(len(x), 32,
                                       np.random.default_rng(0))]
    hm = get_host_metric("euclidean")
    cell = np.argmin(hm.cdist(x.numpy(), centers), axis=1)
    f = lpt_assignment(np.bincount(cell, minlength=32), nranks)
    full = build_cell_forests_device(x, cell, f, nranks, device="cpu",
                                     include_child_ranges=True)
    mine = build_cell_forests_device(x, cell, f, nranks, device="cpu",
                                     include_child_ranges=True, mesh=mesh)
    out.update({f"cell {k}": torch.equal(mine[k], v[loc.start:loc.stop])
                for k, v in full.items()})
    return out


def _cli(mesh, eps):
    from repro_torch.launch.nng_run import main

    def run(*extra):
        g = main(["--n", "256", "--dim", "6", "--eps", "1.5", "--device",
                  "cpu", "--ranks", str(mesh.size), "--verify", *extra])
        return {"edge_sha": hashlib.sha256(
                    g.edge_key().tobytes()).hexdigest(),
                "counters": {k: getattr(g.stats, k) for k in (
                    "tiles_skipped", "dists_evaluated")},
                "comm_bytes": g.stats.comm_bytes}
    return dict(run("--algo", "systolic"),
                updates=run("--algo", "landmark", "--updates", "3",
                            "--update-batch", "24"))


ON_N0 = 180                 # the online cases' initial corpus
ON_B = 5                    # points an insert or delete
ON_OPS = 6                  # operations, every third a delete
# online case -> (insert backend, partition, metric)
ONLINE = {"online": ("host", "point", "euclidean"),
          "online-spatial": ("device", "spatial", "euclidean"),
          "online-hamming": ("device", "point", "hamming")}


def _sha(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _online(mesh, eps, name):
    """``OnlineNNG`` on the first ON_N0 points, then ON_OPS operations of
    ON_B points (inserts of the next points, every third operation a
    delete of random live ids): after the build and after every
    operation, the state every process must share (edge keys, the delta
    log, the new ids, ``live``, counters, ``comm_bytes``, ``meta``), and
    the bytes this process's ranks moved per channel in that step."""
    from repro_torch.stream import OnlineNNG
    backend, partition, metric = ONLINE[name]
    pts = points(metric)
    rng = np.random.default_rng(7)
    mesh.stats.reset()
    o = OnlineNNG(pts[:ON_N0], eps, metric=metric, partition=partition,
                  mesh=mesh, k_cap=K_CAP, insert_backend=backend,
                  device="cpu")
    steps, moved, cursor = [], [], ON_N0

    def record(kind, ids):
        g, st = o.graph, o.stats
        delta = o.last_update_stats if kind == "insert" else None
        steps.append({
            "kind": kind, "ids": ids.tolist(),
            "edges": _sha(g.edge_key()),
            "log": _sha(g.row_ptr, g.col_ids, g._add_lo, g._add_hi,
                        g._dead),
            "live": _sha(o.live), "num_live": o.num_live,
            "counters": {k: getattr(st, k) for k in (
                "tiles_scheduled", "tiles_skipped", "dists_evaluated",
                "nodes_pruned", "replans", "edges_added", "edges_removed")},
            "comm_bytes": dict(st.comm_bytes),
            "delta": None if delta is None else {
                "dists_evaluated": delta.dists_evaluated,
                "nodes_pruned": delta.nodes_pruned,
                "replans": delta.replans,
                "comm_bytes": dict(delta.comm_bytes)},
            "meta": {k: v for k, v in g.meta.items()},
            # a rank's table sizes (the leading axis holds the local ranks)
            "tables": {k: tuple(v.shape[1:])
                       for k, v in o._stacked.items()}})
        moved.append(dict(mesh.stats.moved))
        mesh.stats.reset()

    record("build", np.zeros(0, np.int64))
    for step in range(ON_OPS):
        if step % 3 == 2:
            ids = np.sort(rng.choice(np.flatnonzero(o.live), ON_B,
                                     replace=False))
            o.delete(ids)
            record("delete", ids)
        else:
            ids = o.insert(pts[cursor:cursor + ON_B])
            cursor += ON_B
            record("insert", ids)
    return {"steps": steps, "moved": moved}


def run_case(mesh, name, eps):
    """Case ``name`` on ``mesh`` at ``eps`` -> its result dict."""
    build = {
        "tiles": dict(),
        "tiles-serial": dict(overlap=False),
        "tree-split": dict(traversal="tree"),
        "tree-serial": dict(traversal="tree", overlap=False),
        "coll": dict(partition="spatial"),
        "ring": dict(partition="spatial", ghost_mode="ring"),
        "spatial-tree": dict(partition="spatial", traversal="tree"),
        "l1": dict(metric="manhattan"),
        "hamming": dict(metric="hamming"),
    }
    if name in build:
        return _build(mesh, eps, k_cap=K_CAP, **build[name])
    if name == "tiles-grow":      # k_cap 4: the overflow flags grow it
        return _build(mesh, eps, k_cap=4)
    if name == "default":         # mesh=None: the world, or one rank
        with count_bytes() as tally:
            g = build_nng(points(), eps, device="cpu", k_cap=K_CAP)
        return _graph_result(g, tally)
    if name in ONLINE:
        return _online(mesh, eps, name)
    return {"delta": _delta, "forests": _forests, "cli": _cli}[name](mesh,
                                                                      eps)


def run_cases(nranks, cases):
    """A spawned process's side: every (name, eps) of ``cases`` on
    ``make_nng_mesh(nranks, "cpu")``, and the default mesh's shape."""
    mesh = make_nng_mesh(nranks, "cpu")
    default = make_nng_mesh(device="cpu")
    return {"mesh": (mesh.size, mesh.world, mesh.rank,
                     tuple(mesh.local_ranks), str(mesh.device)),
            "default_mesh": (default.size, default.world),
            "staging_s": mesh.stats.staging_s,
            "cases": {name: run_case(mesh, name, eps)
                      for name, eps in cases}}


def logical_case(nranks, name, eps):
    """The same case on ``nranks`` ranks in this process."""
    return run_case(RingMesh(nranks, torch.device("cpu")), name, eps)


def fails_on_rank_one():
    """Rank 1 raises while rank 0 waits for it in a collective."""
    if torch.distributed.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    torch.distributed.barrier()


def sleeps(seconds):
    import time
    time.sleep(seconds)
