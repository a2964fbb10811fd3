"""The benchmark's inputs: a configuration's point set and each call's row
order, made from seeds.

``synthetic_pointset`` is a frozen copy of the port's generator of the same
name (``repro_torch.data.pointsets``), so that a change there cannot move
the benchmark's data. The random draws are NumPy's, as there, so seed 0 gives
the clusters, assignments and noise that every earlier measurement of the
port used. The one product, the cloud's projection into ``dim``, runs in
float64 on the device and is rounded once to float32: it does not depend on
a BLAS's summation order, and it is fast on the card. It can differ from the
port's copy in the last bit of a coordinate.

The configuration fixes the point set (its generator seed); ``--seed`` fixes
the row permutation of every call, so every seed does the same work in
another order. The spatial partition draws its Voronoi centres by row index
(``select_centers``: ``m_centers`` rows drawn with ``default_rng(seed)``,
the traffic's ``seed``, 0 by default), so a spatial cell's permutations keep
those rows in place (``held_rows``): every call plans the same cells, the
same capacities and the same ghost copies, and only the order of the rows
within them changes.
"""
from __future__ import annotations

import numpy as np
import torch


def synthetic_pointset(n: int, dim: int, metric: str = "euclidean",
                       seed: int = 0, n_clusters: int | None = None,
                       cluster_std: float = 0.3,
                       intrinsic_dim: int | None = None,
                       device="cpu") -> torch.Tensor:
    """A clustered cloud of low intrinsic dimension on ``device``: float32
    (n, dim), or for ``metric == "hamming"`` (n, dim) packed 32-bit words as
    int32 (cluster centres of random bits, each point its centre with 3% of
    its bits flipped)."""
    rng = np.random.default_rng(seed)
    n_clusters = n_clusters or max(8, int(np.sqrt(n) / 4))
    if metric == "hamming":
        ctrs = rng.integers(0, 2**32, size=(n_clusters, dim), dtype=np.uint32)
        assign = rng.integers(0, n_clusters, n)
        pts = ctrs[assign].copy()
        for _ in range(max(1, int(dim * 32 * 0.03))):
            word = rng.integers(0, dim, n)
            bit = rng.integers(0, 32, n).astype(np.uint32)
            pts[np.arange(n), word] ^= np.uint32(1) << bit
        return torch.from_numpy(pts.view(np.int32)).to(device)
    idim = intrinsic_dim or max(2, dim // 8)
    basis = rng.normal(size=(idim, dim)).astype(np.float32)
    ctrs = rng.normal(size=(n_clusters, idim)).astype(np.float32) * 6.0
    assign = rng.integers(0, n_clusters, n)
    low = (ctrs[assign]
           + rng.normal(size=(n, idim)).astype(np.float32) * cluster_std)
    low = torch.from_numpy(low).to(device, torch.float64)
    out = low @ torch.from_numpy(basis).to(device, torch.float64)
    return (out / np.sqrt(idim)).to(torch.float32)


def make_points(config: dict, device) -> torch.Tensor:
    """The configuration's point set, from its ``generator`` entry."""
    gen = dict(config["generator"])
    name = gen.pop("name")
    if name != "synthetic_pointset":
        raise ValueError(f"unknown generator {name!r}")
    return synthetic_pointset(config["n"], config["dim"], config["metric"],
                              device=device, **gen)


def call_seed(seed: int, call: int) -> int:
    """A 63-bit seed for call ``call`` of a run with ``seed`` (any whole
    number; call -1 is set-up's warm call)."""
    return int(np.random.SeedSequence([int(seed) % 2**64, call + 1])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))


def held_rows(config: dict, traffic: dict) -> np.ndarray | None:
    """The rows that a spatial cell's permutations keep in place: the
    indices at which ``build_nng`` draws its centres (a frozen copy of
    ``select_centers``' random strategy and of its default count,
    max(2 * nranks, 32)); None for any other partition."""
    if traffic.get("partition") != "spatial":
        return None
    n = config["n"]
    m = traffic.get("m_centers") or max(2 * config["nranks"], 32)
    return np.random.default_rng(traffic.get("seed", 0)).choice(
        n, size=min(m, n), replace=False)


def call_perm(n: int, seed: int, call: int, device,
              hold: np.ndarray | None = None) -> torch.Tensor:
    """The row permutation of call ``call``, made on ``device``; the rows
    ``hold`` stay in place."""
    gen = torch.Generator(device=device).manual_seed(call_seed(seed, call))
    if hold is None:
        return torch.randperm(n, generator=gen, device=device)
    free = torch.ones(n, dtype=torch.bool, device=device)
    free[torch.as_tensor(hold, device=device)] = False
    free = free.nonzero().squeeze(1)
    perm = torch.arange(n, device=device)
    perm[free] = free[torch.randperm(len(free), generator=gen,
                                     device=device)]
    return perm


def sample_rows(n: int, k: int, seed: int, call: int) -> np.ndarray:
    """``k`` distinct rows of call ``call`` to check, drawn from the seed."""
    rng = np.random.default_rng([int(seed) % 2**64, call + 1, 7])
    return np.sort(rng.choice(n, size=min(k, n), replace=False))
