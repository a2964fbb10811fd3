"""Kernel contract registry and checker (RA001–RA004, with RA101, RA103
and RA104 from ``lints``).

A ``KernelContract`` is the promise one of the port's 17 CUDA kernels
makes to the rest of the system: its wrapper (``*_cuda``), the plain
PyTorch version that defines its function (the oracle), small probe
inputs, the dtypes it returns (int32 ids and counts, packed words as int32
tensors holding the uint32 bit pattern, fp32 distances), the canonical
threshold its wrapper must pass the C entry point (``eps2_f32(eps)`` for
L2, fp32 eps for L1, ``eps_int(eps)`` for Hamming) and the padding
invariants its launch needs (columns in whole 32-bit words, the tile
geometry). ``check_contract(c, device)`` verifies what it can:

- RA003  the declared invariants (``value % multiple == 0``);
- RA004  no oracle;
- RA001  the probe, the oracle or (on the card) the kernel raises at the
         probe shapes;
- RA002  the oracle's outputs break the dtype policy; on the card also
         the kernel's, and the kernel's outputs differ from the oracle's
         (bit for bit: the probes are gap-safe, every threshold decision
         far from its knife edge; ``pairwise_sqdist`` within its
         summation-order bound);
- RA101, RA103, RA104 (``lints``): the threshold the wrapper passes, host
         reads in the wrapper, float64 in the wrapper or the oracle.

On the CPU the kernels cannot run; the wrappers still run on the fake
card (``lints.fake_card``), so RA101 and RA103 check all 17 anywhere.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

from .diagnostics import Diagnostic
from .lints import analysis_device, lint_f64, lint_host_sync, lint_threshold

__all__ = ["KernelContract", "check_contract", "check_all",
           "compare_outputs", "default_contracts", "PROBE"]

U32 = 2.0 ** -24          # fp32 unit roundoff


@dataclass(frozen=True)
class KernelContract:
    """The contract of one CUDA kernel.

    ``probe(device)`` returns the positional arguments that both
    ``kernel`` (the CUDA wrapper) and ``oracle`` (its plain version) take,
    tensors on ``device``; ``eps_arg`` is the position of eps among them
    (None for a kernel without a threshold). The wrapper launches the C
    entry point of library ``entry`` and passes its thresholds at the
    positions ``threshold_args`` of that call, which must equal
    ``canonical(eps)`` bit for bit. ``tolerance(args, got, want)``, where
    given, replaces bit-for-bit equality of float outputs on the card."""

    name: str
    kernel: Callable | None
    oracle: Callable | None
    probe: Callable[[torch.device], tuple]
    entry: str | None = None
    eps_arg: int | None = None
    canonical: Callable[[float], tuple] | None = None
    threshold_args: tuple = ()
    ra101_eps: float = 0.1
    # (value, multiple, label) padding / tiling invariants
    shape_invariants: tuple = ()
    # output dtypes, in output order
    out_dtypes: tuple = ()
    tolerance: Callable | None = None


def _outputs(out) -> tuple:
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _policy(c: KernelContract, outs: tuple, who: str) -> list[Diagnostic]:
    if not c.out_dtypes:
        return []
    if len(outs) != len(c.out_dtypes):
        return [Diagnostic(
            "RA002", c.name,
            f"{who} returns {len(outs)} outputs, the contract declares "
            f"{len(c.out_dtypes)} dtypes")]
    return [Diagnostic(
        "RA002", c.name,
        f"{who} output #{i} dtype {t.dtype} violates the declared policy "
        f"{want}")
        for i, (t, want) in enumerate(zip(outs, c.out_dtypes))
        if not isinstance(t, torch.Tensor) or t.dtype != want]


def check_contract(c: KernelContract, device="cuda") -> list[Diagnostic]:
    """The contract's diagnostics on ``device``: "cpu" checks the oracle
    (and the wrapper on the fake card), "cuda" also launches the kernel
    and holds its outputs to the oracle's."""
    device = analysis_device(device)
    diags: list[Diagnostic] = []
    for value, multiple, label in c.shape_invariants:
        if int(value) % int(multiple) != 0:
            diags.append(Diagnostic(
                "RA003", c.name,
                f"invariant '{label}' violated: {value} % {multiple} = "
                f"{int(value) % int(multiple)}"))
    if c.oracle is None:
        diags.append(Diagnostic(
            "RA004", c.name,
            "contract declares no plain PyTorch oracle: the kernel's "
            "function is unverifiable"))
    try:
        args = c.probe(device)
    except Exception as e:  # noqa: BLE001 — any probe failure is the finding
        return diags + [Diagnostic(
            "RA001", c.name, f"probe failed: {type(e).__name__}: {e}")]
    want = None
    if c.oracle is not None:
        try:
            want = _outputs(c.oracle(*args))
        except Exception as e:  # noqa: BLE001
            diags.append(Diagnostic(
                "RA001", c.name,
                f"oracle raised at the probe shapes: {type(e).__name__}: "
                f"{e}"))
        else:
            diags += _policy(c, want, "oracle")
    if device.type == "cuda" and c.kernel is not None:
        try:
            got = _outputs(c.kernel(*args))
            torch.cuda.synchronize(device)
        except Exception as e:  # noqa: BLE001
            diags.append(Diagnostic(
                "RA001", c.name,
                f"kernel raised at the probe shapes: {type(e).__name__}: "
                f"{e}"))
        else:
            diags += _policy(c, got, "kernel")
            if want is not None:
                diags += compare_outputs(c, args, got, want)
    diags += lint_threshold(c)
    diags += lint_host_sync(c)
    diags += lint_f64(c, device)
    return diags


def compare_outputs(c, args, got, want) -> list[Diagnostic]:
    """RA002 where the kernel's outputs ``got`` differ from the oracle's
    ``want`` on the probe ``args``: shapes and dtypes, then the values
    bit for bit (or within ``c.tolerance`` for float outputs)."""
    shapes = [(tuple(t.shape), t.dtype) for t in got]
    wshapes = [(tuple(t.shape), t.dtype) for t in want]
    if shapes != wshapes:
        return [Diagnostic("RA002", c.name,
                           f"kernel outputs {shapes} != oracle outputs "
                           f"{wshapes}")]
    out = []
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype.is_floating_point and c.tolerance is not None:
            ok = bool(c.tolerance(args, g, w))
        else:
            ok = torch.equal(g, w)
        if not ok:
            n = int((g != w).sum())
            out.append(Diagnostic(
                "RA002", c.name,
                f"kernel output #{i} differs from the oracle's in {n} "
                f"elements on the gap-safe probe inputs"))
    return out


def check_all(contracts: Sequence[KernelContract] | None = None,
              device="cuda") -> tuple[list[Diagnostic], list[KernelContract]]:
    device = analysis_device(device)
    cs = list(contracts) if contracts is not None else default_contracts()
    diags: list[Diagnostic] = []
    for c in cs:
        diags += check_contract(c, device)
    return diags, cs


# ---------------------------------------------------------------------------
# probe inputs
# ---------------------------------------------------------------------------

# rows (ragged), columns (whole words, as the plain versions need),
# features, Hamming words, ghost words; the frontiers' queries and nodes
PROBE = dict(q=70, p=96, d=20, w=3, mw=2, nq=40, n=64, k=40)
_SEED = 25


def _rng(salt: int):
    return np.random.default_rng(_SEED + salt)


def _floats(rng, n, d):
    return rng.normal(size=(n, d)).astype(np.float32)


def _words(rng, n, w):
    return rng.integers(0, 2**32, size=(n, w), dtype=np.uint64) \
        .astype(np.uint32).view(np.int32)


def _dist(x, y, metric):
    """float64 distances of the probe rows (L2, L1; Hamming exact)."""
    if metric == "hamming":
        a = np.unpackbits(x.view(np.uint8), axis=1).astype(np.int64)
        b = np.unpackbits(y.view(np.uint8), axis=1).astype(np.int64)
        return (a[:, None, :] != b[None, :, :]).sum(-1).astype(np.float64)
    diff = x.astype(np.float64)[:, None, :] - y.astype(np.float64)[None]
    if metric == "manhattan":
        return np.abs(diff).sum(-1)
    return np.sqrt((diff * diff).sum(-1))


def _gap_eps(values, lo_q=0.2, hi_q=0.6):
    """The middle of the widest gap between the sorted ``values`` that lie
    between their ``lo_q`` and ``hi_q`` quantiles, and the gap's half
    width."""
    v = np.unique(values)
    lo, hi = np.quantile(v, [lo_q, hi_q])
    v = v[(v >= lo) & (v <= hi)]
    j = int(np.argmax(np.diff(v)))
    return 0.5 * float(v[j] + v[j + 1]), 0.5 * float(v[j + 1] - v[j])


def _tile_eps(x, y, metric):
    """A gap-safe eps for a tile probe: no pair's distance near it."""
    if metric == "hamming":
        d = _dist(x.view(np.uint32), y.view(np.uint32), metric)
        return float(np.median(d)) + 0.5
    eps, half = _gap_eps(_dist(x, y, metric))
    _require(half > 1e-4 * eps, f"{metric} probe: no gap-safe eps")
    return eps


def _require(cond, msg):
    if not cond:
        raise ValueError(msg)


def _t(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _tile_operands(metric, salt):
    rng = _rng(salt)
    q, p, d, w = (PROBE[k] for k in "qpdw")
    if metric == "hamming":
        x, y = _words(rng, q, w), _words(rng, p, w)
    else:
        x, y = _floats(rng, q, d), _floats(rng, p, d)
    return rng, x, y, _tile_eps(x, y, metric)


def _tile_probe(metric):
    def probe(device):
        rng, x, y, eps = _tile_operands(metric, 1)
        valid = (rng.random(PROBE["p"]) < 0.9).astype(np.int32)
        return (_t(x, device), _t(y, device), _t(valid, device), eps)
    return probe


def _grouped_probe(metric):
    def probe(device):
        rng, x, y, eps = _tile_operands(metric, 2)
        q, p = PROBE["q"], PROBE["p"]
        xg = rng.integers(-1, 3, q).astype(np.int32)
        yg = rng.integers(-1, 3, p).astype(np.int32)
        xid = np.arange(q, dtype=np.int32)
        yid = np.arange(p, dtype=np.int32) + 20   # ids 20..69 shared
        return tuple(_t(a, device) for a in (x, y, xg, yg, xid, yid)) + (eps,)
    return probe


def _ghost_probe(metric):
    def probe(device):
        rng, x, y, eps = _tile_operands(metric, 3)
        q, p, mw = PROBE["q"], PROBE["p"], PROBE["mw"]
        gbits = _words(rng, q, mw)
        yg = rng.integers(-1, 32 * mw, p).astype(np.int32)
        return tuple(_t(a, device) for a in (x, y, gbits, yg)) + (eps,)
    return probe


def _frontier_probe(metric):
    """Queries against one level of nodes: a third of them internal with
    radius R, the rest leaves, about half the (query, node) pairs active.
    eps and R put every decision (d against eps, d + R against eps less
    the slack, d - R against eps plus it) far from its threshold."""
    def probe(device):
        rng = _rng(4)
        nq, n, d, w = PROBE["nq"], PROBE["n"], PROBE["d"], PROBE["w"]
        if metric == "hamming":
            qp, c = _words(rng, nq, w), _words(rng, n, w)
        else:
            qp, c = _floats(rng, nq, d), _floats(rng, n, d)
        dist = _dist(qp.view(np.uint32) if metric == "hamming" else qp,
                     c.view(np.uint32) if metric == "hamming" else c,
                     metric)
        leaf = (rng.random(n) < 2 / 3).astype(np.int32)
        if metric == "hamming":
            eps = float(np.median(dist)) + 0.5
            rad = np.where(leaf == 0, 3.0, 0.0).astype(np.float32)
        else:
            R = float(np.float32(0.25 * np.median(dist)))
            rad = np.where(leaf == 0, R, 0.0).astype(np.float32)
            inner = dist[:, leaf == 0]
            vals = np.concatenate([dist[:, leaf != 0].ravel(),
                                   (inner + R).ravel(), (inner - R).ravel()])
            eps, half = _gap_eps(vals)
            slack = (2 * eps + 2 * R) * 1e-5 + 1e-6
            _require(half > 4 * slack, f"{metric} frontier probe: no "
                                       f"gap-safe eps")
        act = (rng.random((nq, n)) < 0.5)
        act_w = np.packbits(act, axis=1, bitorder="little").view(np.int32)
        return (_t(qp, device), _t(c, device), _t(rad, device),
                _t(leaf, device), _t(act_w, device), eps)
    return probe


def _bits_probe(device):
    rng = _rng(5)
    q, w = PROBE["q"], PROBE["w"]
    dens = rng.random((q, 1))
    hit = rng.random((q, 32 * w)) < dens
    words = np.packbits(hit, axis=1, bitorder="little").view(np.int32)
    return (_t(words, device), PROBE["k"])


def _pack_probe(device):
    """±1 leaf-range deltas of a few ranges a row, leaf ids with padding,
    query ids that meet their own leaf (self pairs)."""
    from repro_torch.kernels.bits_epilogue import SENTINEL
    rng = _rng(6)
    nq, nl = PROBE["q"], PROBE["p"]
    delta = np.zeros((nq, nl), np.int32)
    for i in range(nq):
        for _ in range(rng.integers(0, 4)):
            lo, hi = sorted(rng.integers(0, nl, 2))
            delta[i, lo] += 1
            if hi > lo:
                delta[i, hi] -= 1
    leaf_ids = rng.permutation(1000)[:nl].astype(np.int32)
    leaf_ids[rng.random(nl) < 0.1] = SENTINEL
    qids = leaf_ids[rng.integers(0, nl, nq)].copy()
    qids[::3] = 2000 + np.arange(len(qids[::3]))
    return tuple(_t(a, device) for a in (delta, leaf_ids, qids))


def _dense_probe(metric, with_eps=False):
    def probe(device):
        rng, x, y, eps = _tile_operands(metric, 7)
        args = (_t(x, device), _t(y, device))
        return args + (eps,) if with_eps else args
    return probe


def _sqdist_tolerance(args, got, want):
    """Two fp32 evaluations of (‖x‖² + ‖y‖²) − 2x·y in different orders
    differ by at most 2·(d + 2)·u·(‖x‖² + ‖y‖²)."""
    x, y = args[0], args[1]
    scale = (x * x).sum(1)[:, None] + (y * y).sum(1)[None, :]
    return bool(((got - want).abs()
                 <= 2 * (x.shape[1] + 2) * U32 * scale).all())


# ---------------------------------------------------------------------------
# the registry: every CUDA kernel of repro_torch.kernels
# ---------------------------------------------------------------------------

def default_contracts() -> list[KernelContract]:
    import importlib

    from repro_torch.kernels.nng_tile import PIPE_TILE, eps2_f32, eps_int
    from repro_torch.kernels.tree_frontier import TN
    # importlib, not ``from repro_torch.kernels import ...``: the package
    # re-exports ops functions named ``eps_count`` and ``pairwise_hamming``
    # that shadow the submodules
    be = importlib.import_module("repro_torch.kernels.bits_epilogue")
    ec = importlib.import_module("repro_torch.kernels.eps_count")
    nt = importlib.import_module("repro_torch.kernels.nng_tile")
    ph = importlib.import_module("repro_torch.kernels.pairwise_hamming")
    pl = importlib.import_module("repro_torch.kernels.pairwise_l2")
    ref = importlib.import_module("repro_torch.kernels.ref")
    tf = importlib.import_module("repro_torch.kernels.tree_frontier")

    i32, f32 = torch.int32, torch.float32

    def l2(eps):
        return (eps2_f32(eps),)

    def l1(eps):
        return (float(np.float32(eps)),)

    def ham(eps):
        return (eps_int(eps),)

    def front_l2(eps):
        return (float(np.float32(eps)), eps2_f32(eps))

    p = PROBE["p"]
    words = (p, 32, "p % 32: the plain version packs whole words")
    pipe = (PIPE_TILE[1], 32, "the pipelined tile's columns % 32")
    nodes = (PROBE["n"], 32, "N % 32: the plain version packs whole words")
    blocks = (TN, 32, "the frontier block's nodes % 32")
    tile = dict(out_dtypes=(i32, i32))

    def tile_contract(name, metric, kind, thr, at, pipelined=False,
                      eps_arg=3, ham_eps=False):
        probe = {"tile": _tile_probe, "grouped": _grouped_probe,
                 "ghost": _ghost_probe}[kind](metric)
        return KernelContract(
            name=name, kernel=getattr(nt, f"{name}_cuda"),
            oracle=getattr(nt, f"{name}_ref"), probe=probe, entry=name,
            eps_arg=eps_arg, canonical=thr, threshold_args=at,
            ra101_eps=5.7 if ham_eps else 0.1,
            shape_invariants=(words,) + ((pipe,) if pipelined else ()),
            **tile)

    contracts = [
        tile_contract("nng_tile", "euclidean", "tile", l2, (-3,), True),
        tile_contract("nng_tile_hamming", "hamming", "tile", ham, (-2,),
                      ham_eps=True),
        tile_contract("nng_tile_l1", "manhattan", "tile", l1, (-2,)),
        tile_contract("nng_tile_grouped", "euclidean", "grouped", l2, (-3,),
                      True, eps_arg=6),
        tile_contract("nng_tile_grouped_hamming", "hamming", "grouped", ham,
                      (-2,), eps_arg=6, ham_eps=True),
        tile_contract("nng_tile_grouped_l1", "manhattan", "grouped", l1,
                      (-2,), eps_arg=6),
        tile_contract("nng_tile_ghost", "euclidean", "ghost", l2, (-3,),
                      True, eps_arg=4),
        tile_contract("nng_tile_ghost_hamming", "hamming", "ghost", ham,
                      (-2,), eps_arg=4, ham_eps=True),
        tile_contract("nng_tile_ghost_l1", "manhattan", "ghost", l1, (-3,),
                      True, eps_arg=4),
        KernelContract(
            name="bits_to_cols", kernel=be.bits_to_cols_cuda,
            oracle=be.bits_to_cols_ref, probe=_bits_probe,
            entry="bits_to_cols", out_dtypes=(i32,)),
        KernelContract(
            name="tree_frontier", kernel=tf.tree_frontier_cuda,
            oracle=tf.tree_frontier_ref, probe=_frontier_probe("euclidean"),
            entry="tree_frontier", eps_arg=5, canonical=front_l2,
            threshold_args=(-4, -3), shape_invariants=(nodes, pipe, blocks),
            **tile),
        KernelContract(
            name="tree_frontier_hamming", kernel=tf.tree_frontier_hamming_cuda,
            oracle=tf.tree_frontier_hamming_ref,
            probe=_frontier_probe("hamming"), entry="tree_frontier_hamming",
            eps_arg=5, canonical=ham, threshold_args=(-3,), ra101_eps=5.7,
            shape_invariants=(nodes, pipe, blocks), **tile),
        KernelContract(
            name="tree_frontier_l1", kernel=tf.tree_frontier_l1_cuda,
            oracle=tf.tree_frontier_l1_ref, probe=_frontier_probe("manhattan"),
            entry="tree_frontier_l1", eps_arg=5, canonical=l1,
            threshold_args=(-3,), shape_invariants=(nodes, pipe, blocks),
            **tile),
        KernelContract(
            name="leaf_range_pack", kernel=be.leaf_range_pack_cuda,
            oracle=be.leaf_range_pack_ref, probe=_pack_probe,
            entry="leaf_range_pack",
            shape_invariants=((p, 32, "NL % 32: leaf slots in whole "
                                      "words"),), **tile),
        KernelContract(
            name="pairwise_sqdist", kernel=pl.pairwise_sqdist_cuda,
            oracle=ref.pairwise_sqdist_blas3_ref,
            probe=_dense_probe("euclidean"), entry="pairwise_sqdist",
            shape_invariants=(pipe,), out_dtypes=(f32,),
            tolerance=_sqdist_tolerance),
        KernelContract(
            name="pairwise_hamming", kernel=ph.pairwise_hamming_cuda,
            oracle=ref.pairwise_hamming_ref, probe=_dense_probe("hamming"),
            entry="pairwise_hamming",
            shape_invariants=((nt.ROWS_PER_LAUNCH, 128, "rows a launch % "
                               "the 128-row block"),), out_dtypes=(i32,)),
        KernelContract(
            name="eps_count", kernel=ec.eps_count_cuda,
            oracle=ec.eps_count_plain,
            probe=_dense_probe("euclidean", with_eps=True),
            entry="eps_count", eps_arg=2, canonical=l2, threshold_args=(-3,),
            shape_invariants=(pipe,), out_dtypes=(i32,)),
    ]
    return contracts
