"""The port's C launch interface, checked on the CPU.

Each CUDA kernel is a plain-C entry point loaded with ``ctypes``; the
argtypes in ``kernels/_build._ENTRY`` are all that tells ``ctypes`` how to
pass each argument, and a row that disagrees with its C declaration passes
a pointer as a 32-bit int, or an argument in the wrong slot, without any
error. Two checks, neither of which needs a card or ``nvcc``:

  - every ``_ENTRY`` row against the declaration of its C entry point in
    ``csrc/<library>.cu``: the same parameters, in the same order, of the
    kinds ``ctypes`` is told (pointer, int, float, long long);
  - every CUDA wrapper against its ``_ENTRY`` row: with the tensors' device
    check, the stream and the build faked, each wrapper's call of its entry
    point passes one Python value of the right kind for each argtype (and
    the persistent kernels the device's SM count just before the stream).
"""
import ctypes
import importlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import bits_epilogue as tbe
from repro_torch.kernels import nng_tile as tnt
from repro_torch.kernels import pairwise_l2 as tpl
from repro_torch.kernels import tree_frontier as ttf

# the package re-exports functions under these two modules' names
tec = importlib.import_module("repro_torch.kernels.eps_count")
tph = importlib.import_module("repro_torch.kernels.pairwise_hamming")

# a C parameter's type -> the ctypes argtype that passes it
C_KIND = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
          "int": ctypes.c_int, "float": ctypes.c_float,
          "long long": ctypes.c_longlong}
SMS = 7           # the faked SM count


def c_params(lib: str, symbol: str) -> list:
    """The parameter types of ``extern "C" int symbol(...)`` in
    ``csrc/<lib>.cu``, without their names."""
    src = (_build.CSRC / f"{lib}.cu").read_text()
    m = re.search(r'extern\s+"C"\s+int\s+' + symbol + r"\s*\(([^)]*)\)", src)
    assert m, f"no extern \"C\" int {symbol}(...) in {lib}.cu"
    params = []
    for decl in m.group(1).split(","):
        words = decl.split()
        ty = " ".join(words[:-1])
        stars = words[-1].count("*")
        params.append((ty + "*" * stars).replace(" *", "*"))
    return params


@pytest.mark.parametrize("lib", sorted(_build._ENTRY))
def test_entry_argtypes_match_c_declaration(lib):
    symbol, argtypes = _build._ENTRY[lib]
    params = c_params(lib, symbol)
    assert len(params) == len(argtypes), (lib, params)
    for i, (ty, at) in enumerate(zip(params, argtypes)):
        assert ty in C_KIND, f"{lib}: parameter {i} has C type {ty!r}"
        assert C_KIND[ty] is at, (lib, i, ty, at)


@pytest.fixture
def fake_card(monkeypatch):
    """CPU tensors pass the wrappers' device checks, and every entry point
    is a recorder that checks its arguments against its ``_ENTRY`` row and
    returns 0. Yields the list of (library, args) calls."""
    calls = []

    def entry(lib):
        _, argtypes = _build._ENTRY[lib]

        def launch(*args):
            assert len(args) == len(argtypes), (lib, args)
            for i, (a, at) in enumerate(zip(args, argtypes)):
                kind = float if at is ctypes.c_float else int
                assert type(a) is kind, (lib, i, a, at)
            calls.append((lib, args))
            return 0
        return launch

    class Stream:
        cuda_stream = 12345

    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(torch.cuda, "device", lambda _d: _Null())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream())
    monkeypatch.setattr(_build, "entry", entry)
    monkeypatch.setattr(_build, "load", lambda: None)
    for mod in (tnt, tec, tpl, ttf):
        monkeypatch.setattr(mod, "sm_count", lambda _i: SMS)
    return calls


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _f32(*shape):
    return torch.from_numpy(np.random.default_rng(len(shape)).normal(
        size=shape).astype(np.float32))


def _i32(*shape):
    return torch.zeros(shape, dtype=torch.int32)


Q, P, D, W, N = 5, 70, 17, 3, 40
WRAPPERS = {
    "nng_tile": lambda: tnt.nng_tile_cuda(_f32(Q, D), _f32(P, D),
                                          _i32(P), 1.5),
    "nng_tile_hamming": lambda: tnt.nng_tile_hamming_cuda(
        _i32(Q, W), _i32(P, W), _i32(P), 4.0),
    "nng_tile_l1": lambda: tnt.nng_tile_l1_cuda(_f32(Q, D), _f32(P, D),
                                                _i32(P), 1.5),
    "nng_tile_grouped": lambda: tnt.nng_tile_grouped_cuda(
        _f32(Q, D), _f32(P, D), _i32(Q), _i32(P), _i32(Q), _i32(P), 1.5),
    "nng_tile_grouped_hamming": lambda: tnt.nng_tile_grouped_hamming_cuda(
        _i32(Q, W), _i32(P, W), _i32(Q), _i32(P), _i32(Q), _i32(P), 4.0),
    "nng_tile_grouped_l1": lambda: tnt.nng_tile_grouped_l1_cuda(
        _f32(Q, D), _f32(P, D), _i32(Q), _i32(P), _i32(Q), _i32(P), 1.5),
    "nng_tile_ghost": lambda: tnt.nng_tile_ghost_cuda(
        _f32(Q, D), _f32(P, D), _i32(Q, 2), _i32(P), 1.5),
    "nng_tile_ghost_hamming": lambda: tnt.nng_tile_ghost_hamming_cuda(
        _i32(Q, W), _i32(P, W), _i32(Q, 2), _i32(P), 4.0),
    "nng_tile_ghost_l1": lambda: tnt.nng_tile_ghost_l1_cuda(
        _f32(Q, D), _f32(P, D), _i32(Q, 2), _i32(P), 1.5),
    "bits_to_cols": lambda: tbe.bits_to_cols_cuda(_i32(Q, W), 4),
    "tree_frontier": lambda: ttf.tree_frontier_cuda(
        _f32(Q, D), _f32(N, D), _f32(N), _i32(N), _i32(Q, 2), 1.5),
    "tree_frontier_hamming": lambda: ttf.tree_frontier_hamming_cuda(
        _i32(Q, W), _i32(N, W), _f32(N), _i32(N), _i32(Q, 2), 4.0),
    "tree_frontier_l1": lambda: ttf.tree_frontier_l1_cuda(
        _f32(Q, D), _f32(N, D), _f32(N), _i32(N), _i32(Q, 2), 1.5),
    "leaf_range_pack": lambda: tbe.leaf_range_pack_cuda(
        _i32(Q, 33), _i32(32), _i32(Q)),
    "pairwise_sqdist": lambda: tpl.pairwise_sqdist_cuda(_f32(Q, D),
                                                        _f32(P, D)),
    "pairwise_hamming": lambda: tph.pairwise_hamming_cuda(_i32(Q, W),
                                                          _i32(P, W)),
    "eps_count": lambda: tec.eps_count_cuda(_f32(Q, D), _f32(P, D), 1.5),
}
PERSISTENT = {"nng_tile", "eps_count", "pairwise_sqdist", "nng_tile_ghost",
              "tree_frontier", "tree_frontier_l1"}


def test_every_entry_has_a_wrapper_case():
    assert set(WRAPPERS) == set(_build._ENTRY)


@pytest.mark.parametrize("lib", sorted(WRAPPERS))
def test_wrapper_passes_its_entry_argtypes(fake_card, lib):
    WRAPPERS[lib]()
    assert [c[0] for c in fake_card] == [lib]
    args = fake_card[0][1]
    assert args[-1] == 12345                      # the stream, last
    if lib in PERSISTENT:
        assert args[-2] == SMS                    # the SM count before it
    # the shape arguments: q (or nq / m) and the widths, as ints
    assert Q in args


@pytest.mark.parametrize("q,d", [(1, 17), (300, 17), (129, 128)])
def test_persistent_wrappers_launch_once_for_any_rows(fake_card, q, d):
    """nng_tile, eps_count and pairwise_sqdist launch one persistent grid
    for the whole of x (no row chunks) with x's own pointer, rows, width
    and the threshold eps2_f32(eps); the ghost kernel one grid over x
    gathered in its row order, with the order, the keys and the live-tile
    list of ``ghost_tile_plan``."""
    x, y = _f32(q + 1, d)[1:], _f32(P, d)
    tec.eps_count_cuda(x, y, 2.5)
    tnt.nng_tile_cuda(x, y, _i32(P), 2.5)
    tpl.pairwise_sqdist_cuda(x, y)
    gb = torch.from_numpy(np.random.default_rng(q).integers(
        0, 2**31, size=(q, 2)).astype(np.int32))
    yg = torch.arange(P, dtype=torch.int32) % 40 - 1
    tnt.nng_tile_ghost_cuda(x, y, gb, yg, 2.5)
    assert [c[0] for c in fake_card] == ["eps_count", "nng_tile",
                                         "pairwise_sqdist", "nng_tile_ghost"]
    (_, ea), (_, ta), (_, pa), (_, ga) = fake_card
    assert ea[:2] == (x.data_ptr(), y.data_ptr())
    assert ea[5:10] == (q, P, d, tnt.eps2_f32(2.5), SMS)
    assert ta[:2] == (x.data_ptr(), y.data_ptr())
    assert ta[7:12] == (q, P, d, tnt.eps2_f32(2.5), SMS)
    assert pa[:2] == (x.data_ptr(), y.data_ptr())
    assert pa[5:9] == (q, P, d, SMS)
    assert ga[1] == y.data_ptr() and ga[3] == yg.data_ptr()
    assert ga[11:17] == (q, P, d, 2, tnt.eps2_f32(2.5), SMS)


def test_frontier_wrappers_launch_once_with_plan_scratch(fake_card):
    """tree_frontier and tree_frontier_l1 make one call of their entry
    point (its plan pass and its walk) with q's, c's, rad's, leaf's and
    the active words' own pointers, emit and expand (the returned
    tensors), (nq, n, d), the thresholds and the SM count; the L2 one also
    norm scratch."""
    nq, n, d = 130, 300, 17
    q, c = _f32(nq + 1, d)[1:], _f32(n, d)
    rad, leaf = _f32(n), _i32(n)
    act = _i32(nq, 10)
    outs = [ttf.tree_frontier_cuda(q, c, rad, leaf, act, 2.5),
            ttf.tree_frontier_l1_cuda(q, c, rad, leaf, act, 2.5)]
    assert [c_[0] for c_ in fake_card] == ["tree_frontier",
                                           "tree_frontier_l1"]
    eps = float(np.float32(2.5))
    for (lib, args), (emit, expand) in zip(fake_card, outs):
        assert args[:5] == (q.data_ptr(), c.data_ptr(), rad.data_ptr(),
                            leaf.data_ptr(), act.data_ptr())
        assert args[7:9] == (emit.data_ptr(), expand.data_ptr())
        assert emit.shape == expand.shape == (nq, 10)
        assert len(set(args[5:9])) == 4        # the list, its count, outputs
    fa, la = fake_card[0][1], fake_card[1][1]
    assert fa[11:17] == (nq, n, d, eps, tnt.eps2_f32(2.5), SMS)
    assert la[9:13] == (nq, n, d, eps)
