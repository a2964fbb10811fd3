"""Lints of the kernel wrappers and the engines (RA101–RA104).

The reference lints walk traced jaxprs; an eager program has none, so the
port's lints watch the program run instead:

- ``fake_card`` lets a CUDA wrapper run on CPU tensors: the device checks
  pass, the stream and the SM count are stand-ins, and every C entry
  point is a recorder that returns 0 without launching. What a wrapper
  passes its entry point (RA101) and what it computes on the way (RA103,
  RA104) is then visible on any machine, with or without a card.
- ``OpRecorder`` is a ``TorchDispatchMode`` that records, for every
  operator that runs inside it, the host reads of tensor values (RA103),
  the float64 results (RA104) and the reductions to one int32 value
  (RA102); ``host_reads_of`` adds the tensor methods that read values
  without reaching the dispatcher (``.tolist()``, ``.cpu()``,
  ``.numpy()``).
"""
from __future__ import annotations

import contextlib
import ctypes
import importlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from .diagnostics import Diagnostic

__all__ = ["analysis_device", "fake_card", "entry_calls", "OpRecorder",
           "record_ops", "lint_threshold", "lint_host_sync", "lint_f64",
           "lint_int_reductions", "same_c_value"]


def analysis_device(device) -> torch.device:
    """Where the analyzer runs: ``"cuda"`` (every entry point's default)
    raises without a card, as the engines' defaults do; ``"cpu"`` checks
    the oracles, and the wrappers on the fake card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: the analyzer runs "
                           "the kernels on the card by default; pass "
                           "device='cpu' (--device cpu) to check the "
                           "oracles and wrappers without one")
    return device

# the wrapper modules whose persistent kernels read the SM count
_SM_MODULES = ("repro_torch.kernels.nng_tile", "repro_torch.kernels.eps_count",
               "repro_torch.kernels.pairwise_l2",
               "repro_torch.kernels.tree_frontier")
FAKE_SMS = 7
FAKE_STREAM = 12345


class _Stream:
    cuda_stream = FAKE_STREAM


@contextlib.contextmanager
def fake_card():
    """While the block runs, CPU tensors pass the wrappers' device checks,
    ``torch.cuda.device`` and ``current_stream`` are stand-ins, the kernel
    modules' ``sm_count`` is ``FAKE_SMS`` and every C entry point is a
    recorder: yields the list of (library, args) calls, in order. The
    kernels compute nothing: their outputs keep the wrapper's
    initialisation."""
    from repro_torch.kernels import _build
    calls = []

    def entry(lib):
        def launch(*args):
            calls.append((lib, args))
            return 0
        return launch

    saved = [(torch.Tensor, "is_cuda", torch.Tensor.is_cuda),
             (torch.cuda, "device", torch.cuda.device),
             (torch.cuda, "current_stream", torch.cuda.current_stream),
             (_build, "entry", _build.entry), (_build, "load", _build.load)]
    mods = [importlib.import_module(m) for m in _SM_MODULES]
    saved += [(m, "sm_count", m.sm_count) for m in mods]
    torch.Tensor.is_cuda = property(lambda t: True)
    torch.cuda.device = lambda _d: contextlib.nullcontext()
    torch.cuda.current_stream = lambda *a: _Stream()
    _build.entry = entry
    _build.load = lambda: None
    for m in mods:
        m.sm_count = lambda _i: FAKE_SMS
    try:
        yield calls
    finally:
        for obj, name, val in reversed(saved):
            setattr(obj, name, val)


def entry_calls(fn, *args):
    """(fn(*args) on the fake card, the (library, args) calls of its entry
    points)."""
    with fake_card() as calls:
        out = fn(*args)
    return out, calls


# operators that read a tensor's values on the host (a wait for the card
# when the tensor is on it), by overload packet name
_HOST_READ_OPS = {"_local_scalar_dense", "nonzero", "masked_select",
                  "_unique2", "unique_dim", "unique_consecutive", "equal",
                  "is_nonzero"}
# reductions whose single int32 result can wrap at paper scale
_REDUCTIONS = {"sum", "prod", "count_nonzero", "nansum"}
_NARROW_INTS = (torch.int32, torch.int16, torch.int8, torch.uint8)
_WIDE_FLOATS = (torch.float64, torch.complex128)
# tensor methods that read values without reaching the dispatcher
_HOST_READ_METHODS = ("tolist", "cpu", "numpy", "item")


class OpRecorder(TorchDispatchMode):
    """Records, for the operators that run inside it: ``host_reads`` (an
    operator that reads values on the host: ``.item()`` and ``bool()`` /
    ``int()`` of a tensor (``_local_scalar_dense``), ``nonzero``, a boolean
    index, ``repeat_interleave`` without ``output_size``, ``unique``),
    ``f64`` (float64 results) and ``int_reductions`` (a sum or product to
    one int32-or-narrower value). Each entry names the operator."""

    def __init__(self):
        super().__init__()
        self.host_reads, self.f64, self.int_reductions = [], [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if name in _HOST_READ_OPS or (
                name == "index" and any(
                    isinstance(t, torch.Tensor) and t.dtype == torch.bool
                    for t in tree_flatten(args[1:])[0])) or (
                name == "repeat_interleave"
                and kwargs.get("output_size") is None
                and not isinstance(args[1] if len(args) > 1 else None, int)):
            self.host_reads.append(str(func))
        leaves = out if isinstance(out, (tuple, list)) else (out,)
        for t in leaves:
            if isinstance(t, torch.Tensor) and t.dtype in _WIDE_FLOATS:
                self.f64.append(str(func))
                break
        if (name in _REDUCTIONS and isinstance(out, torch.Tensor)
                and out.dim() == 0 and out.dtype in _NARROW_INTS):
            self.int_reductions.append(str(func))
        return out


@contextlib.contextmanager
def host_reads_of(recorder: OpRecorder):
    """While the block runs, calls of ``.tolist()``, ``.cpu()``,
    ``.numpy()`` and ``.item()`` on any tensor add to
    ``recorder.host_reads``."""
    saved = {m: getattr(torch.Tensor, m) for m in _HOST_READ_METHODS}

    def spy(m):
        orig = saved[m]

        def method(self, *a, **kw):
            recorder.host_reads.append(f"Tensor.{m}")
            return orig(self, *a, **kw)
        return method

    for m in _HOST_READ_METHODS:
        setattr(torch.Tensor, m, spy(m))
    try:
        yield recorder
    finally:
        for m, orig in saved.items():
            setattr(torch.Tensor, m, orig)


def record_ops(fn, *args, methods: bool = False, **kwargs):
    """(fn(*args, **kwargs), its ``OpRecorder``); with ``methods`` the
    host-reading tensor methods are recorded too."""
    rec = OpRecorder()
    with contextlib.ExitStack() as stack:
        if methods:
            stack.enter_context(host_reads_of(rec))
        stack.enter_context(rec)
        out = fn(*args, **kwargs)
    return out, rec


# ---------------------------------------------------------------------------
# RA101 — the canonical threshold
# ---------------------------------------------------------------------------

def same_c_value(got, want) -> bool:
    """Whether ``got``, passed where the C entry point takes ``want``'s
    kind (a C float for a Python float, a C int for an int), reaches it as
    the same bits: floats are compared after ctypes' rounding to fp32."""
    if isinstance(want, float):
        return (isinstance(got, float)
                and ctypes.c_float(got).value == ctypes.c_float(want).value)
    return type(got) is int and got == want


def lint_threshold(c, eps: float | None = None) -> list[Diagnostic]:
    """RA101 — the port's form of the ``float(eps) ** 2`` check: run the
    contract's CUDA wrapper on its probe inputs on the fake card, with eps
    set to ``eps`` (default the contract's ``ra101_eps``), and hold every
    threshold it passes its C entry point (the arguments at
    ``c.threshold_args``) to ``c.canonical(eps)`` bit for bit. A wrapper
    that never calls its entry point is flagged too, and one of a kernel
    without a threshold (``c.canonical`` None) that passes a C float.
    A contract without a C entry point (``c.entry`` None) has nothing to
    check."""
    if c.kernel is None or c.entry is None:
        return []
    args = list(c.probe(torch.device("cpu")))
    if c.canonical is not None:
        eps = c.ra101_eps if eps is None else eps
        args[c.eps_arg] = eps
    _, calls = entry_calls(c.kernel, *args)
    mine = [a for lib, a in calls if lib == c.entry]
    if not mine:
        return [Diagnostic(
            "RA101", c.name,
            f"the wrapper never called its entry point {c.entry!r}"
            + ("" if c.canonical is None else
               f": the canonical threshold {c.canonical(eps)!r} was not "
               f"passed"))]
    if c.canonical is None:
        return [Diagnostic(
            "RA101", c.name,
            f"the kernel declares no threshold, yet its wrapper passes "
            f"{c.entry} the float {v!r}")
            for a in mine for v in a if isinstance(v, float)]
    want = tuple(c.canonical(eps))
    diags = []
    for a in mine:
        got = tuple(a[i] for i in c.threshold_args)
        for g, w in zip(got, want):
            if same_c_value(g, w):
                continue
            rel = (abs(float(g) - float(w)) / max(abs(float(w)), 1e-30)
                   if isinstance(g, (int, float)) else float("inf"))
            near = " — a near miss: a Python-float (f64) fold cast to " \
                   "fp32" if rel <= 1e-3 else ""
            diags.append(Diagnostic(
                "RA101", c.name,
                f"threshold {g!r} passed to {c.entry} is not the canonical "
                f"{w!r} bit for bit (rel err {rel:.2e}){near}; compute it "
                f"as the oracle does (eps2_f32, np.float32, eps_int)"))
    return diags


# ---------------------------------------------------------------------------
# RA103 / RA104 — host reads in a wrapper, float64 values
# ---------------------------------------------------------------------------

def lint_host_sync(c) -> list[Diagnostic]:
    """RA103 — the contract's CUDA wrapper, on its probe inputs on the fake
    card, may not read a tensor's values on the host: on the card that
    read waits for the device, and a wrapper should launch and return."""
    if c.kernel is None:
        return []
    args = c.probe(torch.device("cpu"))
    with fake_card():
        _, rec = record_ops(c.kernel, *args, methods=True)
    if not rec.host_reads:
        return []
    return [Diagnostic(
        "RA103", c.name,
        f"{len(rec.host_reads)} host read(s) of tensor values in the "
        f"wrapper (first: {rec.host_reads[0]}): it waits for the card "
        f"before its launch")]


def lint_f64(c, device="cuda") -> list[Diagnostic]:
    """RA104 — no float64 tensor while the contract's CUDA wrapper
    prepares its operands (on the fake card) or while its oracle runs on
    ``device``: the kernels' programs are fp32 (float64 belongs to the host
    oracles of the tests)."""
    device = analysis_device(device)
    hits = []
    if c.kernel is not None:
        args = c.probe(torch.device("cpu"))
        with fake_card():
            _, rec = record_ops(c.kernel, *args)
        hits += [f"wrapper: {op}" for op in rec.f64]
    if c.oracle is not None:
        args = c.probe(device)
        try:
            _, rec = record_ops(c.oracle, *args)
        except Exception:       # noqa: BLE001 — RA001 reports it
            rec = OpRecorder()
        hits += [f"oracle: {op}" for op in rec.f64]
    if not hits:
        return []
    return [Diagnostic(
        "RA104", c.name,
        f"{len(hits)} float64 result(s) (first: {hits[0]}): the kernels' "
        f"programs are declared fp32")]


# ---------------------------------------------------------------------------
# RA102 — int32 scalar reductions
# ---------------------------------------------------------------------------

def lint_int_reductions(rec: OpRecorder, *, subject: str
                        ) -> list[Diagnostic]:
    """RA102 — a reduction of a whole tensor to one int32 (or narrower)
    value, recorded while an engine ran: a counter summed so wraps
    silently once nq·N passes 2^31 (the reference's tree counters do, at
    SIFT scale). Per-row counts are bounded by the row and not flagged."""
    if not rec.int_reductions:
        return []
    ops = sorted(set(rec.int_reductions))
    return [Diagnostic(
        "RA102", subject,
        f"{len(rec.int_reductions)} reduction(s) to one int32 value "
        f"({', '.join(ops)}) — wraps silently at paper scale; sum counters "
        f"in int64 and report them as fp32, as the engines do")]
