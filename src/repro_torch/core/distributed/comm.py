"""The mesh of ranks over processes, and the exchanges between its ranks.

A mesh (``RingMesh``) is ``size`` ranks spread over the ``world``
processes of a ``torch.distributed`` process group: process p owns the run
of ``size // world`` consecutive ranks ``local_ranks``, all on its
``device``. ``world == 1`` is the single-process mesh: every rank lives in
this process and every exchange below is a reassignment of list slots.

The engines keep their per-rank state in lists indexed by rank, with the
slots of other processes' ranks left ``None``, and move it only through
this module. Each exchange moves a rank's payload in-process when source
and destination share a process, and over ``torch.distributed`` when they
do not:

- ``permute``: the ``ppermute`` (one ``batch_isend_irecv`` of every
  cross-process pair). It returns a handle, so a hop can be issued before
  the round it must not delay; ``wait()`` gives the moved list.
- ``all_gather``, ``all_to_all`` (the tiled one: equal,
  capacity-padded splits), ``broadcast``, ``all_max`` and
  ``gather_rows`` (every process gets every rank's rows).

Every process must issue the same exchanges in the same order, with the
same shapes on every rank (every payload is capacity-padded), and keep a
send's payload unchanged until its handle is waited on.

Transport. NCCL moves CUDA tensors card to card; it needs one card per
process (``process_device`` raises otherwise: NCCL refuses two processes
on one card). gloo moves host memory: a CUDA payload is copied to the
host for the exchange and back (``ExchangeStats.staging_s``). That is the
transport of the CPU tests and of several processes that share one card;
the backend is always the caller's or the launcher's choice, never a
silent fall back. Payloads travel as their bytes, whatever their dtype.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist


# the channel of flags, sizes and counters: exchanged, never modelled
CONTROL = "control"


@dataclass
class ExchangeStats:
    """What this process's exchanges moved and cost, per channel:
    ``moved``, the bytes of every rank-to-rank move its ranks sent,
    in-process moves included (what ``RunStats.comm_bytes`` models: a
    permute's payload a pair, an all-gather's rows once, an all-to-all's
    send buffers, a broadcast once a receiving rank); ``sent``, the bytes
    that left the process; ``seconds``, the host seconds spent issuing and
    waiting (with NCCL a wait only orders the streams). Flags, sizes,
    counters and clocks travel on the ``CONTROL`` channel (and
    ``all_max`` and ``gather_rows`` take none), which counts in ``sent``
    and ``seconds`` but never as moved; a payload moved under no channel
    counts under the key None, which no ``RunStats.comm_bytes`` formula
    has (the analyzer's RA201). ``staging_s``: gloo's host copies of CUDA
    payloads."""

    moved: dict = field(default_factory=dict)
    sent: dict = field(default_factory=dict)
    seconds: dict = field(default_factory=dict)
    staging_s: float = 0.0

    def add(self, channel, moved: int = 0, sent: int = 0,
            seconds: float = 0.0) -> None:
        if moved and channel != CONTROL:
            self.moved[channel] = self.moved.get(channel, 0) + moved
        key = channel or CONTROL
        if sent or seconds:
            self.sent[key] = self.sent.get(key, 0) + sent
            self.seconds[key] = self.seconds.get(key, 0.0) + seconds

    def reset(self) -> None:
        self.moved, self.sent, self.seconds = {}, {}, {}
        self.staging_s = 0.0


@dataclass(frozen=True)
class RingMesh:
    """``size`` ranks over the ``world`` processes of the default process
    group; this process is ``rank`` and owns ``local_ranks``, on
    ``device``. ``RingMesh(size, device)`` is every rank in this
    process."""

    size: int
    device: torch.device
    world: int = 1
    rank: int = 0
    backend: str | None = None
    stats: ExchangeStats = field(default_factory=ExchangeStats,
                                 compare=False, repr=False)

    def __post_init__(self):
        if self.size < 1 or self.world < 1 or self.size % self.world:
            raise ValueError(f"a mesh of {self.size} ranks cannot spread "
                             f"evenly over {self.world} processes")

    @property
    def local_ranks(self) -> range:
        per = self.size // self.world
        return range(self.rank * per, (self.rank + 1) * per)

    def owner(self, r: int) -> int:
        """The process that owns rank r."""
        return r // (self.size // self.world)


def process_device(local_rank: int, local_world: int, backend: str | None,
                   device=None, device_count: int | None = None
                   ) -> torch.device:
    """The device of the process with ``local_rank`` of the ``local_world``
    processes on its host: ``cuda:LOCAL_RANK`` unless ``device`` names
    another (``"cpu"``, or a card by index). With NCCL every process needs
    a card of its own; with gloo the processes may share the cards
    round robin."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if device_count is None:
        device_count = torch.cuda.device_count()
    if device_count < 1:
        raise RuntimeError(
            "no CUDA device is available: the port runs on the GPU by "
            "default; pass device='cpu' to run the plain PyTorch versions")
    if dev.index is not None:
        return dev
    if backend == "nccl" and local_world > device_count:
        raise RuntimeError(
            f"NCCL needs one card per process: {local_world} processes on "
            f"this host share {device_count} card(s), and NCCL refuses two "
            "processes on one card ('Duplicate GPU detected'); start one "
            "process per card, or use backend='gloo' to share a card "
            "through host memory")
    return torch.device("cuda", local_rank % device_count)


def make_nng_mesh(nranks: int | None = None, device=None) -> RingMesh:
    """The engines' mesh. Inside an initialised process group: ``nranks``
    ranks (default: the world, one rank a process; a multiple of it) over
    its processes, this process's on ``cuda:LOCAL_RANK`` unless ``device``
    says otherwise. Outside one: ``nranks`` (default 1) ranks in this
    process on ``device``. ``device=None`` means the CUDA card; a CUDA
    device on a machine without one raises instead of running on the
    CPU."""
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        backend = dist.get_backend()
        nranks = world if nranks is None else int(nranks)
        if nranks < 1 or nranks % world:
            raise ValueError(f"nranks={nranks} is not a positive multiple "
                             f"of the world size {world}")
        dev = process_device(int(os.environ.get("LOCAL_RANK", rank)),
                             int(os.environ.get("LOCAL_WORLD_SIZE", world)),
                             backend, device)
        return RingMesh(nranks, dev, world, rank, backend)
    nranks = 1 if nranks is None else int(nranks)
    if nranks < 1:
        raise ValueError(f"nranks must be >= 1 (got {nranks})")
    return RingMesh(nranks, process_device(0, 1, None, device))


# ---------------------------------------------------------------------------
# payloads on the wire
# ---------------------------------------------------------------------------

def _parts(payload) -> list:
    """A payload's tensors: one tensor, or a tuple of them."""
    return list(payload) if isinstance(payload, tuple) else [payload]


def _nbytes(payload) -> int:
    return sum(t.numel() * t.element_size() for t in _parts(payload))


def _wire_device(mesh: RingMesh) -> torch.device:
    return mesh.device if mesh.backend == "nccl" else torch.device("cpu")


def _to_wire(mesh: RingMesh, t: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes as a flat uint8 tensor on the transport's device."""
    w = t.contiguous().reshape(-1).view(torch.uint8)
    wd = _wire_device(mesh)
    if w.device != wd:
        t0 = time.perf_counter()
        w = w.to(wd)
        mesh.stats.staging_s += time.perf_counter() - t0
    return w


def _from_wire(mesh: RingMesh, w: torch.Tensor, shape, dtype):
    t = w.view(dtype).view(shape)
    if t.device != mesh.device:
        t0 = time.perf_counter()
        t = t.to(mesh.device)
        mesh.stats.staging_s += time.perf_counter() - t0
    return t


def _empty_wire(mesh: RingMesh, t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.numel() * t.element_size(), dtype=torch.uint8,
                       device=_wire_device(mesh))


def _local_payload(mesh: RingMesh, blocks: list):
    """A local rank's payload: the shapes every rank's payload has."""
    for r in mesh.local_ranks:
        if blocks[r] is not None:
            return blocks[r]
    raise ValueError("no local rank holds a payload")


# ---------------------------------------------------------------------------
# the exchanges
# ---------------------------------------------------------------------------

def ring_permute(blocks: list, perm) -> list:
    """The in-process ``ppermute``: ``perm`` is [(src, dst), ...]; rank dst
    now holds what rank src held (no copy)."""
    out = list(blocks)
    for src, dst in perm:
        out[dst] = blocks[src]
    return out


class Pending:
    """An issued ``permute``: ``wait()`` -> the list of moved payloads."""

    def __init__(self, mesh, out, recvs=(), works=(), sends=(), channel=None,
                 t0=0.0):
        self._mesh, self._out, self._recvs = mesh, out, recvs
        self._works, self._sends = works, sends
        self._channel, self._t0 = channel, t0

    def wait(self) -> list:
        if self._works:
            t0 = time.perf_counter()
            for w in self._works:
                w.wait()
            for dst, template, bufs in self._recvs:
                parts = [_from_wire(self._mesh, b, t.shape, t.dtype)
                         for b, t in zip(bufs, _parts(template))]
                self._out[dst] = (tuple(parts) if isinstance(template, tuple)
                                  else parts[0])
            self._mesh.stats.add(
                self._channel, sent=sum(s.numel() for s in self._sends),
                seconds=time.perf_counter() - t0 + self._t0)
            self._works, self._sends = (), ()
        return self._out


def permute(mesh: RingMesh, blocks: list, perm, *, channel=None) -> Pending:
    """Issue the ``ppermute`` of ``perm`` ([(src, dst), ...] over ranks) on
    ``blocks`` (a payload per rank: a tensor or a tuple of tensors, ``None``
    in other processes' slots). Cross-process pairs go out as one
    ``batch_isend_irecv``; the handle's ``wait()`` gives the list in which
    rank dst holds rank src's payload."""
    mesh.stats.add(channel, moved=sum(_nbytes(blocks[src]) for src, _ in perm
                                      if mesh.owner(src) == mesh.rank))
    if mesh.world == 1:
        return Pending(mesh, ring_permute(blocks, perm))
    t0 = time.perf_counter()
    out = [None] * mesh.size
    template = _local_payload(mesh, blocks)
    ops, sends, recvs = [], [], []
    me = mesh.rank
    for src, dst in perm:
        ps, pd = mesh.owner(src), mesh.owner(dst)
        if ps == me and pd == me:
            out[dst] = blocks[src]
        elif ps == me:
            for t in _parts(blocks[src]):
                w = _to_wire(mesh, t)
                sends.append(w)
                ops.append(dist.P2POp(dist.isend, w, pd))
        elif pd == me:
            bufs = [_empty_wire(mesh, t) for t in _parts(template)]
            ops += [dist.P2POp(dist.irecv, b, ps) for b in bufs]
            recvs.append((dst, template, bufs))
    works = dist.batch_isend_irecv(ops) if ops else []
    return Pending(mesh, out, recvs, works, sends, channel,
                   time.perf_counter() - t0)


def all_gather(mesh: RingMesh, local: torch.Tensor, *, channel=None
               ) -> torch.Tensor:
    """``local`` (len(local_ranks), ...) -> every rank's rows (size, ...),
    in rank order, on every process."""
    mesh.stats.add(channel, moved=_nbytes(local))
    if mesh.world == 1:
        return local
    t0 = time.perf_counter()
    w = _to_wire(mesh, local)
    bufs = [torch.empty_like(w) for _ in range(mesh.world)]
    dist.all_gather(bufs, w)
    out = torch.cat([_from_wire(mesh, b, local.shape, local.dtype)
                     for b in bufs])
    mesh.stats.add(channel, sent=w.numel() * (mesh.world - 1),
                   seconds=time.perf_counter() - t0)
    return out


def local_all_to_all(sends: list) -> list:
    """The in-process tiled ``all_to_all``: ``sends[s]`` is sender s's
    (n, cap, ...) buffer; rank r receives block r of every sender, in
    sender order, as one (n * cap, ...) buffer."""
    n = len(sends)
    return [torch.cat([sends[s][r] for s in range(n)]) for r in range(n)]


def all_to_all(mesh: RingMesh, sends: list, *, channel=None) -> list:
    """The tiled ``all_to_all``: ``sends[s]`` is rank s's (size, cap, ...)
    buffer (``None`` in other processes' slots); rank r receives block r
    of every sender, in sender order, as one (size * cap, ...) buffer.
    Returns the received buffers indexed by rank (local ranks only)."""
    n = mesh.size
    mesh.stats.add(channel, moved=sum(_nbytes(sends[s])
                                      for s in mesh.local_ranks))
    if mesh.world == 1:
        return local_all_to_all(sends)
    t0 = time.perf_counter()
    loc = list(mesh.local_ranks)
    m = len(loc)
    x = torch.stack([sends[s] for s in loc])          # (m, n, cap, ...)
    tail = tuple(x.shape[2:])
    # (dst process, src local, dst local, cap, ...): one equal split each
    x = x.view((m, mesh.world, m) + tail).transpose(0, 1)
    w = _to_wire(mesh, x)
    got = torch.empty_like(w)
    dist.all_to_all_single(got, w)
    y = _from_wire(mesh, got, (mesh.world, m) + (m,) + tail, x.dtype)
    out = [None] * n
    for j, r in enumerate(loc):
        out[r] = y[:, :, j].reshape((n * tail[0],) + tail[1:])
    mesh.stats.add(channel, sent=w.numel() * (mesh.world - 1) // mesh.world,
                   seconds=time.perf_counter() - t0)
    return out


def broadcast(mesh: RingMesh, payload: tuple, *, channel=None) -> tuple:
    """Rank 0's ``payload`` (a tuple of tensors) on every process; every
    process passes a payload of the same shapes."""
    root = mesh.owner(0)
    if mesh.rank == root:
        mesh.stats.add(channel, moved=(mesh.size - 1) * _nbytes(payload))
    if mesh.world == 1:
        return payload
    t0 = time.perf_counter()
    out = []
    for t in payload:
        w = _to_wire(mesh, t) if mesh.rank == root else _empty_wire(mesh, t)
        dist.broadcast(w, src=root)
        out.append(_from_wire(mesh, w, t.shape, t.dtype))
    sent = _nbytes(payload) * (mesh.world - 1) if mesh.rank == root else 0
    mesh.stats.add(channel, sent=sent, seconds=time.perf_counter() - t0)
    return tuple(out)


def all_max(mesh: RingMesh, *values):
    """The maximum of each value over the processes (python ints stay
    exact; anything else is taken as a float)."""
    if mesh.world == 1:
        return values[0] if len(values) == 1 else values
    t0 = time.perf_counter()
    ints = all(isinstance(v, int) for v in values)
    t = torch.tensor(values, dtype=torch.int64 if ints else torch.float64,
                     device=_wire_device(mesh))
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    out = tuple((int if ints else float)(v) for v in t.tolist())
    mesh.stats.add(None, seconds=time.perf_counter() - t0)
    return out[0] if len(out) == 1 else out


def gather_rows(mesh: RingMesh, x: torch.Tensor) -> torch.Tensor:
    """Every process's rows of ``x`` (n_p, ...), concatenated in process
    order, on every process (the row counts may differ)."""
    if mesh.world == 1:
        return x
    t0 = time.perf_counter()
    wd = _wire_device(mesh)
    n = torch.tensor([x.shape[0]], dtype=torch.int64, device=wd)
    sizes = [torch.empty_like(n) for _ in range(mesh.world)]
    dist.all_gather(sizes, n)
    sizes = [int(s) for s in sizes]
    top = max(sizes)
    pad = torch.zeros((top,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    pad[:x.shape[0]] = x
    w = _to_wire(mesh, pad)
    bufs = [torch.empty_like(w) for _ in range(mesh.world)]
    dist.all_gather(bufs, w)
    out = torch.cat([_from_wire(mesh, b, pad.shape, x.dtype)[:s]
                     for b, s in zip(bufs, sizes)])
    mesh.stats.add(None, sent=w.numel() * (mesh.world - 1),
                   seconds=time.perf_counter() - t0)
    return out


def barrier(mesh: RingMesh) -> None:
    """Wait for every process of the mesh."""
    if mesh.world == 1:
        return
    if mesh.backend == "nccl":
        dist.barrier(device_ids=[mesh.device.index])
    else:
        dist.barrier()
