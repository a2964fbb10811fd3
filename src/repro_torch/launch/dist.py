"""Start the port on processes the way ``torchrun`` does.

``init()`` reads torchrun's variables (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``),
picks this process's device (``comm.process_device``: ``cuda:LOCAL_RANK``
unless the caller asks for the CPU), sets it as the current card before
the group starts, and starts the default process group: NCCL on the card,
gloo on the CPU, or the backend the caller names. A program run under

    python -m torch.distributed.run --nproc-per-node P -m <module> ...

calls ``init()`` first and then ``make_nng_mesh()``.

``spawn(fn, world, ...)`` starts ``world`` processes on this host with the
same variables set, as torchrun would without its agent, runs
``fn(*args)`` in each (``fn`` must be importable: a module-level
function) and returns their results by rank. A process that fails makes
``spawn`` stop the others and raise with its error output; a run past
``timeout`` seconds is stopped and raises too: the caller never waits
forever.

    python -m repro_torch.launch.dist JOB_DIR

is the child's side (``spawn`` writes the job; not for direct use).
"""
from __future__ import annotations

import importlib
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist

from repro_torch.core.distributed.comm import process_device

TIMEOUT_S = 600       # a collective that waits longer raises


def init(backend: str | None = None, device=None) -> torch.device:
    """Start the default process group from torchrun's variables ->
    this process's device. ``backend`` defaults to NCCL on a CUDA device
    and gloo on the CPU; with NCCL every process needs a card of its own
    (raises otherwise, on every process)."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    kind = torch.device("cuda" if device is None else device).type
    if backend is None:
        backend = "nccl" if kind == "cuda" else "gloo"
    dev = process_device(local, local_world, backend, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
    port = os.environ["MASTER_PORT"]
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=TIMEOUT_S))
    # the group's first collective involves every process
    if backend == "nccl":
        dist.barrier(device_ids=[dev.index])
    else:
        dist.barrier()
    return dev


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def spawn(fn, world: int, backend: str | None = None, device=None,
          args: tuple = (), timeout: float = 600.0,
          threads: int | None = None) -> list:
    """Run ``fn(*args)`` in ``world`` new processes of one process group
    (``init(backend, device)`` in each) -> their results by rank.
    ``threads`` sets each process's torch intra-op threads. Raises
    ``RuntimeError`` with the error output of the processes that failed,
    or ``TimeoutError`` after ``timeout`` seconds; either way every
    process is stopped first."""
    module = fn.__module__
    path = [p for p in sys.path if p and os.path.isdir(p)]
    if module == "__main__":
        # a script's function: the children import the script by its name
        script = os.path.abspath(sys.modules["__main__"].__file__)
        module = os.path.splitext(os.path.basename(script))[0]
        path.insert(0, os.path.dirname(script))
    job = tempfile.mkdtemp(prefix="repro_torch_spawn_")
    try:
        with open(os.path.join(job, "job.pkl"), "wb") as f:
            pickle.dump({"module": module, "name": fn.__qualname__,
                         "args": args, "backend": backend,
                         "device": device, "threads": threads}, f)
        env = dict(os.environ, WORLD_SIZE=str(world),
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(_free_port()),
                   PYTHONPATH=os.pathsep.join([os.getcwd()] + path))
        procs, logs = [], []
        for r in range(world):
            log = open(os.path.join(job, f"err{r}.txt"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dist", job],
                env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                stdout=log, stderr=subprocess.STDOUT))
        t0 = time.monotonic()
        try:
            while True:
                codes = [p.poll() for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    _stop(procs)
                    errs = []
                    for r in bad:      # a peer's failure may fail others
                        with open(os.path.join(job, f"err{r}.txt")) as f:
                            errs.append(f"process {r} of {world} exited "
                                        f"with code {codes[r]}:\n"
                                        f"{f.read()[-4000:]}")
                    raise RuntimeError("\n".join(errs))
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() - t0 > timeout:
                    _stop(procs)
                    raise TimeoutError(f"{world} processes still running "
                                       f"after {timeout} s: stopped")
                time.sleep(0.05)
        finally:
            _stop(procs)
            for log in logs:
                log.close()
        out = []
        for r in range(world):
            with open(os.path.join(job, f"out{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(job, ignore_errors=True)


def _child(job: str) -> int:
    with open(os.path.join(job, "job.pkl"), "rb") as f:
        spec = pickle.load(f)
    if spec["threads"]:
        torch.set_num_threads(spec["threads"])
    init(spec["backend"], spec["device"])
    try:
        fn = importlib.import_module(spec["module"])
        for part in spec["name"].split("."):
            fn = getattr(fn, part)
        result = fn(*spec["args"])
    except Exception:
        # the error goes out first, and the process ends without waiting
        # on a group whose other processes may be blocked in a collective
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    dist.destroy_process_group()
    with open(os.path.join(job, f"out{os.environ['RANK']}.pkl"), "wb") as f:
        pickle.dump(result, f)
    return 0


if __name__ == "__main__":
    sys.exit(_child(sys.argv[1]))
