"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``. The
build runs at first use, from the sources in this package only, into
``build/repro_torch/`` at the root of the checkout. A library's file name
carries a hash of its source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source is rebuilt and an unchanged one is reused. All
sources are compiled at once, one ``nvcc`` process each, started together.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
# library -> (C entry point, argtypes); every entry point returns the
# cudaGetLastError() code of its launch
_ENTRY = {
    "nng_tile": ("nng_tile_launch",
                 (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P)),
    "nng_tile_hamming": ("nng_tile_hamming_launch",
                         (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P)),
    "nng_tile_l1": ("nng_tile_l1_launch",
                    (_P, _P, _P, _P, _P, _I, _I, _I, _F, _P)),
    "nng_tile_grouped": ("nng_tile_grouped_launch",
                         (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F,
                          _P)),
    "nng_tile_grouped_hamming": ("nng_tile_grouped_hamming_launch",
                                 (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                  _I, _P)),
    "nng_tile_grouped_l1": ("nng_tile_grouped_l1_launch",
                            (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F,
                             _P)),
    "nng_tile_ghost": ("nng_tile_ghost_launch",
                       (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                        _I, _I, _F, _I, _P)),
    "nng_tile_ghost_hamming": ("nng_tile_ghost_hamming_launch",
                               (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _P)),
    "nng_tile_ghost_l1": ("nng_tile_ghost_l1_launch",
                          (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P)),
    "bits_to_cols": ("bits_to_cols_launch", (_P, _P, _I, _I, _I, _P)),
    "tree_frontier": ("tree_frontier_launch",
                      (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                       _I, _F, _F, _I, _P)),
    "tree_frontier_hamming": ("tree_frontier_hamming_launch",
                              (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _P)),
    "tree_frontier_l1": ("tree_frontier_l1_launch",
                         (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F,
                          _I, _P)),
    "leaf_range_pack": ("leaf_range_pack_launch",
                        (_P, _LL, _P, _P, _P, _P, _I, _I, _P)),
    "pairwise_sqdist": ("pairwise_sqdist_launch",
                        (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P)),
    "pairwise_hamming": ("pairwise_hamming_launch",
                         (_P, _P, _P, _I, _I, _I, _P)),
    "eps_count": ("eps_count_launch",
                  (_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P)),
}

_loaded: dict = {}                     # library -> loaded entry point
build_seconds: float | None = None     # wall clock of the last load()
ptxas_log: dict[str, str] = {}         # nvcc -Xptxas -v output per library


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{h}.so"


def load() -> None:
    """Compile every kernel whose library is missing, in parallel, then
    load all of them. Raises if any build fails."""
    global build_seconds
    if len(_loaded) == len(_ENTRY):
        return
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in _ENTRY:
        so = _target(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, so)
    failed = []
    for name, (proc, tmp, so) in jobs.items():
        log, _ = proc.communicate()
        ptxas_log[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    for name, (symbol, argtypes) in _ENTRY.items():
        fn = getattr(ctypes.CDLL(str(_target(name))), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    build_seconds = time.perf_counter() - t0


def entry(name: str):
    """The loaded C entry point of kernel ``name`` (builds on first use)."""
    load()
    return _loaded[name]


def check(name: str, code: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code}")
