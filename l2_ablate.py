#!/usr/bin/env python3
"""Where the fp32 L2 tile kernels' time goes on the card.

    python3 l2_ablate.py [OTHER] [--rounds 2] [--reps 3]

Builds this checkout's ``nng_tile.cu`` and ``eps_count.cu`` (the pipelined
core, ``csrc/l2_pipe.cuh``) as they are and in variants that each remove
one cost; a variant's outputs are wrong, and it is only timed:

  base     the kernels as they are;
  no_epi   the epilogue skipped (a branch on the data that never holds);
  no_x     the x shared-memory loads replaced by registers;
  no_y     the y shared-memory loads made the same for every k group
           (each lane's own 16 bytes of its rows, free of bank conflicts);
  no_copy  the TMA copies of x and y not issued (the norms still are).

Each runs on the same random normal x, y (131072 x 128 each, seed 0: the
main path's tile shape) with eps 13, in turns, each time the median of
``--reps`` CUDA-event runs after a warm-up, beside ``torch.mm(x, y.T)``
(the same product alone) and, for ``base``, the SM clock and board power
that nvidia-smi samples during 12 launches.

With OTHER, the root of another checkout or of an unpacked ``git archive``
of one, its ``nng_tile.cu`` and ``eps_count.cu`` (with its own headers) are
built and timed in the same turns ("other"), and must give the same counts
as this checkout's; their entry points may take this checkout's arguments
or those of the single-launch core (no norm scratch, no SM count). Where
their epilogues call tile_io.cuh's ``store_hits`` or ``count_hits``, they
are also built with those calls skipped ("other_no_epi", timed only).

It also times a shared-memory load microbenchmark: 16 warps an SM each
issuing independent 16-byte loads that every lane of the warp takes from
one address (a broadcast), or each lane from its own (16 bytes apart),
or 4-byte broadcasts, and prints the loads an SM completes a clock (at
the SM clock sampled during the run).

For every library built it prints ptxas's registers and spills and, from
``cuobjdump -sass``, its main loop (the backward branch holding the most
FFMA) as counts of instructions, FFMA and shared loads, and the distance in
instructions from each shared load to the first instruction that reads
what it loaded (mean and minimum). Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
N, DIM, EPS, SEED = 131072, 128, 13.0, 0
LIBS = ("nng_tile", "eps_count")
EPI = "epi(cm0, cn0, acc, tn.x, tn.y);"
XLOAD = ("const float4 a = *reinterpret_cast<const float4*>(\n"
         "          xw + i * 128 + ((c ^ (i & 7)) << 4));")
YLOAD = "b[j] = *reinterpret_cast<const float4*>(yl + 32 * 128 * j + yc);"
COPY = ("          tma_load(dst, &maps.x, pk * BK, pm0, bar);\n"
        "          tma_load(dst + PM * BK * 4, &maps.y, pk * BK, pn0, bar);\n")
EXPECT = "mbar_expect(bar, STAGE_BYTES + (pk == 0 ? sizeof(Norms) : 0));"
# variant -> substitutions in l2_pipe.cuh
VARIANTS = {
    "base": [],
    "no_epi": [(EPI, "if (acc[0][0] == 1234.5f && acc[15][3] == 1.f) "
                + EPI)],
    "no_x": [(XLOAD, "const float4 a = b[i & 7];")],
    "no_y": [(YLOAD, YLOAD.replace(" + yc", " + ((lane & 7) << 4)"))],
    "no_copy": [(COPY, ""), (EXPECT,
                             "mbar_expect(bar, pk == 0 ? sizeof(Norms) : 0);")],
}


# the shared-load microbenchmark: mode 0 LDS.128 broadcast, 1 LDS.128 a
# lane 16 bytes apart, 2 LDS.32 broadcast; 16 loads an iteration
LDS_SRC = r"""
#include <cuda_runtime.h>
template <int MODE>
__global__ void lds_kernel(float* out, int iters) {
  __shared__ __align__(16) float s[8192];
  for (int i = threadIdx.x; i < 8192; i += blockDim.x) s[i] = i * 0.5f;
  __syncthreads();
  const unsigned sb = static_cast<unsigned>(__cvta_generic_to_shared(s));
  const int lane = threadIdx.x & 31;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const int base = (threadIdx.x >> 5) * 64;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int off = ((base + u * 4 + it) & 4095) & ~3;
      float4 v;
      if (MODE == 2) {
        asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v.x) : "r"(sb + off * 4));
      } else {
        const int e = MODE == 0 ? off : (off + lane * 4) & 8191;
        asm volatile("ld.shared.v4.f32 {%0,%1,%2,%3}, [%4];"
                     : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                     : "r"(sb + e * 4));
      }
      acc[u & 3] += v.x;
    }
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] =
      acc[0] + acc[1] + acc[2] + acc[3];
}
extern "C" int lds_run(void* out, int mode, int blocks, int iters) {
  float* o = static_cast<float*>(out);
  if (mode == 0) lds_kernel<0><<<blocks, 256>>>(o, iters);
  else if (mode == 1) lds_kernel<1><<<blocks, 256>>>(o, iters);
  else lds_kernel<2><<<blocks, 256>>>(o, iters);
  return static_cast<int>(cudaGetLastError());
}
"""
LDS_MODES = ("LDS.128 broadcast", "LDS.128 a lane", "LDS.32 broadcast")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SINGLE = {"nng_tile": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _P),
          "eps_count": (_P, _P, _P, _I, _I, _I, _F, _P)}


def median_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def sources(txt: str) -> str:
    """The operands an instruction reads: those after its first (the
    destination), the predicate guard and the opcode dropped."""
    parts = txt.split(None, 2 if txt.startswith("@") else 1)
    ops = parts[-1] if len(parts) > (2 if txt.startswith("@") else 1) else ""
    return ops.split(",", 1)[1] if "," in ops else ops


def sass_loop(so: Path) -> dict:
    """The main loop of the library's first TMA (or only) kernel: the
    backward branch whose body holds the most FFMA."""
    cuobjdump = Path(shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
                     ).parent / "cuobjdump"
    if not cuobjdump.exists():
        cuobjdump = Path("/usr/local/cuda/bin/cuobjdump")
    return loop_stats(subprocess.run([str(cuobjdump), "-sass", str(so)],
                                     capture_output=True, text=True).stdout)


def loop_stats(text: str) -> dict:
    """sass_loop's statistics of ``cuobjdump -sass`` output ``text``."""
    funcs = re.split(r"\n\s*Function : ", text)[1:]
    func = next((f for f in funcs if "ILb1E" in f.split("\n", 1)[0]),
                funcs[0] if funcs else "")
    ins = [(int(m.group(1), 16), m.group(2).strip()) for m in re.finditer(
        r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", func)]
    best = (0, [])
    for addr, txt in ins:
        m = re.search(r"BRA (0x[0-9a-f]+)", txt)
        if m and int(m.group(1), 16) < addr:
            body = [t for a, t in ins if int(m.group(1), 16) <= a <= addr]
            nf = sum(t.split()[0 if not t.startswith("@") else 1]
                     .startswith("FFMA") for t in body)
            if nf > best[0]:
                best = (nf, body)
    body = best[1]
    ops = [t.split()[1 if t.startswith("@") else 0] for t in body]
    dists = []
    for i, (op, txt) in enumerate(zip(ops, body)):
        if not op.startswith("LDS"):
            continue
        m = re.search(r"LDS\S*\s+R(\d+)", txt)
        if m is None:
            continue
        width = 4 if ".128" in op else 2 if ".64" in op else 1
        regs = {f"R{int(m.group(1)) + k}" for k in range(width)}
        for k in range(i + 1, len(body)):
            if any(re.search(rf"\b{r}\b", sources(body[k])) for r in regs):
                dists.append(k - i)
                break
    return {"instructions": len(body), "ffma": best[0],
            "lds": sum(o.startswith("LDS") for o in ops),
            "lds_to_use_mean": statistics.mean(dists) if dists else None,
            "lds_to_use_min": min(dists) if dists else None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, nargs="?")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("l2_ablate: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.nng_tile import eps2_f32

    csrc = _build.CSRC
    out = _build.BUILD_DIR.parent / "ablate"
    shutil.rmtree(out, ignore_errors=True)
    trees = {}
    for name, subs in VARIANTS.items():
        d = out / name
        shutil.copytree(csrc, d)
        head = (d / "l2_pipe.cuh").read_text()
        for a, b in subs:
            if a not in head:
                print(f"l2_ablate: {name}: l2_pipe.cuh no longer holds "
                      f"{a!r}", file=sys.stderr)
                return 1
            head = head.replace(a, b)
        (d / "l2_pipe.cuh").write_text(head)
        trees[name] = d
    if args.other is not None:
        trees["other"] = args.other.resolve() / "src/repro_torch/kernels/csrc"
        d = out / "other_no_epi"
        shutil.copytree(trees["other"], d)
        skipped = 0
        for lib in LIBS:
            src = (d / f"{lib}.cu").read_text()
            for call in ("store_hits(", "count_hits("):
                skipped += src.count(call)
                src = src.replace(call, "if (acc[0][0] == 1234.5f) " + call)
            (d / f"{lib}.cu").write_text(src)
        if skipped:
            trees["other_no_epi"] = d
    (out / "lds.cu").write_text(LDS_SRC)
    lds_proc = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / "lds.so"),
         str(out / "lds.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    procs = {}
    for name, d in trees.items():
        for lib in LIBS:
            so = out / f"{name}-{lib}.so"
            procs[(name, lib)] = (subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                 str(d / f"{lib}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), so)
    fns, record = {}, {"sass": {}, "ptxas": {}}
    for (name, lib), (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"l2_ablate: nvcc failed for {name} {lib}:\n{log}",
                  file=sys.stderr)
            return 1
        ptx = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
               if "registers" in ln or "spill" in ln]
        sass = sass_loop(so)
        record["ptxas"][f"{name} {lib}"] = ptx
        record["sass"][f"{name} {lib}"] = sass
        print(f"{name} {lib}: ptxas {' | '.join(ptx)}")
        print(f"{name} {lib}: main loop {json.dumps(sass)}")
        symbol, argtypes = _build._ENTRY[lib]
        fn = getattr(ctypes.CDLL(str(so)), symbol)
        # the other tree's entry points take this checkout's arguments, or
        # the single-launch core's (no norm scratch, no SM count)
        if name.startswith("other") and "int sms" not in (
                trees[name] / f"{lib}.cu").read_text():
            argtypes = SINGLE[lib]
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[(name, lib)] = fn

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(N, DIM, generator=gen, device=dev)
    y = torch.randn(N, DIM, generator=gen, device=dev)
    yv = torch.ones(N, dtype=torch.int32, device=dev)
    xsq = torch.empty(N, device=dev)
    ysq = torch.empty(N, device=dev)
    e2 = eps2_f32(EPS)

    def launch(name, lib):
        fn = fns[(name, lib)]
        cnt = torch.zeros(N, dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        single = tuple(fn.argtypes) == SINGLE[lib]
        if lib == "nng_tile":
            bits = torch.empty((N, N // 32), dtype=torch.int32, device=dev)
            head = (x.data_ptr(), y.data_ptr(), yv.data_ptr(),
                    cnt.data_ptr(), bits.data_ptr())
        else:
            head = (x.data_ptr(), y.data_ptr(), cnt.data_ptr())
        mid = () if single else (xsq.data_ptr(), ysq.data_ptr())
        tail = (N, N, DIM, e2) + (() if single else (sms,)) + (stream,)
        code = fn(*head, *mid, *tail)
        if code != 0:
            raise RuntimeError(f"{name} {lib}: CUDA error {code}")
        return cnt

    ref = launch("base", "eps_count")
    for lib in LIBS:
        # (no_* variants and other_no_epi compute wrong counts: timed only)
        if "other" in trees and not torch.equal(launch("other", lib), ref):
            print(f"l2_ablate: the other tree's {lib} counts differ",
                  file=sys.stderr)
            return 1
        if not torch.equal(launch("base", lib), ref):
            print(f"l2_ablate: base {lib} counts differ from eps_count's",
                  file=sys.stderr)
            return 1
    torch.cuda.empty_cache()
    times = {f"{n} {lib}": [] for n in trees for lib in LIBS}
    times["torch.mm"] = []
    for _ in range(args.rounds):
        for name in trees:
            for lib in LIBS:
                times[f"{name} {lib}"].append(median_ms(
                    torch, lambda: launch(name, lib), args.reps))
        times["torch.mm"].append(median_ms(torch, lambda: torch.mm(x, y.T),
                                           args.reps))
        torch.cuda.empty_cache()
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "50"],
                           stdout=subprocess.PIPE, text=True)
    try:
        time.sleep(0.3)
        for _ in range(12):
            launch("base", "nng_tile")
        torch.cuda.synchronize()
    finally:
        smi.terminate()
        samples, _ = smi.communicate()
    rows = [r.split(",") for r in samples.strip().splitlines()]
    rows = [(float(a), float(b)) for a, b in rows[len(rows) // 3:]]
    record["clock_mhz"] = statistics.median(r[0] for r in rows)
    record["power_w"] = statistics.median(r[1] for r in rows)
    log, _ = lds_proc.communicate()
    if lds_proc.returncode != 0:
        print(f"l2_ablate: nvcc failed for the microbenchmark:\n{log}",
              file=sys.stderr)
        return 1
    lds = ctypes.CDLL(str(out / "lds.so")).lds_run
    lds.argtypes, lds.restype = (_P, _I, _I, _I), ctypes.c_int
    sink = torch.empty(2 * sms * 256, device=dev)
    record["lds_per_sm_clock"] = {}
    for mode, label in enumerate(LDS_MODES):
        iters = 20000
        lds(sink.data_ptr(), mode, 2 * sms, 10)
        ms = median_ms(torch, lambda: lds(sink.data_ptr(), mode, 2 * sms,
                                          iters), args.reps)
        per_clk = (2 * sms * 8 * iters * 16 / sms
                   / (ms * 1e-3 * record["clock_mhz"] * 1e6))
        record["lds_per_sm_clock"][label] = per_clk
        print(f"shared loads, 16 warps an SM: {label}: {per_clk:.3f} warp "
              f"loads an SM a clock ({ms:.3f} ms)")
    flops = 2 * N * N * DIM
    for key, ts in times.items():
        med = statistics.median(ts)
        record[key] = {"median_ms": med, "ms": ts}
        print(f"{key}: {' '.join(f'{t:.3f}' for t in ts)} ms; median "
              f"{med:.3f} ms, {flops / med / 1e9:.2f} TFLOP/s")
    print(f"base nng_tile under load: SM clock {record['clock_mhz']:.0f} "
          f"MHz, board power {record['power_w']:.1f} W (nvidia-smi medians)")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
