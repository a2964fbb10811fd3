#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout (it imports ``repro_torch`` from ``src/``
beside this file and never imports JAX or the ``repro`` package). Phases,
each printed as it runs; any failed check raises and exits non-zero:

  1. the card (nvidia-smi name and power limit), torch, the kernels' build
     (nvcc for sm_90a into build/repro_torch/, timed);
  2. each CUDA kernel against its plain PyTorch version on the card:
     ``nng_tile`` at 8192x8192x128 and two ragged shapes (bits equal except
     at pairs whose float64 d² lies within 1e-4·eps² of eps²),
     ``bits_to_cols`` bit-identical on random and real words at several k;
  3. the main path: ``build_nng`` at the ``nng-sift-1m`` shape (n = 2^20,
     d = 128, euclidean; synthetic stand-in from seed 0) on 8 logical ranks,
     with both kernels' launch counts read from that run alone; then one
     more engine run under torch.profiler (device time by kernel, idle
     share) and the CSR assembly, timed;
  4. exactness of 1024 sampled rows against float64 distances to all n
     points, computed on the card (inside the fp32 band), and against the
     plain fp32 expansion on the card (off the knife edge, below);
  5. each kernel at the main path's inputs: its output against its plain
     version's (``nng_tile`` off the knife edge, ``bits_to_cols``
     bit-identical), and its time (CUDA events, median) beside its bound,
     its plain version's time and a library yardstick.

Two fp32 evaluations of ‖x‖² + ‖y‖² − 2x·y that sum in different orders
may classify a pair differently only on the knife edge: float64
|d² − eps²| within the larger of 1e-4·eps² and KNIFE_ULPS fp32 rounding
units of ‖x‖² + ‖y‖². The second term matters for points far from the
origin, as the main path's are: one rounding unit of ‖x‖² + ‖y‖² then
exceeds 1e-4·eps².

The last lines are the kernels' JSON record, the nvidia-smi line, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

CONFIG = "nng-sift-1m"  # 1M x 128 euclidean (configs/paper_nng.py)
NRANKS = 8
SEED = 0               # synthetic_pointset seed of the main path's points
EPS = 2.98             # mean degree ~70 on this point set (the paper's figure)
K_CAP = 256            # below the max degree: exactly one grow
SAMPLE = 1024          # rows checked against float64 in phase 4
SAMPLE_SEED = 1
KNIFE_REL = 1e-4       # knife edge: 1e-4·eps², or KNIFE_ULPS units of
KNIFE_ULPS = 20        # 2^-24·(‖x‖² + ‖y‖²), whichever is wider
U32 = 2.0 ** -24       # fp32 unit roundoff

# H100 SXM data sheet: fp32 outside the tensor cores, HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps):
    """Median milliseconds of ``fn()`` over ``reps`` runs after one warm-up,
    each bracketed by CUDA events."""
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs the GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    import numpy as np

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import NNG_CONFIGS
    from repro_torch.core.distributed import make_nng_mesh
    from repro_torch.core.graph import NNGraph
    from repro_torch.data import synthetic_pointset
    from repro_torch.kernels import _build
    from repro_torch.kernels.bits_epilogue import (bits_to_cols_cuda,
                                                   bits_to_cols_ref)
    from repro_torch.kernels.nng_tile import (eps2_f32, nng_tile_cuda,
                                              nng_tile_ref, unpack_words)
    from repro_torch.kernels.ops import _pad_rows
    from repro_torch.nng import PointPartitionEngine, build_nng

    cfg = NNG_CONFIGS[CONFIG]
    check(cfg.metric == "euclidean", f"{CONFIG} is not euclidean")
    N, DIM = cfg.n, cfg.dim
    # the plain versions' products in full fp32, as the kernel computes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    eps2 = eps2_f32(EPS)
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()

    def differing_pairs(a, b):
        """(rows, cols) of every bit where two packed bitmasks differ."""
        dw = a ^ b
        r, w = dw.nonzero(as_tuple=True)
        m, bit = unpack_words(dw[r, w][:, None]).nonzero(as_tuple=True)
        return r[m], w[m] * 32 + bit

    def knife_check(label, xa, yb, i, j, thr):
        """Fail unless every pair (xa[i], yb[j]) lies on the knife edge of
        ``thr``, measured in float64; print how far the farthest lies."""
        a, b = xa[i].double(), yb[j].double()
        dev_ = (((a - b) ** 2).sum(1) - thr).abs()
        scale = (a * a).sum(1) + (b * b).sum(1)
        knife = (KNIFE_ULPS * U32 * scale).clamp_min(KNIFE_REL * thr)
        outside = int((dev_ > knife).sum())
        past_rel = int((dev_ > KNIFE_REL * thr).sum())
        far_rel = float((dev_ / thr).max()) if len(dev_) else 0.0
        far_u = float((dev_ / (U32 * scale)).max()) if len(dev_) else 0.0
        print(f"    {label}: {len(dev_)} pairs differ, {past_rel} of them "
              f"beyond 1e-4·eps²; the farthest at |d²-eps²| = "
              f"{far_rel:.4g}·eps² = {far_u:.4g} fp32 units of ‖x‖²+‖y‖²")
        check(outside == 0, f"{label}: {outside} pairs differ off the knife "
                            f"edge (wider of 1e-4·eps² and {KNIFE_ULPS} "
                            "units)")

    # -- 1. the card and the build -------------------------------------------
    print(f"[1] card: {smi}")
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    _build.load()
    print(f"[1] kernels built in {_build.build_seconds:.2f} s into "
          f"{_build.BUILD_DIR}")
    for lib, log in _build.ptxas_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[1]   {lib}: {line.strip()}")

    # -- 2. kernels against their plain versions -----------------------------
    rng = np.random.default_rng(SEED)
    tile_err = 0
    real_bits = None
    for q, p, d in ((8192, 8192, 128), (1000, 777, 100), (37, 64, 3)):
        x = torch.from_numpy(rng.normal(size=(q, d)).astype(np.float32)).to(dev)
        y = torch.from_numpy(rng.normal(size=(p, d)).astype(np.float32)).to(dev)
        yv = torch.from_numpy((rng.random(p) > 0.1).astype(np.int32)).to(dev)
        d2_64 = torch.cdist(x.double(), y.double()) ** 2
        # eps at the 1% quantile of the pair distances
        eps = float(torch.quantile(d2_64.flatten()[:1 << 20].float(),
                                   0.01).sqrt())
        e2 = eps2_f32(eps)
        cnt_k, bits_k = nng_tile_cuda(x, y, yv, eps)
        yp, _ = _pad_rows(y, 32)
        yvp, _ = _pad_rows(yv, 32)
        cnt_p, bits_p = nng_tile_ref(x, yp, yvp, eps)
        torch.cuda.synchronize()
        differ = unpack_words(bits_k ^ bits_p)[:, :p]
        knife = (d2_64 - e2).abs() <= KNIFE_REL * e2
        outside = int((differ & ~knife).sum())
        check(bits_k.shape == (q, -(-p // 32)), f"nng_tile bits shape {bits_k.shape}")
        check(torch.equal(cnt_k, unpack_words(bits_k).sum(1, dtype=torch.int32)),
              f"nng_tile ({q},{p},{d}): cnt is not the popcount of bits")
        check(not unpack_words(bits_k)[:, p:].any(), "bits past column p set")
        check(outside == 0, f"nng_tile ({q},{p},{d}): {outside} pairs differ "
                            "from the plain version off the knife edge")
        err = int((cnt_k - cnt_p).abs().max())
        tile_err = max(tile_err, err)
        print(f"[2] nng_tile ({q},{p},{d}) eps={eps:.6g}: hits "
              f"{int(cnt_p.sum())}, pairs differing {int(differ.sum())} "
              f"(all within the knife edge), knife-edge pairs "
              f"{int(knife.sum())}, max |cnt diff| {err}")
        if real_bits is None:
            real_bits = bits_k
        del d2_64, knife, differ
    words = torch.from_numpy(rng.integers(-2**31, 2**31, size=(5000, 37))
                             .astype(np.int32)).to(dev)
    words[1::3] &= torch.roll(words[1::3], 1, 1) & torch.roll(words[1::3], 2, 1)
    words[::7] = 0
    b2c_err = 0
    for label, b in (("random words", words), ("real tile bits", real_bits)):
        counts = unpack_words(b).sum(1)
        for k in (1, 7, 64, 300):
            got, want = bits_to_cols_cuda(b, k), bits_to_cols_ref(b, k)
            b2c_err = max(b2c_err, int((got - want).abs().max()))
            check(torch.equal(got, want), f"bits_to_cols differs from its "
                                          f"plain version on {label} at k={k}")
        print(f"[2] bits_to_cols bit-identical on {label} {tuple(b.shape)} "
              f"for k in (1, 7, 64, 300); row counts "
              f"{int(counts.min())}..{int(counts.max())}")

    # -- 3. the main path ----------------------------------------------------
    pts = synthetic_pointset(N, DIM, seed=SEED)
    mesh = make_nng_mesh(NRANKS)
    del real_bits, words
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    nng_tile_cuda.launches = 0
    bits_to_cols_cuda.launches = 0
    t0 = time.perf_counter()
    g = build_nng(pts, EPS, mesh=mesh, k_cap=K_CAP)
    wall = time.perf_counter() - t0
    launches = {"nng_tile": nng_tile_cuda.launches,
                "bits_to_cols": bits_to_cols_cuda.launches}
    st = g.stats
    print(f"[3] build_nng(n={N}, d={DIM}, eps={EPS}, nranks={NRANKS}, "
          f"k_cap={K_CAP}): {g.num_edges} edges, mean degree "
          f"{g.avg_degree:.2f}, max degree {int(g.degrees().max())}")
    print(f"[3] elapsed_s {st.elapsed_s:.3f} (steady-state run), call wall "
          f"{wall:.3f} s, replans {st.replans}, plan k_cap {g.meta['plan']}")
    print(f"[3] tiles_scheduled {st.tiles_scheduled:.0f} tiles_skipped "
          f"{st.tiles_skipped:.0f} dists_evaluated {st.dists_evaluated:.6g}")
    print(f"[3] comm_bytes {json.dumps(st.comm_bytes)}")
    print(f"[3] max_memory_allocated {torch.cuda.max_memory_allocated()} B")
    print(f"[3] launches {json.dumps(launches)}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path never launched: {launches}")
    check(st.replans <= 1, f"{st.replans} grows (expected at most one)")
    check(g.num_edges > 0, "the main path found no edges")

    # -- 3b. where the time goes: one more engine run at the final plan ------
    plan = int(g.meta["plan"])
    eng = PointPartitionEngine(pts, EPS, mesh, "euclidean", k_cap=plan)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = eng.run(plan)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    NNGraph.from_neighbor_tables(N, eng.neighbor_tables(out))
    csr_s = time.perf_counter() - t0
    del out, eng
    by_name, spans = {}, []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            r = e.time_range
            by_name[e.name] = by_name.get(e.name, 0.0) + r.elapsed_us() / 1e3
            spans.append((r.start, r.end))
    check(spans, "the profiler saw no device time")
    spans.sort()
    busy, (s0, e0) = 0.0, spans[0]
    for s1, e1 in spans[1:]:
        if s1 > e0:
            busy, s0 = busy + (e0 - s0), s1
        e0 = max(e0, e1)
    busy += e0 - s0
    window = spans[-1][1] - spans[0][0]
    print(f"[3b] profiled engine run {run_s:.3f} s; CSR assembly on the card "
          f"{csr_s:.3f} s; device busy {busy / 1e3:.1f} ms of "
          f"{window / 1e3:.1f} ms (idle share {1 - busy / window:.4f})")
    for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[3b]   {ms:10.2f} ms  {kname[:90]}")

    # -- 4. exactness on a sample --------------------------------------------
    P = torch.from_numpy(pts).to(dev)
    P64 = P.double()
    sq = (P64 * P64).sum(1)
    rows = np.sort(np.random.default_rng(SAMPLE_SEED).choice(N, SAMPLE,
                                                              replace=False))
    ones_n = torch.ones(N, dtype=torch.int32, device=dev)
    mism = knife_mism = band_pairs = pop_rel = pop_knife = 0
    wit_i, wit_j = [], []
    for r0 in range(0, SAMPLE, 64):
        r = torch.from_numpy(rows[r0:r0 + 64]).to(dev)
        d2 = (sq[r][:, None] + sq[None, :] - 2.0 * (P64[r] @ P64.T)).clamp_min(0)
        dist = d2.sqrt()
        truth = dist <= EPS
        truth[torch.arange(len(r), device=dev), r] = False
        got = torch.zeros_like(truth)
        for i, row in enumerate(rows[r0:r0 + 64].tolist()):
            nb = torch.from_numpy(g.neighbors(row).astype(np.int64)).to(dev)
            got[i, nb] = True
        differ = truth ^ got
        # the fp32 band of the expansion, as the repo's float64 oracle sets
        # it (HostEuclidean.band_slack): (|x|² + |y|² + eps²)·1e-5
        band = ((d2 - EPS ** 2).abs()
                <= (sq[r][:, None] + sq[None, :] + EPS ** 2) * 1e-5 + 1e-9)
        bad = int((differ & ~band).sum())
        check(bad == 0, f"{bad} sampled pairs differ from float64 outside "
                        "the fp32 band")
        mism += int(differ.sum())
        knife_mism += int((differ & ((dist - EPS).abs() <= 1e-5 * EPS)).sum())
        band_pairs += int(band.sum())
        # the exact witness: the plain fp32 expansion on the same points
        _, wb = nng_tile_ref(P[r], P, ones_n, EPS)
        plain = unpack_words(wb)
        plain[torch.arange(len(r), device=dev), r] = False
        i, j = (plain ^ got).nonzero(as_tuple=True)
        wit_i.append(r[i])
        wit_j.append(j)
        off = (d2 - eps2).abs()
        pop_rel += int((off <= KNIFE_REL * eps2).sum())
        scale = sq[r][:, None] + sq[None, :]
        pop_knife += int((off <= (KNIFE_ULPS * U32 * scale)
                          .clamp_min(KNIFE_REL * eps2)).sum())
        del wb, plain, off, scale
    print(f"[4] {SAMPLE} sampled rows vs float64 over all {N} points: "
          f"{mism} pairs differ, all inside the fp32 band "
          f"(|d²-eps²| <= (|x|²+|y|²+eps²)·1e-5, {band_pairs} pairs in it); "
          f"{knife_mism} of them within |d-eps| <= 1e-5·eps, "
          f"{mism - knife_mism} outside that")
    print(f"[4] the same rows against the plain fp32 expansion on the card "
          f"(knife-edge pairs: {pop_rel} within 1e-4·eps², {pop_knife} "
          f"within the knife):")
    knife_check("[4] graph vs plain fp32", P, P, torch.cat(wit_i),
                torch.cat(wit_j), eps2)
    del P64, sq, d2, dist, truth, got, differ, band

    # -- 5. times at the main path's shapes ----------------------------------
    n_loc = N // NRANKS
    k_path = int(g.meta["plan"])
    x = P[:n_loc].contiguous()
    y = P[n_loc:2 * n_loc].contiguous()
    del P, g
    ones = torch.ones(n_loc, dtype=torch.int32, device=dev)
    tile_ms = cuda_ms(torch, lambda: nng_tile_cuda(x, y, ones, EPS), 5)
    cnt, bits = nng_tile_cuda(x, y, ones, EPS)
    w = bits.shape[1]
    b2c_ms = cuda_ms(torch, lambda: bits_to_cols_cuda(bits, k_path), 10)
    cols = bits_to_cols_cuda(bits, k_path)

    # the plain versions run in row chunks: the whole tile's temporaries
    # (a 64 GiB d² for nng_tile) do not fit on the card
    def tile_plain():
        for r0 in range(0, n_loc, 8192):
            nng_tile_ref(x[r0:r0 + 8192], y, ones, EPS)
    tile_plain_ms = cuda_ms(torch, tile_plain, 3)

    def b2c_plain():
        for r0 in range(0, n_loc, 4096):
            bits_to_cols_ref(bits[r0:r0 + 4096], k_path)
    b2c_plain_ms = cuda_ms(torch, b2c_plain, 3)

    # each kernel's output on the main path's inputs against its plain
    # version's, chunk by chunk; the float64 d² counts the knife edge
    x64, y64 = x.double(), y.double()
    xn64, yn64 = (x64 * x64).sum(1), (y64 * y64).sum(1)
    tile_i, tile_j = [], []
    pop_rel = pop_knife = 0
    for r0 in range(0, n_loc, 8192):
        sl = slice(r0, r0 + 8192)
        cnt_p, bits_p = nng_tile_ref(x[sl], y, ones, EPS)
        check(torch.equal(cnt[sl], unpack_words(bits[sl]).sum(
            1, dtype=torch.int32)), "nng_tile: cnt is not the popcount of "
                                    "bits on the main path's tile")
        tile_err = max(tile_err, int((cnt[sl] - cnt_p).abs().max()))
        i, j = differing_pairs(bits[sl], bits_p)
        tile_i.append(i + r0)
        tile_j.append(j)
        d2 = x64[sl] @ y64.T
        d2.mul_(-2).add_(xn64[sl, None]).add_(yn64[None, :]).sub_(eps2).abs_()
        pop_rel += int((d2 <= KNIFE_REL * eps2).sum())
        knife = (xn64[sl, None] + yn64[None, :]).mul_(KNIFE_ULPS * U32)
        pop_knife += int((d2 <= knife.clamp_min_(KNIFE_REL * eps2)).sum())
        del cnt_p, bits_p, d2, knife
    print(f"[5] nng_tile on the main path's tile against its plain version "
          f"(knife-edge pairs: {pop_rel} within 1e-4·eps², {pop_knife} "
          f"within the knife):")
    knife_check("[5] nng_tile vs plain", x, y, torch.cat(tile_i),
                torch.cat(tile_j), eps2)
    del x64, y64
    for r0 in range(0, n_loc, 4096):
        check(torch.equal(cols[r0:r0 + 4096],
                          bits_to_cols_ref(bits[r0:r0 + 4096], k_path)),
              f"bits_to_cols differs from its plain version on the main "
              f"path's tile at k={k_path} (rows {r0}..{r0 + 4095})")
    print(f"[5] bits_to_cols bit-identical to its plain version on the main "
          f"path's tile ({n_loc}x{w} words, k={k_path})")

    # bits_to_cols stops a row at the word holding its k-th set bit
    words_read = 0
    for r0 in range(0, n_loc, 2048):
        cum = unpack_words(bits[r0:r0 + 2048]).view(-1, w, 32).sum(-1).cumsum(1)
        full = cum[:, -1] < k_path
        first = (cum < k_path).sum(1) + 1
        words_read += int(torch.where(full, w, first).sum())
    b2c_bytes = 4 * words_read + 4 * n_loc * k_path
    b2c_bound = b2c_bytes / PEAK_BYTES * 1e3

    tile_flops = (2 * n_loc * n_loc * DIM + 2 * 2 * n_loc * DIM
                  + 3 * n_loc * n_loc)
    tile_bytes = 4 * 2 * n_loc * DIM + 4 * n_loc * 2 + 4 * n_loc * w
    tile_bound_ops = tile_flops / PEAK_FP32 * 1e3
    tile_bound_bytes = tile_bytes / PEAK_BYTES * 1e3
    del cnt, bits, cols
    torch.cuda.empty_cache()
    # yardstick, product only: the same fp32 product by one torch.mm call
    # (a 64 GiB output); the port never calls it
    lib_ms = cuda_ms(torch, lambda: torch.mm(x, y.T), 3)
    torch.cuda.empty_cache()

    print(f"[5] nng_tile ({n_loc}x{n_loc}x{DIM}): {tile_ms:.3f} ms median; "
          f"bound {max(tile_bound_ops, tile_bound_bytes):.3f} ms "
          f"(operations: {tile_flops:.4g} fp32 flops at {PEAK_FP32 / 1e12:g} "
          f"TFLOP/s = {tile_bound_ops:.3f} ms; bytes {tile_bytes} at "
          f"{PEAK_BYTES / 1e12:g} TB/s = {tile_bound_bytes:.3f} ms); "
          f"{tile_flops / tile_ms / 1e9:.2f} TFLOP/s achieved; plain version "
          f"{tile_plain_ms:.3f} ms ({n_loc // 8192} row chunks); torch.mm "
          f"product only "
          f"{lib_ms:.3f} ms; launches on the path {launches['nng_tile']}")
    print(f"[5] bits_to_cols ({n_loc}x{w} words, k={k_path}): {b2c_ms:.3f} ms "
          f"median; bound {b2c_bound:.3f} ms (bytes: {b2c_bytes} at "
          f"{PEAK_BYTES / 1e12:g} TB/s); plain version {b2c_plain_ms:.3f} ms "
          f"({n_loc // 4096} row chunks); launches on the path "
          f"{launches['bits_to_cols']}")
    print(f"[5] script wall {time.perf_counter() - t_start:.1f} s")

    record = {"kernels": [
        {"name": "nng_tile", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/nng_tile.cu",
         "replaces": "src/repro/kernels/nng_tile.py:139",
         "launches": launches["nng_tile"], "max_abs_err": tile_err,
         "ms": tile_ms, "plain_ms": tile_plain_ms,
         "bound_ms": max(tile_bound_ops, tile_bound_bytes),
         "bound_by": ("operations" if tile_bound_ops >= tile_bound_bytes
                      else "bytes"),
         "library_ms": lib_ms},
        {"name": "bits_to_cols", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/bits_to_cols.cu",
         "replaces": "src/repro/kernels/bits_epilogue.py:109",
         "launches": launches["bits_to_cols"], "max_abs_err": b2c_err,
         "ms": b2c_ms, "plain_ms": b2c_plain_ms, "bound_ms": b2c_bound,
         "bound_by": "bytes", "library_ms": None},
    ]}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
