#!/usr/bin/env python3
"""Variants of the port's flash decode (K6) and QSGD norm (K1) kernels on
one CUDA card: each variant is the committed source with a textual patch,
built with nvcc into ``build/variants/`` and timed beside the others in
one process, in turns (each variant, then each again in reverse order).

    python3 scripts/kernel_variants.py [--only NAME,...]

K6, at qwen3-1.7b's serving shape (q (8, 8, 2, 128) f32, cache
(8, 4096, 8, 128) bf16), at gemma3 width (4 kv heads, dh 256) and at
G = 16 (B 2, whose 33.5 MB of cache stay in the 50 MB L2 from one replayed
call to the next), prefix masks:
  final          ``csrc/flash_decode.cu`` as committed
  copy_only      the consumers wait for each stage and release it, computing
                 nothing (the copies, the epilogue and the merge)
  no_merge       the blocks write their states and stop: no ticket, no merge
  cluster_merge  the 8 blocks of a (b, kv) launched as a cluster; after a
                 cluster barrier each block merges a slice of the (G, dh)
                 elements from the 8 states, in place of the ticket
  cluster_merge_5  the same, registers capped for 5 blocks an SM
  prefetch_map   ``final`` with both tensor maps prefetched at the start
  row_bulk       the producer copies each cache row with its own
                 ``cp.async.bulk`` (one instruction a row), in place of one
                 tensor copy a tile
  stream_floor   a plain kernel reading the same K and V bytes with 16-byte
                 loads, a block for each (split, kv, b): the card's
                 streaming time for this layout
K1, at (10, 101,770), (1, 101,770) and (1, 2^24) f32:
  final          ``csrc/qsgd.cu`` as committed (one launch, the last block
                 of a row by ticket)
  two_launch     per-block partials, then a one-block-a-row finish
  partials_only  the per-block partials alone (no norm: the cost of one
                 launch that reads y once)

Also prints the serving instance's registers (ptxas) and how many of its
blocks (``final``) or clusters (``cluster_merge``) the card holds at once.
Times are device microseconds a call by CUDA-graph replay
(``chip_smoke.device_ms``); outputs of ``final``, ``cluster_merge`` and
``row_bulk`` are held against the plain version within 1e-5, K1's norms
bitwise against each other.  Prints the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

# ---- K6 patches ------------------------------------------------------------
_LOOP = "      // the scores of the group's rows for its own heads"
_RELEASE = "      __syncwarp();\n      if (lane == 0) mbar_arrive(&empty[s]);"
_TICKET = '''    __shared__ bool s_last;
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      s_last = atomicAdd(tickets + bh, 1u) == kSplits - 1;
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    const float* all = ws + bh * kSplits * L::kState;
    for (int i = tid; i < ne; i += kThreads)
      merge([&](int r, int k) { return __ldcg(all + r * L::kState + k); }, i);
    if (tid == 0) tickets[bh] = 0u;'''
_LAUNCH = '''    flash_decode_kernel<TQ, TKV, I::DH, I::GB>
        <<<dim3(kSplits, (unsigned int)KV, (unsigned int)B), kThreads,
           L::kSmem, st>>>(tmk, tmv, static_cast<const TQ*>(q), valid, KV, G,
                           C, per, ws, tickets, static_cast<TQ*>(out));'''
_CLUSTER_LAUNCH = '''    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kSplits, (unsigned int)KV, (unsigned int)B);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = L::kSmem;
    cfg.stream = st;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = kSplits;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    cudaLaunchKernelEx(&cfg, flash_decode_kernel<TQ, TKV, I::DH, I::GB>, tmk,
                       tmv, static_cast<const TQ*>(q), valid, KV, G, C, per,
                       ws, tickets, static_cast<TQ*>(out));'''
_CLUSTER_MERGE = '''    cooperative_groups::this_cluster().sync();
    const float* all = ws + bh * kSplits * L::kState;
    const int slice = (ne + kSplits - 1) / kSplits;
    const int end = min(ne, (rank + 1) * slice);
    for (int i = rank * slice + tid; i < end; i += kThreads)
      merge([&](int r, int k) { return __ldcg(all + r * L::kState + k); }, i);'''
_TMA = '''        tma_load_4d(kt, &tmk, h, c0, b, &full[s]);
        tma_load_4d(kt + T * L::kRow, &tmv, h, c0, b, &full[s]);'''
_ROWS = '''        for (int r = 0; r < 2 * T; ++r) {
          const TKV* src = (r < T ? kg : vg) +
                           (((long long)b * C + c0 + r % T) * KV + h) * DH;
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
              "::bytes [%0], [%1], %2, [%3];\\n"
              :: "r"(smem_addr(kt + r * L::kRow)), "l"(src), "r"(L::kRow),
                 "r"(smem_addr(&full[s])) : "memory");
        }'''
# how many clusters of the serving instance the card holds at once
_CLUSTERS = """int k6_serving_clusters(int* n) {
  using L = Geo<float, __nv_bfloat16, 128, 2>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kSplits, 8, 8);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L::kSmem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kSplits;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(
      n, flash_decode_kernel<float, __nv_bfloat16, 128, 2>, &cfg);
}

"""
K6 = {
    "final": [],
    "copy_only": [(_LOOP, "#if 0\n" + _LOOP), (_RELEASE, "#endif\n" + _RELEASE)],
    "no_merge": [(_TICKET, "    return;")],
    "cluster_merge": [("#include <cuda.h>", "#include <cooperative_groups.h>\n#include <cuda.h>"),
                      (_TICKET, _CLUSTER_MERGE), (_LAUNCH, _CLUSTER_LAUNCH),
                      ('}  // extern "C"', _CLUSTERS + '}  // extern "C"')],
    "cluster_merge_5": [("#include <cuda.h>", "#include <cooperative_groups.h>\n#include <cuda.h>"),
                        (_TICKET, _CLUSTER_MERGE), (_LAUNCH, _CLUSTER_LAUNCH),
                        ("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 5)")],
    "prefetch_map": [("  if (tid == 0) {\n    for (int s = 0; s < kStages; ++s) {",
                      '  if (tid == kConsumers) {\n    asm volatile("prefetch.tensormap [%0];" :: "l"(reinterpret_cast<uint64_t>(&tmk)) : "memory");\n    asm volatile("prefetch.tensormap [%0];" :: "l"(reinterpret_cast<uint64_t>(&tmv)) : "memory");\n  }\n  if (tid == 0) {\n    for (int s = 0; s < kStages; ++s) {')],
    "row_bulk": [(_TMA, _ROWS),
                 ("                    const TQ* __restrict__ q,\n",
                  "                    const TQ* __restrict__ q, const TKV* kg, const TKV* vg,\n"),
                 ("tmv, static_cast<const TQ*>(q), valid,",
                  "tmv, static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v), valid,")],
}
_STREAM = r'''
#include <cuda_runtime.h>
#include <stdint.h>
// grid (S, KV, B): block (s, h, b) reads positions [s per, (s + 1) per) of
// kv head h of batch row b, rows of `vecs` 16-byte vectors of K and of V,
// 16 lanes a row, four rows a thread in flight
__global__ void rows_kernel(const uint4* k, const uint4* v, int KV, long long C,
                            long long per, int vecs, float* sink) {
  float acc = 0.f;
  const int lane16 = threadIdx.x & 15, rows_step = blockDim.x >> 4;
  const long long lo = blockIdx.x * per, hi = min(C, lo + per);
  const long long base = ((long long)blockIdx.z * C * KV + blockIdx.y) * vecs + lane16;
  for (long long c = lo + (threadIdx.x >> 4); c < hi; c += rows_step * 4) {
    for (int x = 0; x < vecs; x += 16) {
      uint4 a[4], b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long cc = c + j * rows_step;
        a[j] = cc < hi ? k[base + cc * KV * vecs + x] : make_uint4(0, 0, 0, 0);
        b[j] = cc < hi ? v[base + cc * KV * vecs + x] : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc += __uint_as_float(a[j].x ^ b[j].y) + __uint_as_float(a[j].z ^ b[j].w);
    }
  }
  if (acc == 1.2345f) sink[0] = acc;
}
extern "C" int stream_rows(const void* k, const void* v, int B, int KV, long long C,
                           int vecs, float* sink, cudaStream_t st) {
  rows_kernel<<<dim3(8, KV, B), 256, 0, st>>>((const uint4*)k, (const uint4*)v, KV, C,
                                               (C + 7) / 8, vecs, sink);
  return (int)cudaGetLastError();
}
'''
# ---- K1 patch ----------------------------------------------------------------
_K1_LAUNCH = '''  sumsq_kernel<<<grid, kThreads, 0, st>>>(y, n, s, partials, tickets, ss,
                                          norm, inv);'''
_K1_TWO = '''  sumsq_partial2<<<grid, kThreads, 0, st>>>(y, n, partials);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sumsq_finish2<<<(unsigned int)rows, kThreads, 0, st>>>(partials, P, s, ss,
                                                        norm, inv);'''
_K1_KERNELS = '''__global__ void __launch_bounds__(kThreads)
sumsq_partial2(const float* __restrict__ y, long long n,
               float* __restrict__ partials) {
  const float v = block_sumsq(y, n);
  if (threadIdx.x == 0) partials[(long long)blockIdx.y * gridDim.x + blockIdx.x] = v;
}
__global__ void __launch_bounds__(kThreads)
sumsq_finish2(const float* __restrict__ partials, int P, float s,
              float* __restrict__ ss, float* __restrict__ norm,
              float* __restrict__ inv) {
  const float tot = sum_partials(partials + (long long)blockIdx.x * P, P);
  if (threadIdx.x == 0) {
    ss[blockIdx.x] = tot;
    inv[blockIdx.x] = inv_scale(tot, s, norm + blockIdx.x);
  }
}

// K2: grid (X, rows).'''
K1 = {"final": [], "two_launch": [("// K2: grid (X, rows).", _K1_KERNELS),
                                  (_K1_LAUNCH, _K1_TWO)],
      "partials_only": [("// K2: grid (X, rows).", _K1_KERNELS),
                        (_K1_LAUNCH, "  sumsq_partial2<<<grid, kThreads, 0, st>>>(y, n, partials);")]}


def _patched(src: str, patches) -> str:
    for old, new in patches:
        if old not in src:
            raise SystemExit(f"patch does not apply: {old[:60]!r}")
        src = src.replace(old, new, 1)
    return src


def _build(job):
    """(name, source text) -> path of the built library."""
    from repro_torch.kernels import build
    name, text = job
    out_dir = os.path.join(build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, f"{name}.cu")
    with open(cu, "w") as f:
        f.write(text)
    so = os.path.join(out_dir, f"lib{name}.so")
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                           build.CSRC_DIR, "-o", so, cu],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {name}:\n{proc.stderr[-4000:]}")
    return so, proc.stdout + proc.stderr


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="", help="comma-separated variants")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants.py: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as S
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import qsgd as K
    only = set(filter(None, args.only.split(",")))
    pick = (lambda n: not only or n in only)
    src6 = open(os.path.join(build.CSRC_DIR, "flash_decode.cu")).read()
    src1 = open(os.path.join(build.CSRC_DIR, "qsgd.cu")).read()
    jobs = [(f"k6_{n}", _patched(src6, p)) for n, p in K6.items() if pick(n)]
    jobs += [(f"k1_{n}", _patched(src1, p)) for n, p in K1.items() if pick(n)]
    if pick("stream_floor"):
        jobs.append(("stream_floor", _STREAM))
    with ThreadPoolExecutor(len(jobs)) as ex:
        built = dict(zip([name for name, _ in jobs], ex.map(_build, jobs)))
    libs = {name: ctypes.CDLL(so) for name, (so, _) in built.items()}
    ptr, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    stream = (lambda: torch.cuda.current_stream().cuda_stream)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)

    k6 = [n for n in libs if n.startswith("k6_")]
    for fn in (libs[n].flash_decode for n in k6):
        fn.argtypes = [ptr] * 4 + [i32] * 4 + [ll, ll, i32, i32] + [ptr, ll, ptr, ll, ptr, ptr]
        fn.restype = i32
    # the serving instance's registers (ptxas) and the blocks, or clusters
    # of 8, the card holds at once: 64 clusters of 8 blocks to place
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    for n in ("k6_final", "k6_cluster_merge"):
        if n not in built:
            continue
        func, regs = "", None
        for line in built[n][1].splitlines():
            if "Function properties for" in line:
                func = line
            elif "Li128ELi2E" in func and "IfN" not in func and \
                    "kernelIf13__nv_bfloat16" in func and "Used" in line:
                regs = line.split("Used", 1)[1].split("registers")[0].strip()
        held = ctypes.c_int(0)
        if n == "k6_final":
            q_ = libs[n].flash_decode_blocks_per_sm
            q_.argtypes = [i32] * 4 + [ptr]
            err = q_(2, 128, 0, 1, ctypes.byref(held))
            what = f"{held.value} blocks an SM, {held.value * sm} at once"
        else:
            err = libs[n].k6_serving_clusters(ctypes.byref(held))
            what = f"{held.value} clusters of 8 at once"
        if err:
            raise RuntimeError(f"{n}: occupancy query failed ({err})")
        print(f"[k6] serving instance of {n}: {regs} registers, {what}; the "
              f"shape launches 512 blocks in 64 clusters of 8", flush=True)
    shapes = {"serving": (8, 4096, 8, 2, 128), "gemma3 width": (8, 4096, 4, 2, 256),
              "G=16": (2, 4096, 8, 16, 128)}
    for shape, (B, C, KV, G, dh) in shapes.items():
        q, k, v, valid = S.k6_inputs(B, C, KV, G, dh, "f32", "bf16", "prefix",
                                     dev, gen)
        valid = valid.contiguous()
        ref = FD.flash_decode_plain(q, k, v, valid)
        per = FD.split_ranges(C, FD.stage_positions(dh, 2))[0]
        gb = 1 << (G - 1).bit_length()
        ws = torch.empty(B * KV * FD.SPLITS * (2 * gb + gb * dh), device=dev)
        tickets = torch.zeros(B * KV, dtype=torch.int32, device=dev)
        out = torch.empty_like(q)
        calls = {}
        for n in k6:
            fn = libs[n].flash_decode
            calls[n] = (lambda fn=fn: fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), B,
                KV, G, dh, C, per, 0, 1, ws.data_ptr(), ws.numel(),
                tickets.data_ptr(), tickets.numel(), out.data_ptr(), stream()))
        if "stream_floor" in libs:
            sf = libs["stream_floor"].stream_rows
            sf.argtypes = [ptr, ptr, i32, i32, ll, i32, ptr, ptr]
            sink = torch.zeros(1, device=dev)
            calls["stream_floor"] = (lambda: sf(k.data_ptr(), v.data_ptr(), B,
                                                KV, C, dh * 2 // 16,
                                                sink.data_ptr(), stream()))
        times = {n: [] for n in calls}
        for n in list(calls) + list(calls)[::-1]:
            if calls[n]() != 0:
                raise RuntimeError(f"{n} {shape}: launch failed")
            torch.cuda.synchronize()
            if n in ("k6_final", "k6_cluster_merge", "k6_row_bulk") and not times[n]:
                torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
            times[n].append(S.device_ms(calls[n]) * 1e3)
        for n, ts in times.items():
            print(f"[k6] {shape:13s} {n:17s} " + "  ".join(f"{t:7.2f} us" for t in ts),
                  flush=True)

    k1 = [n for n in libs if n.startswith("k1_")]
    tickets = torch.zeros(65535, dtype=torch.int32, device=dev)
    for fn in (libs[n].qsgd_sumsq for n in k1):
        fn.argtypes = [ptr, ll, ll, i32, ctypes.c_float] + [ptr] * 6
        fn.restype = i32
    for rows, n in ((10, S.MAIN_D), (1, S.MAIN_D), (1, S.STREAM_N)):
        y = torch.randn(rows, n, generator=gen, device=dev)
        P = K.sumsq_blocks(n)
        part = torch.empty(rows * P, device=dev)
        res = {name: [torch.empty(rows, device=dev) for _ in range(3)] for name in k1}
        calls = {name: (lambda fn=libs[name].qsgd_sumsq, r=res[name]: fn(
            y.data_ptr(), rows, n, P, 16384.0, part.data_ptr(), tickets.data_ptr(),
            r[0].data_ptr(), r[1].data_ptr(), r[2].data_ptr(), stream()))
            for name in k1}
        times = {name: [] for name in k1}
        for name in k1 + k1[::-1]:
            if calls[name]() != 0:
                raise RuntimeError(f"{name}: launch failed")
            times[name].append(S.device_ms(calls[name]) * 1e3)
        torch.cuda.synchronize()
        norms = [res[name][1].view(torch.int32) for name in k1
                 if name != "k1_partials_only"]
        same = all(torch.equal(norms[0], x) for x in norms[1:])
        for name, ts in times.items():
            print(f"[k1] rows={rows} n={n} {name:13s} " +
                  "  ".join(f"{t:6.2f} us" for t in ts) +
                  ("" if same else "  (norms differ)"), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
