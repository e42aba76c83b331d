#!/usr/bin/env python3
"""Variants of the port's flash decode (K6), QSGD norm (K1), dequant-apply
(K3), payload encode (K4), rotate-encode (K5) and Elias-omega decode
(elias_decode) kernels on one CUDA card:
each variant is the committed source with a textual patch, or an earlier
design carried here as source text, built with nvcc into
``build/variants/`` and timed beside the others in one process, in turns
(each variant, then each again in reverse order).

    python3 scripts/kernel_variants.py [--kernels k1,k3,k4,k5,k6,elias] [--only NAME,...]

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

K3, at (101,770,) int32 levels (the server apply; also row 1 of a
(10, 101,770) level matrix, K3's scalar branch) and at (2^24,):
  final          ``csrc/qsgd.cu`` as committed (one wave of 16-byte loads)
  prior_k3       the design it replaces: a grid-stride loop of scalar loads
                 over 100 blocks of 256 threads at D
  launch_floor   ``final`` with an empty kernel body, at the same grid
  wave_loop      ``final`` on one wave of the card (the occupancy query's
                 blocks) with a grid-stride loop of 4 vectors a trip
K4, at (10, 101,770), (10, 2^17), (1, 2^18), (1, 2^19), (1, 2^20) and
(1, 2^22) f32 -> int4 (s = 7) and (1, 2^22) -> int8 (s = 127):
  final          ``csrc/fused_encode.cu`` as committed, on the route the
                 wrapper takes (one cooperative launch where the grid fits
                 the card at once, else two launches)
  one_launch, two_launch  ``final`` forced onto its one-launch route (where
                 the grid fits the card at once) or its two-launch route
                 (K1's partials, then a quantize: of coordinate pairs for
                 packed rows, of 16-byte loads for unpacked ones)
  two_launch_vec the two-launch route with the 16-byte quantize for packed
                 rows too
  prior_k4       the design it replaces: K1's partials, then a grid-stride
                 quantize of 4-byte loads reading y again
  no_coop        the one launch without the cooperative attribute (a plain
                 launch of the same grid)
  launch_floor   ``final``'s one launch with an empty kernel body, at the
                 same grid, cooperative
  warp_poll      the one launch with warp 0 alone reading the row's slots,
                 each lane in turn, and summing them in sum_partials' order
                 with shuffles (one block barrier fewer)
  counter_barrier  the one launch with the exchange it replaced: a counter
                 per row (fence, count, wait, fence), then the partials read
                 again
  quant_slots_2, quant_slots_4  ``two_launch_vec`` with 2 or 4 vectors a
                 thread a trip (1)
  quant_wide     ``two_launch_vec`` on up to 4,096 blocks a row (one wave
                 of the card)
  poll_backoff   ``final`` with a 64 ns sleep between two reads of a slot
  Then, in a child process, ``no_coop`` at a grid the card cannot hold at
  once ((1, 2^22): 1,024 blocks) must fail within seconds: the row
  barrier's wait traps after 4 s instead of hanging the card.
K5, at (1, 2^15) and (10, 2^15) f32 -> int4 (s = 7):
  final          ``csrc/fused_encode.cu`` as committed (a cluster of 8
                 blocks a message, distributed shared memory)
  prior_k5       the design it replaces: one block of 1,024 threads a
                 message, the whole message in one SM's shared memory
  launch_floor   ``final`` with an empty kernel body, at the same cluster
                 shape
  no_exchange    ``final`` with its cluster barriers made block barriers
                 and its stores into the peers' shared memory made local:
                 the local stages alone (wrong results, timed only)
  pull           ``final`` with the exchange pulled: the chunk's last stage
                 in place, each thread loading its columns from the peers'
                 shared memory and every block the peers' partials, and a
                 third cluster barrier before any block may exit
elias_decode, on QSGD streams at (101,770,) s in {7, 127} and
(10, 101,770) s = 127 (each variant bitwise the input levels but
launch_floor's), each also by kernel under torch.profiler:
  final          ``csrc/elias.cu`` as committed (three launches)
  launch_floor   ``final`` with the three kernels' bodies empty, at the
                 same grids
  no_extent      ``final`` with every word counted nonzero: the whole
                 capacity walked, no closed-form tail
  c64, c256      64- or 256-bit chunks (the window stays 50 bits)
  s16            16 chunks a segment (800 threads a table block)
  timeline       ``final`` with ``clock64`` read at a table block's
                 barriers and around a decode thread's walk, printed in SM
                 clocks (with the walks and triples of that block)
  prior          the design it replaced: one block a row, whose thread 0
                 walks the stream

Also prints the serving instance's registers (ptxas) and how many of its
blocks (``final``) or clusters (``cluster_merge``) the card holds at once.
Times are device microseconds a call by CUDA-graph replay
(``chip_smoke.device_ms``); outputs of ``final``, ``cluster_merge`` and
``row_bulk`` are held against the plain version within 1e-5, K1's norms
bitwise against each other, K3's ``final`` and ``prior_k3`` outputs bitwise
against each other, K4's payloads and norms of every variant but
``launch_floor`` bitwise against each other, K5's ``final`` and
``prior_k5`` rotations bitwise against each other (their norms sum in
other orders: the relative norm difference and the payload bytes that
differ are printed).  Prints the card's name and power limit.
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

# ---- K3 ------------------------------------------------------------------------
# the K3 the one-wave kernel replaces, as it was committed
_PRIOR_K3 = r"""
#include "qsgd_common.cuh"
namespace {
template <typename T>
__global__ void __launch_bounds__(kThreads)
dequant_apply_kernel(const float* __restrict__ x, const T* __restrict__ lvl,
                     const float* __restrict__ norm, float s, float gamma,
                     long long n, float* __restrict__ out) {
  const float scale = norm[0] / s;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float l = static_cast<float>(lvl[i]);
    out[i] = __fadd_rn(x[i], __fmul_rn(__fmul_rn(gamma, l), scale));
  }
}
}  // namespace
extern "C" int qsgd_dequant_apply_i32(const float* x, const int32_t* lvl,
                                      const float* norm, float s, float gamma,
                                      long long n, float* out,
                                      cudaStream_t st) {
  const unsigned int grid = grid_x(n, 4LL * kThreads, 8192u);
  dequant_apply_kernel<int32_t><<<grid, kThreads, 0, st>>>(x, lvl, norm, s,
                                                           gamma, n, out);
  return (int)cudaGetLastError();
}
"""
_K3_BODY = "  using V = typename Lvl4<T>::V;\n  const float nrm = norm[0];"
_K3_LOOP = """  for (long long i = tid; i < nvec; i += stride) {
    const float4 a = xv[i];
    const V b = lv[i];
    const float scale = late_scale(nrm, s);
    ov[i] = make_float4(apply1(a.x, (float)b.x, gamma, scale),
                        apply1(a.y, (float)b.y, gamma, scale),
                        apply1(a.z, (float)b.z, gamma, scale),
                        apply1(a.w, (float)b.w, gamma, scale));
  }"""
_K3_WAVE_LOOP = """  for (long long i0 = tid; i0 < nvec; i0 += 4 * stride) {
    float4 a[4];
    V b[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (i0 + k * stride < nvec) {
        a[k] = xv[i0 + k * stride];
        b[k] = lv[i0 + k * stride];
      }
    const float scale = late_scale(nrm, s);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (i0 + k * stride < nvec)
        ov[i0 + k * stride] =
            make_float4(apply1(a[k].x, (float)b[k].x, gamma, scale),
                        apply1(a[k].y, (float)b[k].y, gamma, scale),
                        apply1(a[k].z, (float)b[k].z, gamma, scale),
                        apply1(a[k].w, (float)b[k].w, gamma, scale));
  }"""
_K3_GRID = "  const unsigned int grid = grid_x((n + 3) >> 2, kApplyThreads, 0x7FFFFFFFu);"
_K3_WAVE_GRID = """  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, dequant_apply_kernel<T>, kApplyThreads, 0);
  const unsigned int grid = grid_x((n + 3) >> 2, kApplyThreads,
                                   (unsigned int)(sms * per_sm));"""
K3 = {"final": [], "launch_floor": [(_K3_BODY, "  return;\n" + _K3_BODY)],
      "wave_loop": [(_K3_LOOP, _K3_WAVE_LOOP), (_K3_GRID, _K3_WAVE_GRID)]}

# ---- K5 ------------------------------------------------------------------------
# the K5 the cluster kernel replaces, as it was committed: one block of
# 1,024 threads a message
_PRIOR_K5 = r"""
#include "qsgd_common.cuh"
namespace {
constexpr int kRotThreads = 1024;
constexpr int kDefaultSmem = 48 * 1024;
__device__ __forceinline__ int8_t pack_byte(int lo, int hi) {
  return static_cast<int8_t>(static_cast<uint8_t>((lo & 0xF) | ((hi & 0xF) << 4)));
}
__device__ __forceinline__ uint32_t mix32(uint32_t z) {
  z = (z ^ (z >> 16)) * 0x85EBCA6Bu;
  z = (z ^ (z >> 13)) * 0xC2B2AE35u;
  return z ^ (z >> 16);
}
__global__ void __launch_bounds__(kRotThreads)
rotate_encode_kernel(const float* __restrict__ ypad, const float* __restrict__ u,
                     int d, uint32_t seed, float scale, float s,
                     float* __restrict__ norm, int8_t* __restrict__ out,
                     float* __restrict__ rot) {
  extern __shared__ float x[];
  __shared__ float s_inv;
  const long long off = (long long)blockIdx.x * d;
  const float* yr = ypad + off;
  const float* ur = u + off;
  for (int i = threadIdx.x; i < d; i += kRotThreads) {
    const uint32_t z = mix32((uint32_t)i * 0x9E3779B9u + seed);
    x[i] = __fmul_rn(yr[i], (z & 1u) ? -1.f : 1.f);
  }
  for (int h = 1; h < d; h <<= 1) {
    __syncthreads();
    for (int p = threadIdx.x; p < (d >> 1); p += kRotThreads) {
      const int i0 = ((p & ~(h - 1)) << 1) | (p & (h - 1));
      const float a = x[i0], b = x[i0 + h];
      x[i0] = __fadd_rn(a, b);
      x[i0 + h] = __fsub_rn(a, b);
    }
  }
  __syncthreads();
  float acc = 0.f;
  for (int i = threadIdx.x; i < d; i += kRotThreads) {
    const float r = __fmul_rn(x[i], scale);
    x[i] = r;
    acc += r * r;
    if (rot != nullptr) rot[off + i] = r;
  }
  const float tot = block_sum<kRotThreads>(acc);
  if (threadIdx.x == 0) s_inv = inv_scale(tot, s, norm + blockIdx.x);
  __syncthreads();
  const float iv = s_inv;
  int8_t* o = out + (long long)blockIdx.x * (d >> 1);
  for (int j = threadIdx.x; j < (d >> 1); j += kRotThreads)
    o[j] = pack_byte(qsgd_level(x[2 * j], ur[2 * j], iv),
                     qsgd_level(x[2 * j + 1], ur[2 * j + 1], iv));
}
}  // namespace
// packed (int4) only, as timed here
extern "C" int fused_rotate_encode(const float* ypad, const float* u,
                                   long long rows, int d, unsigned int seed,
                                   float scale, float s, int pack, float* norm,
                                   int8_t* out, float* rot, cudaStream_t st) {
  const size_t smem = (size_t)d * sizeof(float);
  if (!pack) return (int)cudaErrorInvalidValue;
  if (smem > (size_t)kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        rotate_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
  }
  rotate_encode_kernel<<<(unsigned int)rows, kRotThreads, smem, st>>>(
      ypad, u, d, seed, scale, s, norm, out, rot);
  return (int)cudaGetLastError();
}
"""
_K5_BODY = "  using G = K5Geo<M>;\n"
_K5_PEER = "  else return cg::this_cluster().map_shared_rank(p, rank);"
_K5_SYNC = "  else cg::this_cluster().sync();"
_K5_ARRIVE = '  asm volatile("barrier.cluster.arrive.relaxed.aligned;\\n" : : : "memory");'
_K5_WAIT = '  asm volatile("barrier.cluster.wait.aligned;\\n" : : : "memory");'
# pull: the chunk's last stage in place, then each thread loads its columns
# from the peers and the partials from every block, with a third cluster
# barrier so that no block exits while a peer still reads it
_K5_PUSH = """  constexpr int kInPlace = C > 1 ? M / 2 : M;"""
_K5_PUSH_STAGE = """    for (int p = tid; p < M / 2; p += B) {
      const float a = x[p], b = x[p + M / 2];
      const int q = p + M / 2;
      peer<C>(g, p / S)[rank * S + p % S] = __fadd_rn(a, b);
      peer<C>(g, q / S)[rank * S + q % S] = __fsub_rn(a, b);
    }"""
_K5_GATHER = "      const float2 f = *reinterpret_cast<const float2*>(src + k * S + 2 * q);"
_K5_PARTS_OUT = ("#pragma unroll\n"
                 "    for (int k = 0; k < C; ++k) peer<C>(parts, k)[rank * W + (tid >> 5)] = wsum;")
_K5_PARTS_IN = "  for (int i = lane; i < C * W; i += 32) tot = __fadd_rn(tot, parts[i]);"
K5 = {"final": [], "launch_floor": [(_K5_BODY, "  return;\n" + _K5_BODY)],
      "no_exchange": [(_K5_PEER, "  else return p;"),
                      (_K5_SYNC, "  else __syncthreads();"),
                      (_K5_ARRIVE, ""), (_K5_WAIT, "")],
      "pull": [(_K5_PUSH, "  constexpr int kInPlace = M;"),
               (_K5_PUSH_STAGE, ""),
               (_K5_GATHER, "      const float2 f = *reinterpret_cast<const float2*>(peer<C>(x, k) + col0 + 2 * q);"),
               (_K5_PARTS_OUT, "    parts[tid >> 5] = wsum;"),
               (_K5_PARTS_IN, _K5_PARTS_IN.replace("parts[i]", "peer<C>(parts, i / W)[i % W]")
                + "\n  cluster_sync<C>();")]}

# ---- K4 ------------------------------------------------------------------------
# the K4 the one-launch kernel replaces, as it was committed: K1's partials,
# then a grid-stride quantize of scalar loads whose every block adds them
_PRIOR_K4 = r"""
#include "qsgd_common.cuh"
namespace {
__device__ __forceinline__ int8_t pack_byte(int lo, int hi) {
  return static_cast<int8_t>(static_cast<uint8_t>((lo & 0xF) | ((hi & 0xF) << 4)));
}
__global__ void __launch_bounds__(kThreads)
sumsq_partial_kernel(const float* __restrict__ y, long long n,
                     float* __restrict__ partials) {
  const float s = block_sumsq(y, n);
  if (threadIdx.x == 0) partials[(long long)blockIdx.y * gridDim.x + blockIdx.x] = s;
}
template <bool kPack>
__global__ void __launch_bounds__(kThreads)
fused_quantize_kernel(const float* __restrict__ y, const float* __restrict__ u,
                      const float* __restrict__ partials, int P, float s,
                      long long n, float* __restrict__ norm,
                      int8_t* __restrict__ out) {
  __shared__ float s_inv;
  const long long row = blockIdx.y;
  const float tot = sum_partials(partials + row * P, P);
  if (threadIdx.x == 0) {
    float nr;
    s_inv = inv_scale(tot, s, &nr);
    if (blockIdx.x == 0) norm[row] = nr;
  }
  __syncthreads();
  const float iv = s_inv;
  const float* yr = y + row * n;
  const float* ur = u + row * n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (kPack) {
    const long long m = (n + 1) >> 1;
    int8_t* o = out + row * m;
    for (long long j = first; j < m; j += stride) {
      const long long i = j << 1;
      const int lo = qsgd_level(yr[i], ur[i], iv);
      const int hi = i + 1 < n ? qsgd_level(yr[i + 1], ur[i + 1], iv) : 0;
      o[j] = pack_byte(lo, hi);
    }
  } else {
    int8_t* o = out + row * n;
    for (long long i = first; i < n; i += stride)
      o[i] = static_cast<int8_t>(qsgd_level(yr[i], ur[i], iv));
  }
}
}  // namespace
extern "C" int fused_encode(const float* y, const float* u, long long rows,
                            long long n, int P, float s, int pack,
                            float* partials, float* norm, int8_t* out,
                            cudaStream_t st) {
  sumsq_partial_kernel<<<dim3((unsigned int)P, (unsigned int)rows), kThreads,
                         0, st>>>(y, n, partials);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long items = pack ? (n + 1) >> 1 : n;
  const dim3 grid(grid_x(items, 8LL * kThreads, 2048u), (unsigned int)rows);
  if (pack)
    fused_quantize_kernel<true><<<grid, kThreads, 0, st>>>(y, u, partials, P, s,
                                                           n, norm, out);
  else
    fused_quantize_kernel<false><<<grid, kThreads, 0, st>>>(y, u, partials, P,
                                                            s, n, norm, out);
  return (int)cudaGetLastError();
}
"""
_K4_BODY = "  __shared__ float s_inv;\n  __shared__ unsigned int s_gen;"
_K4_COOP = "    cfg.numAttrs = 1;\n    const cudaError_t err = cudaLaunchKernelEx(\n        &cfg, fused_encode_kernel<kPack>"
# the one launch's exchange as committed (every thread reads the row's
# tagged slots sum_partials gives it), one warp reading them in turn, and
# the design it replaced: a counter per row (fence, count, wait, fence),
# then the partials read again
_K4_EXCHANGE = """  unsigned long long* rs = slots + row * P;
  if (threadIdx.x == 0) {
    s_gen = gen;
    store_slot(rs + blockIdx.x, part, gen);
  }
  __syncthreads();                      // s_gen; also between the block sums
  gen = s_gen;
  float acc = 0.f;
  for (unsigned int i = threadIdx.x; i < P; i += kThreads)
    acc += wait_slot(rs + i, gen);
  const float tot = block_sum<kThreads>(acc);
  if (threadIdx.x == 0) {
    float nr;
    s_inv = inv_scale(tot, s, &nr);
    if (blockIdx.x == 0) norm[row] = nr;
  }"""
_K4_WARP_POLL = """  if (threadIdx.x < 32) {
    unsigned long long* rs = slots + row * P;
    gen = __shfl_sync(0xffffffffu, gen, 0);
    if (threadIdx.x == 0) store_slot(rs + blockIdx.x, part, gen);
    // lane l adds what threads 32w + l of sum_partials add, for each warp
    // w in turn, then the warp trees as block_sum runs them
    const int lane = threadIdx.x;
    float ws[kThreads / 32];
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      float a = 0.f;
      for (unsigned int i = 32 * w + lane; i < P; i += kThreads)
        a += wait_slot(rs + i, gen);
      ws[w] = warp_sum(a);
    }
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      const float t = __shfl_sync(0xffffffffu, ws[w], 0);
      if (lane == w) v = t;
    }
    const float tot = warp_sum(v);
    if (threadIdx.x == 0) {
      float nr;
      s_inv = inv_scale(tot, s, &nr);
      if (blockIdx.x == 0) norm[row] = nr;
    }
  }"""
_K4_COUNTER = """  unsigned int* counter = reinterpret_cast<unsigned int*>(slots + 32768) + row;
  float* partials = reinterpret_cast<float*>(slots + 16384);
  if (threadIdx.x == 0) {
    partials[row * P + blockIdx.x] = part;
    __threadfence();
    atomicAdd(counter, 1u);
    uint64_t t0 = 0;
    while (load_acquire(counter) < P) {
      const uint64_t now = globaltimer();
      if (t0 == 0) t0 = now;
      else if (now - t0 > kWaitNs) __trap();
    }
    __threadfence();
  }
  __syncthreads();
  const float tot = sum_partials(partials + row * P, (int)P);
  if (threadIdx.x == 0) {
    if (atomicAdd(counter, 1u) == 2 * P - 1) atomicExch(counter, 0u);
    float nr;
    s_inv = inv_scale(tot, s, &nr);
    if (blockIdx.x == 0) norm[row] = nr;
  }"""
_K4_POLL = "    else if (now - t0 > kWaitNs) __trap();"
_K4_QSLOTS = "constexpr int kQuantSlots = 1;"
_K4_QWAVE = "(unsigned int)(per_row < 65535 ? per_row : 65535)"
# the two-launch route's 16-byte quantize for packed rows too (``final``
# takes PR 12's kernel of coordinate pairs there)
_K4_VEC = [("  if constexpr (kPack) {\n    const dim3 grid(grid_x((n + 1) >> 1",
            "  if constexpr (false) {\n    const dim3 grid(grid_x((n + 1) >> 1")]
K4 = {"final": [],
      "launch_floor": [(_K4_BODY, "  return;\n" + _K4_BODY)],
      "no_coop": [(_K4_COOP, _K4_COOP.replace("numAttrs = 1", "numAttrs = 0"))],
      "warp_poll": [(_K4_EXCHANGE, _K4_WARP_POLL)],
      "counter_barrier": [(_K4_EXCHANGE, _K4_COUNTER)],
      "poll_backoff": [(_K4_POLL, _K4_POLL + "\n    __nanosleep(64);")],
      "two_launch_vec": _K4_VEC,
      "quant_slots_2": _K4_VEC + [(_K4_QSLOTS, _K4_QSLOTS.replace("1;", "2;"))],
      "quant_slots_4": _K4_VEC + [(_K4_QSLOTS, _K4_QSLOTS.replace("1;", "4;"))],
      "quant_wide": _K4_VEC + [(_K4_QWAVE, "4096u")]}
#: K4 variants on the two-launch route, and on the one-launch route only
_K4_TWO = ("k4_two_launch", "k4_two_launch_vec", "k4_quant_slots_2",
           "k4_quant_slots_4", "k4_quant_wide")
_K4_ONE = ("k4_one_launch", "k4_launch_floor", "k4_no_coop", "k4_warp_poll",
           "k4_counter_barrier", "k4_poll_backoff")
#: K4's timed shapes (rows, n, s, pack)
K4_SHAPES = ((10, 101770, 7, True), (10, 1 << 17, 7, True),
             (1, 1 << 18, 7, True), (1, 1 << 19, 7, True),
             (1, 1 << 20, 7, True), (1, 1 << 22, 7, True),
             (1, 1 << 22, 127, False))


# ---- elias_decode ------------------------------------------------------------
#: the design the parallel decode replaces (PR 18): one block a row, whose
#: threads zero the row, then thread 0 walks the stream
_PRIOR_ELIAS = r"""
#include <cuda_runtime.h>
#include <stdint.h>
namespace {
constexpr int kThreads = 256;
struct BitReader {
  const uint32_t* __restrict__ w;
  long long cap, next;
  unsigned long long buf;
  int have;
  __device__ __forceinline__ BitReader(const uint32_t* w_, long long cap_)
      : w(w_), cap(cap_), next(0), buf(0ull), have(0) {}
  __device__ __forceinline__ unsigned int peek() {
    while (have <= 32) {
      const unsigned long long v =
          next < cap ? (unsigned long long)__ldg(w + next) : 0ull;
      buf |= v << have;
      have += 32;
      ++next;
    }
    return (unsigned int)buf;
  }
  __device__ __forceinline__ void skip(int k) {
    buf >>= k;
    have -= k;
  }
};
__device__ __forceinline__ unsigned int omega(BitReader& r) {
  unsigned int n = 1u;
  for (;;) {
    const unsigned int win = r.peek();
    if ((win & 1u) == 0u) {
      r.skip(1);
      return n;
    }
    const int ln = (int)n + 1;
    if (ln > 32) return 0u;
    const unsigned int grp = ln == 32 ? win : (win & ((1u << ln) - 1u));
    n = __brev(grp) >> (32 - ln);
    r.skip(ln);
  }
}
__global__ void __launch_bounds__(kThreads)
elias_decode_kernel(const uint32_t* __restrict__ words, long long cap,
                    long long d, int8_t* __restrict__ out) {
  const long long row = blockIdx.x;
  int8_t* o = out + row * d;
  for (long long i = threadIdx.x; i < d; i += kThreads) o[i] = 0;
  __syncthreads();
  if (threadIdx.x != 0) return;
  BitReader r(words + row * cap, cap);
  long long pos = -1;
  for (;;) {
    const unsigned int g = omega(r);
    if (g == 0u || pos + (long long)g >= d) break;
    pos += g;
    const unsigned int m = omega(r);
    const unsigned int neg = r.peek() & 1u;
    r.skip(1);
    o[pos] = (int8_t)(neg ? -(int)m : (int)m);
  }
}
}  // namespace
extern "C" int elias_prior(const uint32_t* words, long long rows,
                           long long cap, long long d, int8_t* out,
                           cudaStream_t st) {
  elias_decode_kernel<<<(unsigned int)rows, kThreads, 0, st>>>(words, cap, d,
                                                               out);
  return (int)cudaGetLastError();
}
"""
#: the first statement of each of the three kernels of csrc/elias.cu
_ELIAS_BODIES = (
    "  const long long row = blockIdx.y;\n  if ((int)blockIdx.x < nblk) {",
    "  extern __shared__ __align__(16) unsigned char smem[];    // kTableSmem",
    "  __shared__ __align__(16) uint16_t lut[1 << kLutBits];\n"
    "  __shared__ long long s_tail;")
#: a timeline of one table block (x = 3, row 0, its first segment) and of
#: decode block 2's thread 0, in SM clocks, read back by elias_dbg()
_ELIAS_TIMELINE = [
    ("__device__ const OmegaLut kOmegaLut = make_omega_lut();",
     "__device__ const OmegaLut kOmegaLut = make_omega_lut();\n"
     "__device__ long long g_dbg[32];"),
    ("  const int t = threadIdx.x;\n  const long long row = blockIdx.y;\n"
     "  const uint32_t* w = words + row * cap;\n  copy_lut(sm.lut);",
     "  const int t = threadIdx.x;\n  long long T0 = clock64(), T3 = 0, T4 = 0,"
     " T5 = 0, T6 = 0;\n  __shared__ int dbg_tri, dbg_max, dbg_items;\n"
     "  if (t == 0) dbg_tri = dbg_max = 0;\n  const long long row = blockIdx.y;\n"
     "  const uint32_t* w = words + row * cap;\n  copy_lut(sm.lut);"),
    ("  if ((long long)blockIdx.x >= nseg) return;\n  for (long long seg",
     "  long long T1 = clock64();\n"
     "  if ((long long)blockIdx.x >= nseg) return;\n"
     "  long long T2 = clock64();\n  for (long long seg"),
    ("      if (cand) sm.item[atomicAdd(&n_items, 1)] = (uint16_t)t;\n"
     "      __syncthreads();\n    }",
     "      if (cand) sm.item[atomicAdd(&n_items, 1)] = (uint16_t)t;\n"
     "      __syncthreads();\n    }\n    if (seg == blockIdx.x) { T3 = clock64();"
     " dbg_items = n_items; }"),
    ("      unsigned int la = 0u;\n      for (;;) {",
     "      unsigned int la = 0u;\n      int ntr = 0;\n      for (;;) {"),
    ("        const int how = read_triple<false>(r, sm.lut, 0u, g, m, neg);",
     "        ++ntr;\n"
     "        const int how = read_triple<false>(r, sm.lut, 0u, g, m, neg);"),
    ("      sm.rx[me] = x;",
     "      if (seg == blockIdx.x) { atomicAdd(&dbg_tri, ntr);"
     " atomicMax(&dbg_max, ntr); }\n      sm.rx[me] = x;"),
    ("      sm.link_a[me] = la;\n    }\n    __syncthreads();",
     "      sm.link_a[me] = la;\n    }\n    __syncthreads();\n"
     "    if (seg == blockIdx.x) T4 = clock64();"),
    ("      sm.ta[me] = sat32((unsigned long long)sm.stop_a[me]);\n"
     "    }\n    __syncthreads();",
     "      sm.ta[me] = sat32((unsigned long long)sm.stop_a[me]);\n"
     "    }\n    __syncthreads();\n    if (seg == blockIdx.x) T5 = clock64();"),
    ("(lo == hi ? lo : -1);\n    }\n    __syncthreads();\n  }",
     "(lo == hi ? lo : -1);\n    }\n    __syncthreads();\n"
     "    if (seg == blockIdx.x) T6 = clock64();\n  }\n"
     "  if (t == 0 && blockIdx.x == 3 && row == 0) {\n"
     "    g_dbg[0] = T1 - T0; g_dbg[1] = T2 - T1; g_dbg[2] = T3 - T2;\n"
     "    g_dbg[3] = T4 - T3; g_dbg[4] = T5 - T4; g_dbg[5] = T6 - T5;\n"
     "    g_dbg[6] = dbg_items; g_dbg[7] = dbg_tri; g_dbg[8] = dbg_max;\n"
     "    g_dbg[9] = clock64() - T0; }"),
    ("  if (!s_last) return;\n  __threadfence();\n",
     "  if (!s_last) return;\n  __threadfence();\n  long long TR = clock64();\n"),
    ("  if (t == 0) tickets[row] = 0u;\n}",
     "  if (t == 0) tickets[row] = 0u;\n"
     "  if (t == 0 && row == 0) { g_dbg[10] = clock64() - TR;"
     " g_dbg[11] = clock64() - T0; g_dbg[12] = blockIdx.x; }\n}"),
    ("  const long long stride = (long long)gridDim.x * kDecodeThreads;\n"
     "  // the first chunk's",
     "  long long D0 = clock64();\n"
     "  const long long stride = (long long)gridDim.x * kDecodeThreads;\n"
     "  // the first chunk's"),
    ("  __syncthreads();\n  if (bad) {",
     "  __syncthreads();\n  long long D1 = clock64();\n  if (bad) {"),
    ("  for (long long i = tail + c1; i < d; i += stride) o[i] = 1;\n}",
     "  if (threadIdx.x == 0 && blockIdx.x == 2 && row == 0) {"
     " g_dbg[16] = D1 - D0; g_dbg[17] = clock64() - D1; }\n"
     "  for (long long i = tail + c1; i < d; i += stride) o[i] = 1;\n}"),
    ("}  // extern \"C\"",
     "int elias_dbg(long long* out) {\n"
     "  return (int)cudaMemcpyFromSymbol(out, g_dbg, sizeof(g_dbg));\n}\n"
     "}  // extern \"C\""),
]
ELIAS = {"final": [],
         "launch_floor": [(b, "  return;\n" + b) for b in _ELIAS_BODIES],
         "no_extent": [("      if (__ldg(w + i) != 0u) last = (int)i;",
                        "      last = (int)i;")],
         "c64": [("constexpr int kChunkBits = 128;",
                  "constexpr int kChunkBits = 64;")],
         "c256": [("constexpr int kChunkBits = 128;",
                   "constexpr int kChunkBits = 256;")],
         "timeline": _ELIAS_TIMELINE,
         "s16": [("constexpr int kSegChunks = 8;",
                  "constexpr int kSegChunks = 16;")]}

#: (chunk bits, window, segment chunks) of the variants that change them
ELIAS_CONSTS = {"elias_c64": (64, 50, 8), "elias_c256": (256, 50, 8),
                "elias_s16": (128, 50, 16)}

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


def _in_turns(calls: dict) -> dict:
    """Device us a call of each variant, timed in turns (each, then each
    again in reverse order)."""
    import torch
    import chip_smoke as S
    times = {n: [] for n in calls}
    for n in list(calls) + list(calls)[::-1]:
        if calls[n]() != 0:
            raise RuntimeError(f"{n}: launch failed")
        torch.cuda.synchronize()
        times[n].append(S.device_ms(calls[n]) * 1e3)
    return times


def run_k3(libs, stream, dev, gen) -> None:
    import torch
    import chip_smoke as S
    ptr, ll, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
    k3 = [n for n in libs if n.startswith("k3_")]
    for n in k3:
        fn = libs[n].qsgd_dequant_apply_i32
        fn.argtypes = [ptr] * 3 + [f32] * 2 + [ll, ptr, ptr]
        fn.restype = ctypes.c_int
    for what, rows, n in (("(101770,)", 1, S.MAIN_D),
                          ("row 1 of (10, 101770)", 10, S.MAIN_D),
                          ("(2^24,)", 1, S.STREAM_N)):
        x = torch.randn(n, generator=gen, device=dev)
        lvl = torch.randint(-16384, 16385, (rows, n), generator=gen,
                            device=dev, dtype=torch.int32)[min(1, rows - 1)]
        norm = torch.rand(1, generator=gen, device=dev) * 100
        outs = {name: torch.empty(n, device=dev) for name in k3}
        calls = {name: (lambda fn=libs[name].qsgd_dequant_apply_i32,
                        o=outs[name]: fn(x.data_ptr(), lvl.data_ptr(),
                                         norm.data_ptr(), 16384.0, 0.05, n,
                                         o.data_ptr(), stream()))
                 for name in k3}
        times = _in_turns(calls)
        ref = [outs[m].view(torch.int32) for m in ("k3_final", "k3_prior_k3")
               if m in outs]
        same = all(torch.equal(ref[0], r) for r in ref[1:])
        if not same:
            raise AssertionError(f"K3 final and prior_k3 differ at {what}")
        for name, ts in times.items():
            print(f"[k3] {what:22s} {name:16s} " +
                  "  ".join(f"{t:6.2f} us" for t in ts) +
                  ("  (final and prior_k3 bitwise equal)"
                   if name == "k3_final" and len(ref) == 2 else ""),
                  flush=True)


def run_k5(libs, stream, dev, gen) -> None:
    import numpy as np
    import torch
    from repro_torch.kernels import fused_encode as FE
    ptr, ll, f32, i32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float,
                         ctypes.c_int)
    k5 = [n for n in libs if n.startswith("k5_")]
    for n in k5:
        fn = libs[n].fused_rotate_encode
        fn.argtypes = ([ptr, ptr, ll, i32] + ([] if n == "k5_prior_k5"
                                               else [i32]) +
                       [ctypes.c_uint, f32, f32, i32] + [ptr] * 4)
        fn.restype = i32
    d, s = 1 << 15, 7
    scale = float(np.float32(d ** -0.5))
    for rows in (1, 10):
        y = torch.randn(rows, d, generator=gen, device=dev)
        u = torch.rand(rows, d, generator=gen, device=dev)
        res = {n: (torch.empty(rows, device=dev),
                   torch.empty(rows, d // 2, dtype=torch.int8, device=dev),
                   torch.empty(rows, d, device=dev)) for n in k5}

        def call(n, rot):
            fn, (nm, out, r) = libs[n].fused_rotate_encode, res[n]
            c = () if n == "k5_prior_k5" else (FE.k5_cluster(d),)
            return fn(y.data_ptr(), u.data_ptr(), rows, d, *c, 5, scale,
                      float(s), 1, nm.data_ptr(), out.data_ptr(),
                      r.data_ptr() if rot else None, stream())
        for n in k5:                         # the rotations, for the check
            if call(n, True) != 0:
                raise RuntimeError(f"{n}: launch failed")
        torch.cuda.synchronize()
        note = ""
        if "k5_final" in res and "k5_prior_k5" in res:
            (na, pa, ra), (nb, pb, rb) = res["k5_final"], res["k5_prior_k5"]
            if not torch.equal(ra.view(torch.int32), rb.view(torch.int32)):
                raise AssertionError("K5 final and prior_k5 rotations differ")
            note = (f"  (rotations bitwise equal; norm rel diff "
                    f"{float(((na - nb).abs() / nb).max()):.3g}, "
                    f"{int((pa != pb).sum())} payload bytes differ)")
        times = _in_turns({n: (lambda n=n: call(n, False)) for n in k5})
        for n, ts in times.items():
            print(f"[k5] ({rows}, 2^15) int4 {n:16s} " +
                  "  ".join(f"{t:6.2f} us" for t in ts) +
                  (note if n == "k5_final" else ""), flush=True)


def _k4_fn(lib, prior: bool):
    ptr, ll, f32, i32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float,
                         ctypes.c_int)
    fn = lib.fused_encode
    fn.argtypes = ([ptr, ptr, ll, ll, i32, f32, i32] + ([] if prior else [i32])
                   + [ptr] * (4 if prior else 5))
    fn.restype = i32
    return fn


def run_k4(libs, built, stream, dev, gen) -> None:
    """K4's variants in turns at K4_SHAPES: ``final`` on the wrapper's
    route, ``final`` forced onto each route, ``prior_k4`` and the patched
    variants (those of the one-launch route only where the grid fits);
    the payloads and norms of all but ``launch_floor`` held bitwise
    against each other."""
    import torch
    from repro_torch.kernels import fused_encode as FE
    from repro_torch.kernels import qsgd as K
    k4 = [n for n in libs if n.startswith("k4_")]
    fns = {n: _k4_fn(libs[n], n == "k4_prior_k4") for n in k4}
    cap = ctypes.c_int(0)
    cap_fn = libs["k4_final"].fused_encode_capacity
    cap_fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    if cap_fn(ctypes.addressof(cap), None):
        raise RuntimeError("fused_encode_capacity failed")
    regs = {}
    func = ""
    for line in built["k4_final"][1].splitlines():
        if "Function properties for" in line:
            func = line.split("for", 1)[1].strip()
        elif "Used" in line and "registers" in line and "fused_" in func:
            regs[func] = line.split("Used", 1)[1].split("registers")[0].strip()
    print(f"[k4] one-launch capacity {cap.value} blocks; registers "
          f"{sorted(regs.items())}", flush=True)
    scratch = torch.zeros(65536, dtype=torch.int64, device=dev)
    for rows, n, s, pack in K4_SHAPES:
        y = torch.randn(rows, n, generator=gen, device=dev)
        u = torch.rand(rows, n, generator=gen, device=dev)
        P = K.sumsq_blocks(n)
        route = FE.k4_route(rows, n, cap.value)
        part = torch.empty(rows * P, device=dev)
        res = {}
        calls = {}
        for name in k4 + ["k4_one_launch", "k4_two_launch"]:
            lib_name = "k4_final" if name in ("k4_one_launch",
                                              "k4_two_launch") else name
            if lib_name not in fns:
                continue
            one = route == "one_launch" if name == "k4_final" else \
                name in _K4_ONE
            if name in _K4_ONE and rows * P > cap.value:
                continue                    # the grid does not fit at once
            nm = torch.empty(rows, device=dev)
            out = torch.empty(rows, (n + 1) // 2 if pack else n,
                              dtype=torch.int8, device=dev)
            res[name] = (out, nm)
            fn = fns[lib_name]
            if name == "k4_prior_k4":
                calls[name] = (lambda fn=fn, nm=nm, out=out: fn(
                    y.data_ptr(), u.data_ptr(), rows, n, P, float(s),
                    int(pack), part.data_ptr(), nm.data_ptr(),
                    out.data_ptr(), stream()))
            else:
                calls[name] = (lambda fn=fn, nm=nm, out=out, one=one: fn(
                    y.data_ptr(), u.data_ptr(), rows, n, P, float(s),
                    int(pack), int(one), part.data_ptr(),
                    scratch.data_ptr(), nm.data_ptr(), out.data_ptr(),
                    stream()))
        times = _in_turns(calls)
        torch.cuda.synchronize()
        ref = [res[m] for m in res if m != "k4_launch_floor"]
        for o, nm in ref[1:]:
            if not (torch.equal(o, ref[0][0]) and torch.equal(
                    nm.view(torch.int32), ref[0][1].view(torch.int32))):
                raise AssertionError(f"K4 variants differ at ({rows}, {n})")
        if int(scratch[:1].view(torch.int32)[1]):
            raise AssertionError("K4 left its block count nonzero")
        what = f"({rows}, {n}) {'int4' if pack else 'int8'}"
        for name, ts in times.items():
            print(f"[k4] {what:20s} {name:20s} " +
                  "  ".join(f"{t:6.2f} us" for t in ts) +
                  (f"  (route {route}, {rows} x {P} blocks; every variant "
                   f"but launch_floor bitwise equal)"
                   if name == "k4_final" else ""), flush=True)


def k4_trap() -> int:
    """Launch K4's one-launch kernel without the cooperative attribute at
    a grid the card cannot hold at once ((1, 2^22): 1,024 blocks): the
    resident blocks wait at the row barrier for blocks that cannot start,
    and must trap after 4 s with an error instead of hanging the card.
    Run in a child process (the error ends its CUDA context); exit 0 when
    the launch failed as it should."""
    import time
    import torch
    from repro_torch.kernels import build
    lib = ctypes.CDLL(os.path.join(build.BUILD_DIR, "variants",
                                   "libk4_no_coop.so"))
    fn = _k4_fn(lib, False)
    n = 1 << 22
    dev = torch.device("cuda")
    y = torch.ones(1, n, device=dev)
    part = torch.empty(1024, device=dev)
    scratch = torch.zeros(65536, dtype=torch.int64, device=dev)
    nm = torch.empty(1, device=dev)
    out = torch.empty(1, n // 2, dtype=torch.int8, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    err = fn(y.data_ptr(), y.data_ptr(), 1, n, 1024, 7.0, 1, 1,
             part.data_ptr(), scratch.data_ptr(), nm.data_ptr(),
             out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    try:
        torch.cuda.synchronize()
    except RuntimeError as e:
        print(f"[k4] non-resident one-launch grid (1,024 blocks, no "
              f"cooperative attribute): launch returned {err}, failed after "
              f"{time.perf_counter() - t0:.2f} s: {str(e).splitlines()[0]}",
              flush=True)
        return 0
    print("[k4] the non-resident grid did not fail", flush=True)
    return 1


def run_k6(libs, built, stream, dev, gen) -> None:
    import torch
    import chip_smoke as S
    from repro_torch.kernels import flash_decode as FD
    ptr, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
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


def run_k1(libs, stream, dev, gen) -> None:
    import torch
    import chip_smoke as S
    from repro_torch.kernels import qsgd as K
    ptr, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
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


def run_elias(libs, stream, dev, gen) -> None:
    """elias_decode's variants on QSGD streams at (D,) s in {7, 127} and
    (10, D) s = 127: every variant but launch_floor bitwise the input."""
    import torch
    import chip_smoke as S
    from repro_torch.compress import elias as E
    from repro_torch.compress import make_codec
    from repro_torch.kernels import elias as KE
    ptr, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    names = [n for n in libs if n.startswith("elias_")]
    bad = torch.zeros(1, dtype=torch.int64, device=dev)
    tickets = torch.zeros(65535, dtype=torch.int32, device=dev)
    for n in names:
        if n == "elias_prior":
            libs[n].elias_prior.argtypes = [ptr, ll, ll, ll, ptr, ptr]
            libs[n].elias_prior.restype = i32
        else:
            libs[n].elias_decode.argtypes = [ptr, ll, ll, ll, i32, i32, i32,
                                             ptr, ptr, ptr, ptr, ptr]
            libs[n].elias_decode.restype = i32
            libs[n].elias_decode_scratch_bytes.argtypes = [ll, ll]
            libs[n].elias_decode_scratch_bytes.restype = ll
    for shape, s in S.ELIAS_TIMED:
        y = torch.randn(*shape, generator=gen, device=dev)
        u = torch.rand(*shape, generator=gen, device=dev)
        lvl = make_codec(s).encode(y, u)[0]
        words, nbits = E.encode_levels(lvl)
        rows, cap, d = words.numel() // words.shape[-1], words.shape[-1], \
            shape[-1]
        outs = {n: torch.empty(rows, d, dtype=torch.int8, device=dev)
                for n in names}

        def call(n, o):
            lib = libs[n]
            if n == "elias_prior":
                return lib.elias_prior(words.data_ptr(), rows, cap, d,
                                       o.data_ptr(), stream())
            scratch = torch.empty(lib.elias_decode_scratch_bytes(rows, cap),
                                  dtype=torch.uint8, device=dev)
            consts = ELIAS_CONSTS.get(n, (KE.CHUNK_BITS, KE.WINDOW,
                                          KE.SEGMENT_CHUNKS))
            return lib.elias_decode(words.data_ptr(), rows, cap, d, *consts,
                                    scratch.data_ptr(), tickets.data_ptr(),
                                    bad.data_ptr(), o.data_ptr(), stream())

        calls = {n: (lambda n=n: call(n, outs[n])) for n in names}
        times = _in_turns(calls)
        same = [n for n in names if n != "elias_launch_floor"
                and torch.equal(outs[n], lvl.reshape(rows, d))]
        for n, ts in times.items():
            print(f"[elias] {str(shape):14s} s={s:<3d} {n:19s} " +
                  "  ".join(f"{t:9.2f} us" for t in ts) +
                  (f"  ({int(nbits.sum()) // rows} stream bits a row)"
                   if n == "elias_final" else ""), flush=True)
        from torch.profiler import ProfilerActivity, profile
        for n in names:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    calls[n]()
                torch.cuda.synchronize()
            ev = [e for e in prof.key_averages()
                  if str(getattr(e, "device_type", "")).endswith("CUDA")
                  and e.self_device_time_total > 0]
            if n == "elias_timeline":
                buf = (ctypes.c_longlong * 32)()
                libs[n].elias_dbg(buf)
                print(f"[elias]   timeline (SM clocks): table block 3 "
                      f"table copy and block_max {buf[0]}, {buf[1]}, "
                      f"candidates "
                      f"{buf[2]}, walks {buf[3]}, links {buf[4]}, chase "
                      f"{buf[5]}, {buf[6]} walks, {buf[7]} triples, longest"
                      f" {buf[8]}, block {buf[9]}; last block {buf[12]}: "
                      f"resolve {buf[10]}, block {buf[11]}; decode block 2"
                      f" thread 0: loads+lut {buf[16]}, walk {buf[17]}",
                      flush=True)
            print(f"[elias]   {n:19s} by kernel (profiler, eager): " +
                  ", ".join(f"{S.demangle(e.key)} "
                            f"{e.self_device_time_total / 5:.2f} us"
                            for e in ev), flush=True)
        want = [n for n in names if n != "elias_launch_floor"]
        if same != want:
            raise AssertionError(f"elias variants differ from the input at "
                                 f"{shape} s={s}: only {same} equal")
    if int(bad.item()):
        raise AssertionError("an elias variant took the sequential walk")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", default="k1,k3,k4,k5,k6,elias",
                    help="comma-separated kernel groups")
    ap.add_argument("--only", default="", help="comma-separated variants")
    ap.add_argument("--k4-trap", action="store_true",
                    help="(child process) the non-resident K4 launch")
    args = ap.parse_args()
    if args.k4_trap:
        return k4_trap()
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants.py: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    groups = set(filter(None, args.kernels.split(",")))
    only = set(filter(None, args.only.split(",")))
    pick = (lambda n: not only or n in only)
    src = {name: open(os.path.join(build.CSRC_DIR, f"{name}.cu")).read()
           for name in ("flash_decode", "qsgd", "fused_encode", "elias")}
    jobs = []
    if "k6" in groups:
        jobs += [(f"k6_{n}", _patched(src["flash_decode"], p))
                 for n, p in K6.items() if pick(n)]
        if pick("stream_floor"):
            jobs.append(("stream_floor", _STREAM))
    if "k1" in groups:
        jobs += [(f"k1_{n}", _patched(src["qsgd"], p))
                 for n, p in K1.items() if pick(n)]
    if "k3" in groups:
        jobs += [(f"k3_{n}", _patched(src["qsgd"], p))
                 for n, p in K3.items() if pick(n)]
        if pick("prior_k3"):
            jobs.append(("k3_prior_k3", _PRIOR_K3))
    if "k5" in groups:
        jobs += [(f"k5_{n}", _patched(src["fused_encode"], p))
                 for n, p in K5.items() if pick(n)]
        if pick("prior_k5"):
            jobs.append(("k5_prior_k5", _PRIOR_K5))
    if "k4" in groups:
        jobs += [(f"k4_{n}", _patched(src["fused_encode"], p))
                 for n, p in K4.items() if pick(n) or n == "final"]
        if pick("prior_k4"):
            jobs.append(("k4_prior_k4", _PRIOR_K4))
    if "elias" in groups:
        jobs += [(f"elias_{n}", _patched(src["elias"], p))
                 for n, p in ELIAS.items() if pick(n)]
        if pick("prior"):
            jobs.append(("elias_prior", _PRIOR_ELIAS))
    with ThreadPoolExecutor(len(jobs)) as ex:
        built = dict(zip([name for name, _ in jobs], ex.map(_build, jobs)))
    libs = {name: ctypes.CDLL(so) for name, (so, _) in built.items()}
    stream = (lambda: torch.cuda.current_stream().cuda_stream)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)
    if "k6" in groups:
        run_k6(libs, built, stream, dev, gen)
    if "k1" in groups:
        run_k1(libs, stream, dev, gen)
    if "k3" in groups:
        run_k3(libs, stream, dev, gen)
    if "k5" in groups:
        run_k5(libs, stream, dev, gen)
    if "elias" in groups:
        run_elias(libs, stream, dev, gen)
    if "k4" in groups:
        run_k4(libs, built, stream, dev, gen)
        if "k4_no_coop" in libs:
            proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                                   "--k4-trap"], capture_output=True,
                                  text=True, timeout=120)
            print(proc.stdout.strip(), flush=True)
            if proc.returncode:
                raise SystemExit(f"the K4 trap check failed:\n"
                                 f"{proc.stderr[-2000:]}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
