// One-pass QSGD encodes for Hopper (sm_90a): norm + quantize (+ int4 pack)
// with no int8 level round trip through device memory (K4), and the same
// with the randomized-Hadamard rotation folded in (K5).  Plain C entry
// points, loaded with ctypes by repro_torch/kernels/build.py; the Python
// wrappers and the plain PyTorch version of each kernel live in
// repro_torch/kernels/fused_encode.py.
//
// Replaces (JAX package, src/repro/kernels/qsgd.py):
//   K4 fused_encode         <- _fused_encode_kernel / fused_encode_call
//   K5 fused_rotate_encode  <- fused_rotate_encode_call (inner kernel)
//
// K4 is a streaming pass, bound by device-memory bytes at large n: it reads
// y twice (norm, then quantize) and u once and writes n/2 bytes packed or
// n unpacked.  The TPU kernel ran a two-phase sequential grid that carried
// the sum of squares in a (1,1) block; blocks here run in parallel with no
// grid-wide barrier, so K4 is two launches: K1's per-block sums of squares
// (qsgd_common.cuh), then a quantize+pack kernel whose every block first
// adds the row's partials in K1's fixed order — so K4's norm is K1's, bit
// for bit — and computes sqrt -> guard -> s / safe itself.  Each thread
// quantizes a coordinate pair and writes its byte: levels never touch
// device memory.  An odd row's missing coordinate packs as nibble 0 and is
// never read.
//
// K5 spreads one message of d = c * M coordinates over a thread block
// cluster of c blocks on c SMs (c = d / 4096 from 2^13 up, 8 at 2^15, 1
// below; the wrapper's k5_cluster), each block holding a chunk of M <= 4096
// coordinates (16 KiB of shared memory).  What bounds it is latency: 2^15
// coordinates are 0.28 MB in and out (0.08 us of bandwidth) and 0.8 MFLOP,
// but the 15 butterfly stages are a chain of dependent steps: one SM with
// a barrier between stages walks them in ~33 us.  So the stages run where
// they are cheapest, in the plain FWHT's order h = 1, 2, 4, ... (a
// different order is a different summation tree and would break the
// bitwise rotation):
//   * y comes in as 16-byte vectors, 16 contiguous coordinates a thread,
//     and u (float2 pairs) is loaded at the start for the last phase;
//   * the Rademacher signs (murmur3 finalizer in uint32), then the stages
//     h < 16 in registers, h < 512 by warp shuffles, h < M through shared
//     memory with a barrier each (pairs at consecutive addresses: no bank
//     conflicts);
//   * the chunk's last stage (h = M/2) stores each output straight into
//     the shared memory of the block that owns its column (block `rank`
//     owns columns [rank * M/c, (rank + 1) * M/c) of every chunk), through
//     distributed shared memory; after one cluster barrier each thread
//     holds, for its column pairs (j, j+1), the c coordinates
//     x[k * M + j] of every chunk k, and runs the log2(c) cross stages in
//     registers (k-bit 0, 1, 2), then the d^-1/2 scale;
//   * the norm in a fixed order: a tree over the thread's squares, the
//     warp's shuffle tree, then the c * (warps) partials, which each warp
//     stores into every block of the cluster before a second cluster
//     barrier, added in index order by every thread, so every block
//     derives the same inv bit for bit.  After that barrier no block
//     touches a peer's shared memory, so none can exit under a peer that
//     still needs it (the split barrier at the start, arrive then wait
//     before the first store, makes sure every peer has started);
//   * quantize and pack from registers: a thread owns whole nibble pairs.
// Adds and subtracts only in the butterflies and one multiply for the
// scale, so the rotated rows are bitwise the plain rotate.  The cluster is
// a launch attribute (cudaLaunchKernelEx); a cluster above the portable 8
// (d = 2^16 at c = 16) is refused by the card, which the smoke run checks.
//
// Built WITHOUT --use_fast_math, like qsgd.cu: levels are held bitwise
// against the plain versions, so '/', sqrtf and every multiply/subtract keep
// IEEE rounding.
#include <cooperative_groups.h>

#include "qsgd_common.cuh"

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ int8_t pack_byte(int lo, int hi) {
  return static_cast<int8_t>(static_cast<uint8_t>((lo & 0xF) | ((hi & 0xF) << 4)));
}

// K4, first launch: grid (P, rows), each block's partial sum of squares
// (K1's per-block body) to partials[r * P + p].
__global__ void __launch_bounds__(kThreads)
sumsq_partial_kernel(const float* __restrict__ y, long long n,
                     float* __restrict__ partials) {
  const float s = block_sumsq(y, n);
  if (threadIdx.x == 0) partials[(long long)blockIdx.y * gridDim.x + blockIdx.x] = s;
}

// K4, second launch: grid (X, rows).  Block (b, r) adds row r's P partials
// (the same order as K1's last block), derives inv, and quantizes a grid stride
// of coordinate pairs (kPack) or coordinates.  Block (0, r) writes the norm.
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

__device__ __forceinline__ uint32_t mix32(uint32_t z) {
  z = (z ^ (z >> 16)) * 0x85EBCA6Bu;
  z = (z ^ (z >> 13)) * 0xC2B2AE35u;
  return z ^ (z >> 16);
}

// K5's block: a chunk of M coordinates, E contiguous ones a worker thread
// (T workers), blocks of at least a warp (threads past T hold zeros in the
// local stages).
template <int M>
struct K5Geo {
  static constexpr int E = M < 16 ? M : 16;
  static constexpr int T = M / E;
  static constexpr int B = T < 32 ? 32 : T;
  static constexpr int kLanes = T < 32 ? T : 32;
};

// The shared memory of block `rank` of this cluster, and the cluster
// barrier: arrive (release) then wait (acquire) on shared memory across
// the cluster's blocks.  A message of one block uses its own shared memory
// and __syncthreads().  ``cluster_started`` is the arrive half of a split
// barrier, whose wait (``cluster_wait``) returns once every block of the
// cluster has started: before it, no block may touch a peer's shared
// memory.
template <int C, typename T>
__device__ __forceinline__ T* peer(T* p, unsigned int rank) {
  if constexpr (C == 1) return p;
  else return cg::this_cluster().map_shared_rank(p, rank);
}
template <int C>
__device__ __forceinline__ void cluster_sync() {
  if constexpr (C == 1) __syncthreads();
  else cg::this_cluster().sync();
}
__device__ __forceinline__ void cluster_started() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" : : : "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" : : : "memory");
}

// K5: grid rows * C blocks in clusters of C; block `rank` of the cluster of
// row r holds coordinates [rank * M, (rank + 1) * M) of the d = C * M of
// row r.  ``rot`` (nullable) receives the rotated message for checking.
//
// The exchange pushes: the chunk's last stage stores each output into the
// shared memory g[] of the block that owns its column (slot k * S + j % S
// for chunk k), and each warp stores its partial sum of squares into every
// block's parts[]; a cluster barrier follows each.  After the second no
// block touches a peer's shared memory, so any block may exit.
template <int M, int C, bool kPack>
__global__ void __launch_bounds__(K5Geo<M>::B)
rotate_encode_kernel(const float* __restrict__ ypad,
                     const float* __restrict__ u, uint32_t seed, float scale,
                     float s, float* __restrict__ norm,
                     int8_t* __restrict__ out, float* __restrict__ rot) {
  using G = K5Geo<M>;
  constexpr int E = G::E, T = G::T, B = G::B;
  constexpr int d = M * C;
  constexpr int S = M / C;                 // columns of a block's slice
  constexpr int NP = (S / 2 + B - 1) / B;  // column pairs a thread
  constexpr int W = B / 32;                // warps a block
  static_assert((NP * C * 2 & (NP * C * 2 - 1)) == 0, "a power of two");
  static_assert(C == 1 || 64 * E <= M, "C > 1 pushes from a shared stage");
  __shared__ __align__(16) float x[M];
  __shared__ __align__(16) float g[C > 1 ? M : 1];
  __shared__ float parts[C * W];
  const int tid = threadIdx.x, lane = tid & 31;
  const unsigned int rank = C == 1 ? 0u : cg::this_cluster().block_rank();
  const long long row = blockIdx.x / C;
  const float* yr = ypad + row * d;
  const float* ur = u + row * d;
  const int col0 = (int)rank * S;
  if constexpr (C > 1) cluster_started();

  // u for the last phase, issued first: it lands while the stages run
  float2 uv[NP][C];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int q = tid + i * B;
#pragma unroll
    for (int k = 0; k < C; ++k)
      if (q < S / 2)
        uv[i][k] = *reinterpret_cast<const float2*>(ur + k * M + col0 + 2 * q);
  }

  // this thread's E contiguous coordinates, sign-flipped
  float v[E];
  const int base = (int)rank * M + tid * E;
  if (tid < T) {
    if constexpr (E % 4 == 0) {
#pragma unroll
      for (int q = 0; q < E / 4; ++q) {
        const float4 f = reinterpret_cast<const float4*>(yr + base)[q];
        v[4 * q] = f.x, v[4 * q + 1] = f.y, v[4 * q + 2] = f.z,
        v[4 * q + 3] = f.w;
      }
    } else {
#pragma unroll
      for (int r = 0; r < E; ++r) v[r] = yr[base + r];
    }
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const uint32_t z = mix32((uint32_t)(base + r) * 0x9E3779B9u + seed);
      v[r] = __fmul_rn(v[r], (z & 1u) ? -1.f : 1.f);
    }
  } else {
#pragma unroll
    for (int r = 0; r < E; ++r) v[r] = 0.f;
  }

  // stages h < E in registers
#pragma unroll
  for (int h = 1; h < E; h <<= 1)
#pragma unroll
    for (int r = 0; r < E; ++r)
      if (!(r & h)) {
        const float a = v[r], b = v[r + h];
        v[r] = __fadd_rn(a, b);
        v[r + h] = __fsub_rn(a, b);
      }
  // stages h = E * k, k < 32, across the lanes of a warp: the lane with bit
  // k clear holds the pair's low coordinate
#pragma unroll
  for (int k = 1; k < G::kLanes; k <<= 1) {
    const bool hi = lane & k;
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const float o = __shfl_xor_sync(0xffffffffu, v[r], k);
      v[r] = hi ? __fsub_rn(o, v[r]) : __fadd_rn(v[r], o);
    }
  }
  if (tid < T) {
    if constexpr (E % 4 == 0) {
#pragma unroll
      for (int q = 0; q < E / 4; ++q)
        reinterpret_cast<float4*>(x + tid * E)[q] =
            make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    } else {
#pragma unroll
      for (int r = 0; r < E; ++r) x[tid * E + r] = v[r];
    }
  }
  // stages 32 E <= h < M across warps, through shared memory; with C > 1
  // the last (h = M/2) writes each output into its owner's g[]
  constexpr int kInPlace = C > 1 ? M / 2 : M;
#pragma unroll
  for (int h = 32 * E; h < kInPlace; h <<= 1) {
    __syncthreads();
#pragma unroll
    for (int p = tid; p < M / 2; p += B) {
      const int i0 = ((p & ~(h - 1)) << 1) | (p & (h - 1));
      const float a = x[i0], b = x[i0 + h];
      x[i0] = __fadd_rn(a, b);
      x[i0 + h] = __fsub_rn(a, b);
    }
  }
  if constexpr (C > 1) {
    __syncthreads();
    cluster_wait();                        // every peer has started
#pragma unroll
    for (int p = tid; p < M / 2; p += B) {
      const float a = x[p], b = x[p + M / 2];
      const int q = p + M / 2;
      peer<C>(g, p / S)[rank * S + p % S] = __fadd_rn(a, b);
      peer<C>(g, q / S)[rank * S + q % S] = __fsub_rn(a, b);
    }
  }
  cluster_sync<C>();                       // every chunk's stages are in

  // the column pairs (j, j+1) of every chunk, the cross stages h = M, 2M,
  // 4M (k-bit 0, 1, 2), then the scale
  const float* src = C > 1 ? g : x;
  float w[NP][C][2];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int q = tid + i * B;
    if (q >= S / 2) continue;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const float2 f = *reinterpret_cast<const float2*>(src + k * S + 2 * q);
      w[i][k][0] = f.x, w[i][k][1] = f.y;
    }
#pragma unroll
    for (int h = 1; h < C; h <<= 1)
#pragma unroll
      for (int k = 0; k < C; ++k)
        if (!(k & h)) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float a = w[i][k][e], b = w[i][k + h][e];
            w[i][k][e] = __fadd_rn(a, b);
            w[i][k + h][e] = __fsub_rn(a, b);
          }
        }
#pragma unroll
    for (int k = 0; k < C; ++k)
#pragma unroll
      for (int e = 0; e < 2; ++e) w[i][k][e] = __fmul_rn(w[i][k][e], scale);
    if (rot != nullptr)
#pragma unroll
      for (int k = 0; k < C; ++k)
        *reinterpret_cast<float2*>(rot + row * d + k * M + col0 + 2 * q) =
            make_float2(w[i][k][0], w[i][k][1]);
  }

  // the norm, in an order fixed by d: a tree over this thread's squares,
  // the warp's shuffle tree, then the C * W warp partials, which every
  // block holds after the barrier, in index order (lane l adds partials
  // l, l + 32, ...; then an xor butterfly, which leaves the same bits in
  // every lane)
  float sq[NP * C * 2];
#pragma unroll
  for (int i = 0; i < NP; ++i)
#pragma unroll
    for (int k = 0; k < C; ++k)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        sq[(i * C + k) * 2 + e] = tid + i * B < S / 2
                                      ? __fmul_rn(w[i][k][e], w[i][k][e])
                                      : 0.f;
#pragma unroll
  for (int h = 1; h < NP * C * 2; h <<= 1)
#pragma unroll
    for (int r = 0; r < NP * C * 2; r += 2 * h)
      sq[r] = __fadd_rn(sq[r], sq[r + h]);
  const float wsum = warp_sum(sq[0]);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < C; ++k) peer<C>(parts, k)[rank * W + (tid >> 5)] = wsum;
  cluster_sync<C>();                       // every partial is everywhere
  float tot = 0.f;
#pragma unroll
  for (int i = lane; i < C * W; i += 32) tot = __fadd_rn(tot, parts[i]);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1)
    tot = __fadd_rn(tot, __shfl_xor_sync(0xffffffffu, tot, off));
  float nr;
  const float iv = inv_scale(tot, s, &nr);
  if (rank == 0 && tid == 0) norm[row] = nr;

#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int q = tid + i * B;
    if (q >= S / 2) continue;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int lo = qsgd_level(w[i][k][0], uv[i][k].x, iv);
      const int hi = qsgd_level(w[i][k][1], uv[i][k].y, iv);
      const long long at = row * d + k * M + col0 + 2 * q;
      if (kPack)
        out[at >> 1] = pack_byte(lo, hi);
      else
        *reinterpret_cast<char2*>(out + at) =
            make_char2((signed char)lo, (signed char)hi);
    }
  }
}

template <int M, int C, bool kPack>
int launch_rotate_encode(const float* ypad, const float* u, long long rows,
                         uint32_t seed, float scale, float s, float* norm,
                         int8_t* out, float* rot, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned int)(rows * C));
  cfg.blockDim = dim3(K5Geo<M>::B);
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, rotate_encode_kernel<M, C, kPack>, ypad, u, seed, scale, s, norm,
      out, rot);
  const cudaError_t last = cudaGetLastError();   // clears a refused launch
  return (int)(err != cudaSuccess ? err : last);
}

// the instantiations: chunks of 2 .. 4096 alone (d < 2^13), chunks of 4096
// in clusters of 2, 4, 8 and 16 (d = 2^13 .. 2^16; 16 exceeds the portable
// cluster size, so the card refuses it)
template <bool kPack>
int dispatch_rotate_encode(const float* ypad, const float* u, long long rows,
                           int d, int c, uint32_t seed, float scale, float s,
                           float* norm, int8_t* out, float* rot,
                           cudaStream_t st) {
#define K5_CASE(M_, C_)                                                     \
  if (d == (M_) * (C_) && c == (C_))                                        \
    return launch_rotate_encode<M_, C_, kPack>(ypad, u, rows, seed, scale, \
                                               s, norm, out, rot, st);
  K5_CASE(2, 1) K5_CASE(4, 1) K5_CASE(8, 1) K5_CASE(16, 1) K5_CASE(32, 1)
  K5_CASE(64, 1) K5_CASE(128, 1) K5_CASE(256, 1) K5_CASE(512, 1)
  K5_CASE(1024, 1) K5_CASE(2048, 1) K5_CASE(4096, 1) K5_CASE(4096, 2)
  K5_CASE(4096, 4) K5_CASE(4096, 8) K5_CASE(4096, 16)
#undef K5_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K4: y, u (rows, n) f32 -> norm (rows,) f32 and out (rows, ceil(n/2))
// packed bytes (pack != 0) or (rows, n) int8 levels; partials (rows * P,)
// is scratch the caller allocates, P as K1's.
int fused_encode(const float* y, const float* u, long long rows, long long n,
                 int P, float s, int pack, float* partials, float* norm,
                 int8_t* out, cudaStream_t st) {
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

// K5: ypad, u (rows, d) f32, d a power of two, both 16-byte aligned ->
// norm (rows,) f32 and out (rows, d/2) packed bytes or (rows, d) int8
// levels; c is the cluster size (the wrapper's k5_cluster(d)); rot
// (rows, d) f32 receives the rotated message when not null.
int fused_rotate_encode(const float* ypad, const float* u, long long rows,
                        int d, int c, unsigned int seed, float scale,
                        float s, int pack, float* norm, int8_t* out,
                        float* rot, cudaStream_t st) {
  return pack ? dispatch_rotate_encode<true>(ypad, u, rows, d, c, seed, scale,
                                             s, norm, out, rot, st)
              : dispatch_rotate_encode<false>(ypad, u, rows, d, c, seed,
                                              scale, s, norm, out, rot, st);
}

}  // extern "C"
