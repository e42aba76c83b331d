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
// K4 is a streaming pass, bound by device-memory bytes at large n (y and
// u read once, n/2 bytes written packed or n unpacked: 8.5n or 9n) and by
// launch latency at the model's D = 101,770.  The TPU kernel ran a
// two-phase sequential grid that carried the sum of squares in a (1,1)
// block; blocks here run in parallel, so the norm needs every block of a
// row before any can quantize.  K4 is one cooperative launch on K1's grid
// (P, rows) and thread map (RowMap, qsgd_common.cuh): each thread loads
// its few vectors of y and u and keeps them in registers, adds its squares
// in K1's order, and the block's partial goes to device memory in one
// 8-byte word with this launch's generation; every block waits for its
// row's P words and adds them in K1's fixed order, so K4's norm is K1's
// bit for bit, and each thread quantizes and packs from its registers: y
// is read once and levels never touch device memory.  (A counter per row
// with fences, then the partials read again, cost two more round trips
// to L2; one warp reading the P words in turn, more.)
// The wait needs every block of the grid resident at once, which the
// cooperative launch guarantees (the card refuses it otherwise); the
// wrapper picks this route from the shape and the card's resident blocks
// (fused_encode_capacity).  Where they do not fit, or past 128 blocks a row
// (n > 2^19: the P^2 reads of a row's partials then cost more than a
// second launch), K4 is two launches: K1's per-block partials, then a
// quantize whose every block adds the partials itself (packed: PR 12's
// kernel of coordinate pairs; unpacked: 16-byte loads of y and u on the
// same RowMap, issued before the partials are added; each measured the
// faster for its output).  Both routes write the same bytes and the same
// norm.  An odd row's missing coordinate packs as nibble 0 and is never
// read.
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

// ---- K4 -----------------------------------------------------------------
// Vectors of y a thread holds on the one-launch route: K1's grid gives each
// thread at most 4 for n <= 2^22 (P = ceil(n / 4096) blocks of 256).
constexpr int kSlots = 4;
// A wait for a row's partials that outlasts this traps (the launch fails with
// an error) rather than hang the card: no resident row waits that long.
constexpr uint64_t kWaitNs = 4000000000ull;   // 4 s

// What one thread of the RowMap holds of its row in one trip: the vectors
// of y at body indices i0 + k * stride (k < kSlots, below nvec) and of u at
// the same coordinates, and, on the first trip, its head and tail element
// of each.
template <int S>
struct Held {
  float4 y[S], u[S];
  float hy, hu, ty, tu;
};

// Issue a trip's loads: y's vectors, then u's, as vectors where u's row
// shares y's 16-byte phase, else element by element (a caller's view of u
// in another phase); the head and tail elements with the first trip.
template <int S>
__device__ __forceinline__ void load_held(const RowMap& m,
                                          const float* __restrict__ ur,
                                          long long i0, bool edges,
                                          Held<S>& h) {
  const float4* yb = m.body();
#pragma unroll
  for (int k = 0; k < S; ++k)
    if (i0 + k * m.stride < m.nvec) h.y[k] = yb[i0 + k * m.stride];
  const float* ub = ur + m.head;
  if (((uintptr_t)ub & 15u) == 0) {
#pragma unroll
    for (int k = 0; k < S; ++k)
      if (i0 + k * m.stride < m.nvec)
        h.u[k] = reinterpret_cast<const float4*>(ub)[i0 + k * m.stride];
  } else {
#pragma unroll
    for (int k = 0; k < S; ++k)
      if (i0 + k * m.stride < m.nvec) {
        const float* p = ub + 4 * (i0 + k * m.stride);
        h.u[k] = make_float4(p[0], p[1], p[2], p[3]);
      }
  }
  if (edges) {
    if (m.tid < m.head) h.hy = m.row[m.tid], h.hu = ur[m.tid];
    if (m.tail() < m.n) h.ty = m.row[m.tail()], h.tu = ur[m.tail()];
  }
}

// The thread's share of the row's sum of squares from what it holds, in
// block_sumsq's order (head, vectors, tail): so K4's partials are K1's.
__device__ __forceinline__ float held_sumsq(const RowMap& m,
                                            const Held<kSlots>& h) {
  float acc = 0.f;
  if (m.tid < m.head) acc = add_sq(acc, h.hy);
#pragma unroll
  for (int k = 0; k < kSlots; ++k)
    if (m.tid + k * m.stride < m.nvec) acc = add_sq4(acc, h.y[k]);
  if (m.tail() < m.n) acc = add_sq(acc, h.ty);
  return acc;
}

// Two consecutive output bytes, one 2-byte store where the first is even.
__device__ __forceinline__ void store2(int8_t* o, int8_t a, int8_t b) {
  if (((uintptr_t)o & 1u) == 0) {
    *reinterpret_cast<char2*>(o) = make_char2(a, b);
  } else {
    o[0] = a;
    o[1] = b;
  }
}

// Quantize what a thread holds and write it.  Unpacked, every coordinate
// writes its own byte (a vector's four with one 4-byte store where
// aligned).  Packed, byte j holds coordinates 2j and 2j + 1 and belongs to
// the thread holding coordinate 2j, so every byte has one writer.  A
// vector starting at an even coordinate c0 is two whole bytes; at an odd
// c0 its bytes are (c0+1, c0+2) and (c0+3, c0+4), and the level of c0 + 4,
// held by another thread, is recomputed here from y and u (an L1/L2 hit;
// every block derives the same inv).  Past n the nibble is 0.
template <bool kPack, int S>
__device__ __forceinline__ void store_held(const RowMap& m,
                                           const float* __restrict__ ur,
                                           long long i0, bool edges,
                                           const Held<S>& h, float iv,
                                           int8_t* __restrict__ orow) {
  const long long n = m.n;
  auto level_at = [&](long long c) {
    return c < n ? qsgd_level(m.row[c], ur[c], iv) : 0;
  };
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const long long i = i0 + k * m.stride;
    if (i >= m.nvec) continue;
    const long long c0 = m.head + 4 * i;
    const int l0 = qsgd_level(h.y[k].x, h.u[k].x, iv);
    const int l1 = qsgd_level(h.y[k].y, h.u[k].y, iv);
    const int l2 = qsgd_level(h.y[k].z, h.u[k].z, iv);
    const int l3 = qsgd_level(h.y[k].w, h.u[k].w, iv);
    if (kPack) {
      if ((c0 & 1) == 0)
        store2(orow + (c0 >> 1), pack_byte(l0, l1), pack_byte(l2, l3));
      else
        store2(orow + ((c0 + 1) >> 1), pack_byte(l1, l2),
               pack_byte(l3, level_at(c0 + 4)));
    } else {
      int8_t* o = orow + c0;
      if (((uintptr_t)o & 3u) == 0) {
        *reinterpret_cast<char4*>(o) =
            make_char4((signed char)l0, (signed char)l1, (signed char)l2,
                       (signed char)l3);
      } else {
        o[0] = l0, o[1] = l1, o[2] = l2, o[3] = l3;
      }
    }
  }
  if (!edges) return;
  // the head and tail elements: an even one owns its byte
  auto edge = [&](long long c, float yv, float uv) {
    const int l = qsgd_level(yv, uv, iv);
    if (!kPack)
      orow[c] = static_cast<int8_t>(l);
    else if ((c & 1) == 0)
      orow[c >> 1] = pack_byte(l, level_at(c + 1));
  };
  if (m.tid < m.head) edge(m.tid, h.hy, h.hu);
  if (m.tail() < n) edge(m.tail(), h.ty, h.tu);
}

__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t now;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
  return now;
}

// The one-launch route's exchange, in a scratch the wrapper keeps per
// device: sync[0] is the generation of the last launch, sync[1] counts the
// blocks of the running one; a slot per block holds its partial sum of
// squares beside the generation that wrote it, in one 8-byte word, so a
// reader that sees this launch's generation sees the partial with it (no
// fence, no counter on the way).  Each block reads the generation first
// (acquire) and then counts itself; the last to count has seen every block
// read it, so it sets sync[1] back to 0 and stores the next generation:
// the next launch, or a replay of a captured one, finds fresh tags.
constexpr int kMaxSlots = 65535;

__device__ __forceinline__ unsigned int load_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void store_slot(unsigned long long* p, float v,
                                           unsigned int gen) {
  const unsigned long long w =
      ((unsigned long long)gen << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n"
               :: "l"(p), "l"(w) : "memory");
}
// The partial in slot p once its generation is gen; a wait past kWaitNs
// traps (a block that is not resident never writes its slot).
__device__ __forceinline__ float wait_slot(const unsigned long long* p,
                                           unsigned int gen) {
  uint64_t t0 = 0;
  while (true) {
    unsigned long long w;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
                 : "=l"(w) : "l"(p) : "memory");
    if ((unsigned int)(w >> 32) == gen) return __uint_as_float((unsigned int)w);
    const uint64_t now = globaltimer();
    if (t0 == 0) t0 = now;
    else if (now - t0 > kWaitNs) __trap();
  }
}

// K4 in one launch (cooperative, so every block is resident): grid (P,
// rows), K1's grid and thread map.  Each thread loads its share of y and
// u (at most kSlots vectors and two elements) and adds its squares in
// K1's order; the block's partial goes to its slot, tagged with this
// launch's generation.  Every block then waits for the row's P slots,
// each thread reading the ones sum_partials gives it, and adds them in
// sum_partials' order (so the norm is K1's bit for bit), derives inv
// itself, block 0 writes the norm, and each thread quantizes and packs
// from its registers.  y is read once.
template <bool kPack>
__global__ void __launch_bounds__(kThreads, 3)
fused_encode_kernel(const float* __restrict__ y, const float* __restrict__ u,
                    float s, long long n, unsigned int* __restrict__ sync,
                    unsigned long long* __restrict__ slots,
                    float* __restrict__ norm, int8_t* __restrict__ out) {
  __shared__ float s_inv;
  __shared__ unsigned int s_gen;
  const unsigned int P = gridDim.x;
  const long long row = blockIdx.y;
  const RowMap m(y, n);
  const float* ur = u + row * n;
  unsigned int gen = 0;
  if (threadIdx.x == 0) {
    gen = load_acquire(sync) + 1;
    if (gen == 0) gen = 1;                // 0 tags the slots' first state
    if (atomicAdd(sync + 1, 1u) == P * gridDim.y - 1) {
      sync[1] = 0u;
      sync[0] = gen;
    }
  }
  Held<kSlots> h;
  load_held(m, ur, m.tid, true, h);
  const float part = block_sum<kThreads>(held_sumsq(m, h));
  unsigned long long* rs = slots + row * P;
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
  }
  __syncthreads();
  store_held<kPack>(m, ur, m.tid, true, h, s_inv,
                    out + row * (kPack ? (n + 1) >> 1 : n));
}

// The two-launch route (rows x P above the card's resident blocks, or
// n > 2^19), first launch: grid (P, rows), each block's partial sum of
// squares (K1's per-block body) to partials[r * P + p].
__global__ void __launch_bounds__(kThreads)
sumsq_partial_kernel(const float* __restrict__ y, long long n,
                     float* __restrict__ partials) {
  const float s = block_sumsq(y, n);
  if (threadIdx.x == 0) partials[(long long)blockIdx.y * gridDim.x + blockIdx.x] = s;
}

// Second launch, packed: grid (X, rows), X <= 2048.  Block (b, r) adds row
// r's P partials (sum_partials, as K1's last block) and derives inv; block
// (0, r) writes the norm; thread j of the row then writes bytes j, j +
// stride, ..., each from the coordinate pair (2j, 2j + 1), with 4-byte
// loads.  This is PR 12's kernel: for packed rows it measured faster than
// the 16-byte kernel below (PERF.md), its 1,024 blocks at 2^22 all
// resident at once.
__global__ void __launch_bounds__(kThreads)
quantize_pairs_kernel(const float* __restrict__ y, const float* __restrict__ u,
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
  const long long m = (n + 1) >> 1;
  int8_t* o = out + row * m;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < m;
       j += stride) {
    const long long i = j << 1;
    const int lo = qsgd_level(yr[i], ur[i], iv);
    const int hi = i + 1 < n ? qsgd_level(yr[i + 1], ur[i + 1], iv) : 0;
    o[j] = pack_byte(lo, hi);
  }
}

// The 16-byte quantize's vectors a thread a trip.  Its grid is one wave of
// the card (the blocks it holds at once, shared by the rows), each block
// adding the row's P partials once, then looping.
constexpr int kQuantSlots = 1;

// Second launch, unpacked: grid (X, rows) over the same RowMap, trips of
// kQuantSlots vectors a thread.  Each block issues its first trip's loads,
// then adds row r's P partials (sum_partials, as K1's last block) and
// derives inv; block (0, r) writes the norm; the quantize is the one-launch
// kernel's, so both routes write the same bytes.  (For int8 levels at 2^22
// it beat PR 12's kernel by ~3 us; PERF.md.)
template <bool kPack>
__global__ void __launch_bounds__(kThreads)
fused_quantize_kernel(const float* __restrict__ y, const float* __restrict__ u,
                      const float* __restrict__ partials, int P, float s,
                      long long n, float* __restrict__ norm,
                      int8_t* __restrict__ out) {
  __shared__ float s_inv;
  const long long row = blockIdx.y;
  const RowMap m(y, n);
  const float* ur = u + row * n;
  int8_t* orow = out + row * (kPack ? (n + 1) >> 1 : n);
  Held<kQuantSlots> h;
  load_held(m, ur, m.tid, true, h);
  const float tot = sum_partials(partials + row * P, P);
  if (threadIdx.x == 0) {
    float nr;
    s_inv = inv_scale(tot, s, &nr);
    if (blockIdx.x == 0) norm[row] = nr;
  }
  __syncthreads();
  const float iv = s_inv;
  store_held<kPack>(m, ur, m.tid, true, h, iv, orow);
  for (long long i0 = m.tid + kQuantSlots * m.stride; i0 < m.nvec;
       i0 += kQuantSlots * m.stride) {
    load_held(m, ur, i0, false, h);
    store_held<kPack>(m, ur, i0, false, h, iv, orow);
  }
}

template <bool kPack>
int launch_fused_encode(const float* y, const float* u, long long rows,
                        long long n, int P, float s, int one_launch,
                        float* partials, unsigned long long* scratch,
                        float* norm, int8_t* out, cudaStream_t st) {
  if (one_launch) {
    // every vector of the row within kSlots of a thread, a slot a block
    if (n > (long long)P * kThreads * kSlots * 4 || rows * P > kMaxSlots)
      return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned int)P, (unsigned int)rows);
    cfg.blockDim = dim3(kThreads);
    cfg.stream = st;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeCooperative;
    attr.val.cooperative = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, fused_encode_kernel<kPack>, y, u, s, n,
        reinterpret_cast<unsigned int*>(scratch), scratch + 1, norm, out);
    const cudaError_t last = cudaGetLastError();   // clears a refused launch
    return (int)(err != cudaSuccess ? err : last);
  }
  sumsq_partial_kernel<<<dim3((unsigned int)P, (unsigned int)rows), kThreads,
                         0, st>>>(y, n, partials);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if constexpr (kPack) {
    const dim3 grid(grid_x((n + 1) >> 1, 8LL * kThreads, 2048u),
                    (unsigned int)rows);
    quantize_pairs_kernel<<<grid, kThreads, 0, st>>>(y, u, partials, P, s, n,
                                                     norm, out);
    return (int)cudaGetLastError();
  }
  // one wave: the quantize's resident blocks, asked once
  static int wave = 0;
  if (wave == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_quantize_kernel<kPack>, kThreads, 0);
    wave = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  const long long per_row = wave / rows > 0 ? wave / rows : 1;
  const dim3 grid(grid_x(n, 4LL * kQuantSlots * kThreads,
                         (unsigned int)(per_row < 65535 ? per_row : 65535)),
                  (unsigned int)rows);
  fused_quantize_kernel<kPack><<<grid, kThreads, 0, st>>>(y, u, partials, P,
                                                          s, n, norm, out);
  return (int)cudaGetLastError();
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
// is scratch the two-launch route uses, P as K1's; scratch (1 + 65535,)
// 8-byte words of zeros the caller keeps for the one-launch route's
// exchange (its generation and block count, then a tagged slot a block).
// one_launch picks the route: the cooperative one-launch kernel (refused
// by the card when its grid is not resident at once) or the two launches.
int fused_encode(const float* y, const float* u, long long rows, long long n,
                 int P, float s, int pack, int one_launch, float* partials,
                 unsigned long long* scratch, float* norm, int8_t* out,
                 cudaStream_t st) {
  return pack ? launch_fused_encode<true>(y, u, rows, n, P, s, one_launch,
                                          partials, scratch, norm, out, st)
              : launch_fused_encode<false>(y, u, rows, n, P, s, one_launch,
                                           partials, scratch, norm, out, st);
}

// The blocks of K4's one-launch kernel the current card holds at once (its
// SMs times the fewer that one SM holds of the two instantiations), into
// *blocks; returns the CUDA error.  (The stream is unused.)
int fused_encode_capacity(int* blocks, cudaStream_t) {
  int dev = 0, sms = 0, packed = 0, unpacked = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &packed, fused_encode_kernel<true>, kThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &unpacked, fused_encode_kernel<false>, kThreads, 0);
  *blocks = sms * (packed < unpacked ? packed : unpacked);
  return (int)err;
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
