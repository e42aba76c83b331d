// Pieces shared by the QSGD kernels (qsgd.cu: K1-K3) and the one-pass
// encodes (fused_encode.cu: K4, K5): the fixed-order block sum, the thread
// map and per-block sum of squares of K1 and K4, and the stochastic level
// of one coordinate.  Each .cu that includes this builds into its own library.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Fixed-order block sum for a block of kBlock threads (warp shuffles, then
// warp 0 over the warp sums); the result is valid in thread 0.  Uses its
// own shared scratch: a kernel that calls it twice puts a __syncthreads()
// between the calls.
template <int kBlock>
__device__ __forceinline__ float block_sum(float v) {
  static_assert(kBlock % 32 == 0 && kBlock <= 1024, "block size");
  __shared__ float warp_part[kBlock / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  v = (threadIdx.x < kBlock / 32) ? warp_part[lane] : 0.f;
  if (warp == 0) v = warp_sum(v);
  return v;
}

// The thread map of K1 and of K4 over row blockIdx.y of a (rows, n)
// matrix, grid (P, rows): the row is peeled to 16-byte alignment first
// (rows of odd length start mid-vector), then thread `tid` of the grid's
// row takes the head element tid (tid < head), the 16-byte vectors tid,
// tid + stride, ... of the body, and the tail element head + 4 nvec + tid
// (when below n).  Each coordinate falls to exactly one thread.
struct RowMap {
  const float* row;
  long long n, head, nvec, tid, stride;
  __device__ __forceinline__ RowMap(const float* y, long long n_)
      : row(y + (long long)blockIdx.y * n_), n(n_) {
    tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    stride = (long long)gridDim.x * blockDim.x;
    head = (long long)(((16u - ((uintptr_t)row & 15u)) & 15u) >> 2);
    if (head > n) head = n;
    nvec = (n - head) >> 2;
  }
  __device__ __forceinline__ const float4* body() const {
    return reinterpret_cast<const float4*>(row + head);
  }
  __device__ __forceinline__ long long tail() const {
    return head + (nvec << 2) + tid;
  }
};

// The sum of squares in K1's order, one term at a time: acc + v^2 for a
// head or tail element, acc + (x^2 + y^2 + z^2 + w^2) for a vector.  K1's
// loop and K4's registers add through these, so their partials agree bit
// for bit.
__device__ __forceinline__ float add_sq(float acc, float v) {
  return acc + v * v;
}
__device__ __forceinline__ float add_sq4(float acc, float4 v) {
  return acc + (v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w);
}

// The per-block body of K1 and of K4's first launch on the two-launch
// route: block (p, r) sums y[r, i]^2 over its share of the RowMap.  The
// block's sum is valid in thread 0.
__device__ __forceinline__ float block_sumsq(const float* __restrict__ y,
                                             long long n) {
  const RowMap m(y, n);
  float acc = 0.f;
  if (m.tid < m.head) acc = add_sq(acc, m.row[m.tid]);
  for (long long i = m.tid; i < m.nvec; i += m.stride)
    acc = add_sq4(acc, m.body()[i]);
  if (m.tail() < n) acc = add_sq(acc, m.row[m.tail()]);
  return block_sum<kThreads>(acc);
}

// The sum of one row's P partials, in a fixed order (thread i takes
// partials i, i + kThreads, ...; then the block sum); valid in thread 0.
// K1's last block and K4's quantize both reduce this way, so their norms
// agree bit for bit.  The loads bypass L1 (__ldcg): in K1 other blocks of
// the same launch wrote the partials.
__device__ __forceinline__ float sum_partials(const float* __restrict__ p, int P) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < P; i += kThreads) acc += __ldcg(p + i);
  return block_sum<kThreads>(acc);
}

// The stochastic level sign(y) * (floor(|y| inv) + [u < frac]) of one
// coordinate, in the TPU kernel's op order (qsgd.py:67-73); multiply and
// subtract spelled out so nvcc cannot contract them.  The level is an exact
// small integer in float, so its conversion to int is exact.
__device__ __forceinline__ int qsgd_level(float y, float u, float inv) {
  const float scaled = __fmul_rn(fabsf(y), inv);
  const float base = floorf(scaled);
  const float lvl = base + (u < __fsub_rn(scaled, base) ? 1.f : 0.f);
  const float sgn = y > 0.f ? 1.f : (y < 0.f ? -1.f : 0.f);
  return static_cast<int>(sgn * lvl);
}

// norm = sqrt(ss), safe = norm > 0 ? norm : 1, inv = s / safe: the order of
// the TPU fused encode (qsgd.py:184-186), with IEEE sqrtf and '/'.
__device__ __forceinline__ float inv_scale(float ss, float s, float* norm) {
  const float nr = sqrtf(ss);
  *norm = nr;
  return s / (nr > 0.f ? nr : 1.f);
}

unsigned int grid_x(long long n, long long per_block, unsigned int cap) {
  long long g = (n + per_block - 1) / per_block;
  if (g < 1) g = 1;
  return (unsigned int)(g < cap ? g : cap);
}

}  // namespace
