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
// K5 holds one message per block in dynamic shared memory (2^15 f32 =
// 128 KiB, above the 48 KiB default, so the launch raises the block's limit
// with cudaFuncSetAttribute first): Rademacher signs from the murmur3
// finalizer in uint32, the butterflies stage by stage with a barrier
// between stages (adds and subtracts only, so bitwise the plain FWHT), the
// d^-1/2 scale, a fixed-order block sum for the norm, then quantize and
// pack as K4.  u is read straight from device memory.  One block per
// message occupies one SM, so a single message is bound by that SM, not by
// the card's bandwidth; clusters and TMA are for a later change.
//
// Built WITHOUT --use_fast_math, like qsgd.cu: levels are held bitwise
// against the plain versions, so '/', sqrtf and every multiply/subtract keep
// IEEE rounding.
#include "qsgd_common.cuh"

namespace {

constexpr int kRotThreads = 1024;
constexpr int kDefaultSmem = 48 * 1024;

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

// K5: one block per row of a (rows, d) matrix, d a power of two.  The
// rotated message r = fwht(y * signs) * scale lives in shared memory x[];
// ``rot`` (nullable) receives a copy of r for checking.
template <bool kPack>
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
  // stage h: pair p = (j, t) with j = p / h, t = p % h holds
  // (j*2h + t, j*2h + h + t); in place, each pair owned by one thread
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
  // block_sum's barrier also publishes every thread's x[] writes
  const float tot = block_sum<kRotThreads>(acc);
  if (threadIdx.x == 0) s_inv = inv_scale(tot, s, norm + blockIdx.x);
  __syncthreads();
  const float iv = s_inv;
  if (kPack) {
    int8_t* o = out + (long long)blockIdx.x * (d >> 1);
    for (int j = threadIdx.x; j < (d >> 1); j += kRotThreads)
      o[j] = pack_byte(qsgd_level(x[2 * j], ur[2 * j], iv),
                       qsgd_level(x[2 * j + 1], ur[2 * j + 1], iv));
  } else {
    int8_t* o = out + off;
    for (int i = threadIdx.x; i < d; i += kRotThreads)
      o[i] = static_cast<int8_t>(qsgd_level(x[i], ur[i], iv));
  }
}

template <bool kPack>
int launch_rotate_encode(const float* ypad, const float* u, long long rows,
                         int d, uint32_t seed, float scale, float s,
                         float* norm, int8_t* out, float* rot,
                         cudaStream_t st) {
  const size_t smem = (size_t)d * sizeof(float);
  if (smem > (size_t)kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        rotate_encode_kernel<kPack>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();   // clear it: the next launch must not see it
      return (int)err;
    }
  }
  rotate_encode_kernel<kPack><<<(unsigned int)rows, kRotThreads, smem, st>>>(
      ypad, u, d, seed, scale, s, norm, out, rot);
  return (int)cudaGetLastError();
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

// K5: ypad, u (rows, d) f32, d a power of two -> norm (rows,) f32 and out
// (rows, d/2) packed bytes or (rows, d) int8 levels; rot (rows, d) f32
// receives the rotated message when not null.
int fused_rotate_encode(const float* ypad, const float* u, long long rows,
                        int d, unsigned int seed, float scale, float s,
                        int pack, float* norm, int8_t* out, float* rot,
                        cudaStream_t st) {
  return pack ? launch_rotate_encode<true>(ypad, u, rows, d, seed, scale, s,
                                           norm, out, rot, st)
              : launch_rotate_encode<false>(ypad, u, rows, d, seed, scale, s,
                                            norm, out, rot, st);
}

}  // extern "C"
