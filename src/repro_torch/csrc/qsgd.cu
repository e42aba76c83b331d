// QSGD kernels for Hopper (sm_90a): the norm (K1), the stochastic quantize
// (K2) and the fused dequantize + model update (K3) of GenQSGD's encode and
// server apply.  Plain C entry points, loaded with ctypes by
// repro_torch/kernels/build.py; the Python wrappers and the plain PyTorch
// version of each kernel live in repro_torch/kernels/qsgd.py.
//
// Replaces (JAX package, src/repro/kernels/qsgd.py):
//   K1 qsgd_sumsq          <- _sumsq_kernel / sumsq_kernel_call
//   K2 qsgd_quantize       <- _quantize_kernel / quantize_kernel_call
//   K3 qsgd_dequant_apply  <- _dequant_apply_kernel / dequant_apply_kernel_call
// and K3b qsgd_dequant_apply_bucketed, K3 with one norm per bucket of q
// coordinates (QSGD bucketing), which replaces no TPU kernel: the JAX
// package's Pallas backend refuses buckets, and its reference runtime
// decodes the bucket rows in jnp (compress/backends.py decode_bucketed)
// before the update.
//
// All three are streaming passes: one read of each input, one write of each
// output, a few flops per element, so device memory bandwidth bounds them at
// large n.  At the model's D = 101,770 they are bound by launch latency.
// K3 is therefore one 16-byte item a thread (x as float4, four levels as
// an int4 or a char4), both loads issued before any use, over one wave of
// every SM at D: one round trip to memory a thread.
// The TPU version carried the sum of squares from one grid step to the next
// in a (1,1) output block; blocks here run in parallel and in no order, so
// K1 is one launch whose last block of each row (by an integer ticket)
// adds the row's partial sums in a fixed order (no float atomics: the norm
// is the same from run to run).  Every kernel masks its own ragged edge, so no
// padding to the TPU's 512x1024 tile grid is needed.
//
// Built WITHOUT --use_fast_math: K2 must keep IEEE '/' and sqrtf and its
// multiply/subtract unfused (it is held bitwise against the plain version),
// and K3 spells out __fmul_rn/__fadd_rn so nvcc cannot contract into an FMA
// that the plain version does not do.
#include "qsgd_common.cuh"

namespace {

// K1: grid (P, rows), one launch.  Block (p, r) writes its partial sum of
// squares, fences it and draws a ticket of row r; the block that draws the
// last ticket adds the row's P partials in a fixed order (sum_partials, as
// K4 does), then norm = sqrt(ss), safe = norm > 0 ? norm : 1,
// inv = s / safe — the order of the TPU fused encode (qsgd.py:184-186), on
// the device, so an encode never waits on the host — and sets the ticket
// back to 0 for the next launch.  The tickets count blocks, never floats:
// the sum has one order and the norm is the same from run to run.
__global__ void __launch_bounds__(kThreads)
sumsq_kernel(const float* __restrict__ y, long long n, float s,
             float* __restrict__ partials, unsigned int* __restrict__ tickets,
             float* __restrict__ ss, float* __restrict__ norm,
             float* __restrict__ inv) {
  __shared__ bool s_last;
  const unsigned int P = gridDim.x;
  const long long row = blockIdx.y;
  const float part = block_sumsq(y, n);
  if (threadIdx.x == 0) {
    partials[row * P + blockIdx.x] = part;
    __threadfence();                    // the partial, before the ticket
    s_last = atomicAdd(tickets + row, 1u) == P - 1;
  }
  __syncthreads();                      // also between the two block sums
  if (!s_last) return;
  __threadfence();
  const float tot = sum_partials(partials + row * P, (int)P);
  if (threadIdx.x == 0) {
    ss[row] = tot;
    inv[row] = inv_scale(tot, s, norm + row);
    tickets[row] = 0u;
  }
}

// K2: grid (X, rows).  lvl = sign(y) * (floor(|y| inv) + [u < frac]), in
// the TPU kernel's op order (qsgd.py:67-73); the level is an exact small
// integer in float, so its conversion to the container is exact.
template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ y, const float* __restrict__ u,
                const float* __restrict__ inv, long long n,
                T* __restrict__ out) {
  const long long off = (long long)blockIdx.y * n;
  const float iv = inv[blockIdx.y];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[off + i] = static_cast<T>(qsgd_level(y[off + i], u[off + i], iv));
}

// K3: out = x + (gamma * lvl) * scale with scale = norm / s, the TPU
// kernel's order (qsgd.py:100), each product and the sum rounded once.
// Out of place: x is the round's model vector, which the caller still
// holds.
__device__ __forceinline__ float apply1(float x, float l, float gamma,
                                        float scale) {
  return __fadd_rn(x, __fmul_rn(__fmul_rn(gamma, l), scale));
}

constexpr int kApplyThreads = 128;

// four levels beside one float4 of x: an int4 of int32, a char4 of int8
template <typename T> struct Lvl4;
template <> struct Lvl4<int32_t> { using V = int4; };
template <> struct Lvl4<int8_t> { using V = char4; };

// norm / s, computed once this thread's loads are issued: the division
// waits for the norm's load, and a warp issues in order, so a division
// placed first would hold every load back by one round trip to memory.
// The empty asm keeps the compiler from hoisting it.
__device__ __forceinline__ float late_scale(float nrm, float s) {
  asm volatile("" : "+f"(nrm) : : "memory");
  return nrm / s;
}

// One 16-byte item a thread, in one wave at D (199 blocks), in many short
// blocks at a streaming size (one wave of blocks looping over the items
// measured slower there: scripts/kernel_variants.py, wave_loop).  Two branches, chosen from the pointers.  Vector branch:
// x is peeled to a 16-byte boundary; an item is a float4 of x and the
// matching 4 levels; the ragged ends (<= 3 elements before the body, <= 3
// after) are one more element for threads 0-5, loaded with their item.  It
// needs out and the levels in x's alignment phase.  Scalar branch, when
// they are not (row r > 0 of a (rows, 101770) int32 level matrix starts 8
// bytes off): an item is 4 consecutive elements, loaded one by one.
template <typename T>
__global__ void __launch_bounds__(kApplyThreads)
dequant_apply_kernel(const float* __restrict__ x, const T* __restrict__ lvl,
                     const float* __restrict__ norm, float s, float gamma,
                     long long n, float* __restrict__ out) {
  using V = typename Lvl4<T>::V;
  const float nrm = norm[0];
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long head = (long long)(((16u - ((uintptr_t)x & 15u)) & 15u) >> 2);
  if (head > n) head = n;
  const bool vec = ((uintptr_t)(out + head) & 15u) == 0 &&
                   ((uintptr_t)(lvl + head) & (sizeof(V) - 1)) == 0;
  if (!vec) {
    for (long long i = 4 * tid; i < n; i += 4 * stride) {
      float2 v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (i + k < n) v[k] = make_float2(x[i + k], (float)lvl[i + k]);
      const float scale = late_scale(nrm, s);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (i + k < n) out[i + k] = apply1(v[k].x, v[k].y, gamma, scale);
    }
    return;
  }
  const long long nvec = (n - head) >> 2;
  const long long end =
      tid < head ? tid
                 : (tid - head < ((n - head) & 3) ? (nvec << 2) + tid : -1);
  float2 ev;
  if (end >= 0) ev = make_float2(x[end], (float)lvl[end]);
  const float4* xv = reinterpret_cast<const float4*>(x + head);
  const V* lv = reinterpret_cast<const V*>(lvl + head);
  float4* ov = reinterpret_cast<float4*>(out + head);
  for (long long i = tid; i < nvec; i += stride) {
    const float4 a = xv[i];
    const V b = lv[i];
    const float scale = late_scale(nrm, s);
    ov[i] = make_float4(apply1(a.x, (float)b.x, gamma, scale),
                        apply1(a.y, (float)b.y, gamma, scale),
                        apply1(a.z, (float)b.z, gamma, scale),
                        apply1(a.w, (float)b.w, gamma, scale));
  }
  if (end >= 0) out[end] = apply1(ev.x, ev.y, gamma, late_scale(nrm, s));
}

// K3b's walk over buckets of q elements: the bucket b and the offset r in
// it of a thread's current element, advanced by the thread's fixed step
// with no division (the two 64-bit divisions happen once, at the start).
struct BucketWalk {
  long long q, b, r, db, dr;
  __device__ __forceinline__ BucketWalk(long long e, long long q_,
                                        long long step)
      : q(q_) {
    b = e / q;
    r = e - b * q;
    db = step / q;
    dr = step - db * q;
  }
  __device__ __forceinline__ void next() {
    b += db;
    r += dr;
    if (r >= q) {
      r -= q;
      ++b;
    }
  }
};

// The scales norm[bucket] / s of the four elements at w's position, of
// which the first m exist: one norm and one division where they share a
// bucket, else one each (an item straddles a bucket edge when q is not a
// multiple of 4 or x's head peel shifts the items).
__device__ __forceinline__ void bucket_scales(const float* __restrict__ norm,
                                              float s, const BucketWalk& w,
                                              long long m, float sc[4]) {
  if (w.r + 3 < w.q) {
    const float v = late_scale(norm[w.b], s);
#pragma unroll
    for (int k = 0; k < 4; ++k) sc[k] = v;
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    long long b = w.b, r = w.r + k;
    while (r >= w.q) {
      r -= w.q;
      ++b;
    }
    sc[k] = k < m ? late_scale(norm[b], s) : 0.f;
  }
}

// K3b: out[i] = x[i] + (gamma * lvl[i]) * (norm[i / q] / s), K3's thread
// map, branches and operation order with the scale taken per bucket, so it
// is bitwise its plain version and, at q >= n, K3's bytes.  One more load
// an item (its bucket's norm, 4 bytes a bucket, from L1/L2).
template <typename T>
__global__ void __launch_bounds__(kApplyThreads)
dequant_apply_bucketed_kernel(const float* __restrict__ x,
                              const T* __restrict__ lvl,
                              const float* __restrict__ norm, float s,
                              float gamma, long long n, long long q,
                              float* __restrict__ out) {
  using V = typename Lvl4<T>::V;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long head = (long long)(((16u - ((uintptr_t)x & 15u)) & 15u) >> 2);
  if (head > n) head = n;
  const bool vec = ((uintptr_t)(out + head) & 15u) == 0 &&
                   ((uintptr_t)(lvl + head) & (sizeof(V) - 1)) == 0;
  float sc[4];
  if (!vec) {
    BucketWalk w(4 * tid, q, 4 * stride);
    for (long long i = 4 * tid; i < n; i += 4 * stride, w.next()) {
      float2 v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (i + k < n) v[k] = make_float2(x[i + k], (float)lvl[i + k]);
      bucket_scales(norm, s, w, n - i, sc);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (i + k < n) out[i + k] = apply1(v[k].x, v[k].y, gamma, sc[k]);
    }
    return;
  }
  const long long nvec = (n - head) >> 2;
  const long long end =
      tid < head ? tid
                 : (tid - head < ((n - head) & 3) ? (nvec << 2) + tid : -1);
  float2 ev;
  if (end >= 0) ev = make_float2(x[end], (float)lvl[end]);
  const float4* xv = reinterpret_cast<const float4*>(x + head);
  const V* lv = reinterpret_cast<const V*>(lvl + head);
  float4* ov = reinterpret_cast<float4*>(out + head);
  BucketWalk w(head + 4 * tid, q, 4 * stride);
  for (long long i = tid; i < nvec; i += stride, w.next()) {
    const float4 a = xv[i];
    const V b = lv[i];
    bucket_scales(norm, s, w, 4, sc);
    ov[i] = make_float4(apply1(a.x, (float)b.x, gamma, sc[0]),
                        apply1(a.y, (float)b.y, gamma, sc[1]),
                        apply1(a.z, (float)b.z, gamma, sc[2]),
                        apply1(a.w, (float)b.w, gamma, sc[3]));
  }
  if (end >= 0)
    out[end] = apply1(ev.x, ev.y, gamma, late_scale(norm[end / q], s));
}

template <typename T>
int launch_quantize(const float* y, const float* u, const float* inv,
                    long long rows, long long n, T* out, cudaStream_t st) {
  const dim3 grid(grid_x(n, 4LL * kThreads, 4096u), (unsigned int)rows);
  quantize_kernel<T><<<grid, kThreads, 0, st>>>(y, u, inv, n, out);
  return (int)cudaGetLastError();
}

// K3's grid: one block per kApplyThreads items of 4 elements (199 blocks at
// D = 101,770); the loop in the kernel only matters past 2^31 blocks.
template <typename T>
int launch_dequant_apply(const float* x, const T* lvl, const float* norm,
                         float s, float gamma, long long n, float* out,
                         cudaStream_t st) {
  const unsigned int grid = grid_x((n + 3) >> 2, kApplyThreads, 0x7FFFFFFFu);
  dequant_apply_kernel<T><<<grid, kApplyThreads, 0, st>>>(x, lvl, norm, s,
                                                          gamma, n, out);
  return (int)cudaGetLastError();
}

// K3b's grid: K3's.
template <typename T>
int launch_dequant_apply_bucketed(const float* x, const T* lvl,
                                  const float* norm, float s, float gamma,
                                  long long n, long long q, float* out,
                                  cudaStream_t st) {
  const unsigned int grid = grid_x((n + 3) >> 2, kApplyThreads, 0x7FFFFFFFu);
  dequant_apply_bucketed_kernel<T><<<grid, kApplyThreads, 0, st>>>(
      x, lvl, norm, s, gamma, n, q, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1: y (rows, n) f32 -> ss, norm, inv (rows,) f32; partials (rows * P,)
// is scratch the caller allocates, tickets (rows,) zeros the caller keeps
// (each launch leaves them zero).
int qsgd_sumsq(const float* y, long long rows, long long n, int P, float s,
               float* partials, unsigned int* tickets, float* ss, float* norm,
               float* inv, cudaStream_t st) {
  const dim3 grid((unsigned int)P, (unsigned int)rows);
  sumsq_kernel<<<grid, kThreads, 0, st>>>(y, n, s, partials, tickets, ss,
                                          norm, inv);
  return (int)cudaGetLastError();
}

// K2: y, u (rows, n) f32, inv (rows,) f32 -> levels (rows, n).
int qsgd_quantize_i8(const float* y, const float* u, const float* inv,
                     long long rows, long long n, int8_t* out, cudaStream_t st) {
  return launch_quantize<int8_t>(y, u, inv, rows, n, out, st);
}

int qsgd_quantize_i32(const float* y, const float* u, const float* inv,
                      long long rows, long long n, int32_t* out,
                      cudaStream_t st) {
  return launch_quantize<int32_t>(y, u, inv, rows, n, out, st);
}

// K3: x (n,) f32, levels (n,), norm (1,) f32 -> out (n,) f32.
int qsgd_dequant_apply_i8(const float* x, const int8_t* lvl, const float* norm,
                          float s, float gamma, long long n, float* out,
                          cudaStream_t st) {
  return launch_dequant_apply<int8_t>(x, lvl, norm, s, gamma, n, out, st);
}

int qsgd_dequant_apply_i32(const float* x, const int32_t* lvl,
                           const float* norm, float s, float gamma, long long n,
                           float* out, cudaStream_t st) {
  return launch_dequant_apply<int32_t>(x, lvl, norm, s, gamma, n, out, st);
}

// K3b: x (n,) f32, levels (n,), norm (ceil(n / q),) f32 -> out (n,) f32.
int qsgd_dequant_apply_bucketed_i8(const float* x, const int8_t* lvl,
                                   const float* norm, float s, float gamma,
                                   long long n, long long q, float* out,
                                   cudaStream_t st) {
  return launch_dequant_apply_bucketed<int8_t>(x, lvl, norm, s, gamma, n, q,
                                               out, st);
}

int qsgd_dequant_apply_bucketed_i32(const float* x, const int32_t* lvl,
                                    const float* norm, float s, float gamma,
                                    long long n, long long q, float* out,
                                    cudaStream_t st) {
  return launch_dequant_apply_bucketed<int32_t>(x, lvl, norm, s, gamma, n, q,
                                                out, st);
}

}  // extern "C"
