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
//
// All three are streaming passes: one read of each input, one write of each
// output, a few flops per element, so device memory bandwidth bounds them at
// large n.  At the model's D = 101,770 they are bound by launch latency.
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
// kernel's order (qsgd.py:100).  Out of place: x is the round's model
// vector, which the caller still holds.
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

template <typename T>
int launch_quantize(const float* y, const float* u, const float* inv,
                    long long rows, long long n, T* out, cudaStream_t st) {
  const dim3 grid(grid_x(n, 4LL * kThreads, 4096u), (unsigned int)rows);
  quantize_kernel<T><<<grid, kThreads, 0, st>>>(y, u, inv, n, out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dequant_apply(const float* x, const T* lvl, const float* norm,
                         float s, float gamma, long long n, float* out,
                         cudaStream_t st) {
  const unsigned int grid = grid_x(n, 4LL * kThreads, 8192u);
  dequant_apply_kernel<T><<<grid, kThreads, 0, st>>>(x, lvl, norm, s, gamma,
                                                     n, out);
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

}  // extern "C"
