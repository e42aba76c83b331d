// Flash decode (K6) for Hopper (sm_90a): single-token GQA attention of q
// (B, KV, G, dh) against a KV cache k/v (B, C, KV, dh) with a (B, C) valid
// mask, in f32 with an online softmax.  Plain C entry point, loaded with
// ctypes by repro_torch/kernels/build.py; the Python wrapper and the plain
// PyTorch version live in repro_torch/kernels/flash_decode.py.
//
// Replaces (JAX package, src/repro/kernels/flash_decode.py):
//   K6 flash_decode  <- _flash_decode_kernel / flash_decode_call
//
// What it computes, as the TPU kernel does: s = (q . k) / sqrt(dh) in f32,
// s = -1e30 where the mask is 0, an online softmax over the cache (running
// max m, sum l and accumulator acc of shape (G, dh), all f32), and
// out = acc / max(l, 1e-30) in q's type.  A row with no valid entry gets
// uniform weights (the mean of v over C), as the TPU kernel and the dense
// softmax give: masked entries are scored -1e30, never skipped.
//
// What bounds it: each cache entry is read once (K and V: 2 * C * KV * dh
// elements per batch row) against about 4 * G flops per element, so device
// memory bandwidth bounds it.  The TPU kernel walks the cache as a
// sequential grid axis and carries (m, l, acc) in VMEM scratch; blocks here
// run in parallel and in no order, and B * KV alone (64 at qwen3-1.7b with
// 8 slots) would fill under half of the 132 SMs.  So the cache is split
// (split-K flash decoding): block (split, kv, b) covers `chunk` positions
// with kWarps warps, each warp a contiguous run of them; the block writes
// one f32 partial (m, l, acc) to a workspace, and a second kernel merges
// the partials of each (b, kv) in split order.  Nothing uses atomics, so
// the result is the same from run to run.  A cache row (dh elements of one
// kv head, 256 bytes at dh 128 in bf16) is read by a group of lanes with
// one 16-byte load each, so a warp's load instruction reads 32 / group
// rows; each lane group runs its own online softmax and reduces its scores
// with xor shuffles inside the group.  A warp loads the rows of its next
// step before it computes on the current ones (double-buffered in
// registers), so loads stay in flight while it computes.  The cache may
// have any length: each block masks its own ragged edge (positions past C
// add nothing), where the TPU kernel asked for C % 512 == 0.
//
// Built WITHOUT --use_fast_math: the scale is an IEEE division and the
// exponentials are expf, as in the plain version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;          // warps per block of the split kernel
constexpr int kThreads = 32 * kWarps;
constexpr int kCombineThreads = 128;
constexpr float kNeg = -1e30f;     // a masked score, the TPU kernel's NEG

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);        // round to nearest even, as torch
}

// How a warp reads cache rows: a row of DH elements is split over LPR lanes
// of 16 bytes each (32 for f32 at dh 256), so one load instruction of the
// warp reads kGroups = 32 / LPR rows, each lane group its own row.
template <typename T, int DH> struct RowSplit {
  static constexpr int kBytes = DH * (int)sizeof(T);
  static constexpr int LPR = kBytes / 16 < 32 ? kBytes / 16 : 32;
  static constexpr int E = DH / LPR;                 // elements a lane
  static constexpr int NV = E * (int)sizeof(T) / 16; // 16-byte loads a lane
  static constexpr int kGroups = 32 / LPR;
};

__device__ __forceinline__ void unpack(const uint4* r, float* x, float) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(r);
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = __uint_as_float(w[i]);
}
// bf16 -> f32 is exact: the bf16 bits are the high half of the f32's
__device__ __forceinline__ void unpack(const uint4* r, float* x,
                                       __nv_bfloat16) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T, int NV, int E>
__device__ __forceinline__ void unpack_row(const uint4 (&r)[NV],
                                           float (&x)[E]) {
  constexpr int kPer = 16 / (int)sizeof(T);          // elements a uint4
#pragma unroll
  for (int i = 0; i < NV; ++i) unpack(&r[i], x + i * kPer, T());
}

template <int LPR>
__device__ __forceinline__ float group_allsum(float v) {
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Block (split, h, b): positions [split * chunk, min(C, (split+1) * chunk))
// of batch row b and kv head h, for the G query heads of that kv head.
// Each warp walks a contiguous run of them, kGroups rows a load, U loads a
// step, and loads the next step's rows before it computes on this step's
// (registers double-buffer the cache rows).  Each lane group keeps its own
// (m, l, acc); the groups merge through shared memory in a fixed order.
// GB >= G is the compile-time bound on G: q sits in registers when the
// (GB, E) slices are small and in shared memory when they are not; heads
// g >= G are skipped.
template <typename TQ, typename TKV, int DH, int GB>
__global__ void __launch_bounds__(kThreads)
flash_decode_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                          const TKV* __restrict__ v,
                          const uint8_t* __restrict__ valid, int KV, int G,
                          long long C, long long chunk,
                          float* __restrict__ part_ml,
                          float* __restrict__ part_acc) {
  using L = RowSplit<TKV, DH>;
  constexpr int E = L::E, NV = L::NV, LPR = L::LPR, NGR = L::kGroups;
  constexpr bool kQShared = GB * E > 32;
  constexpr int U = GB * E <= 16 ? 4 : (GB * E <= 32 ? 2 : 1);
  constexpr int kStep = U * NGR;                     // rows a warp step
  constexpr int NGT = kWarps * NGR;                  // lane groups a block
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / LPR, sub = lane % LPR;
  const long long bh = (long long)b * KV + h;
  const float sqrt_dh = sqrtf((float)DH);

  __shared__ float sm_q[kQShared ? GB : 1][kQShared ? DH : 1];
  __shared__ float sm_m[NGT][GB], sm_l[NGT][GB];
  __shared__ float sm_acc[NGT][DH];
  float qv[kQShared ? 1 : GB][kQShared ? 1 : E];
  float acc[GB][E], m[GB], l[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = kNeg;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }
  if constexpr (kQShared) {
    for (int i = threadIdx.x; i < G * DH; i += kThreads)
      sm_q[i / DH][i % DH] = to_f32(q[bh * G * DH + i]);
    __syncthreads();
  } else {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        qv[g][e] = g < G ? to_f32(q[(bh * G + g) * DH + sub * E + e]) : 0.f;
    }
  }

  const long long c_begin = (long long)split * chunk;
  const long long c_end = min(C, c_begin + chunk);
  const long long per_warp = (chunk + kWarps - 1) / kWarps;
  const long long w_begin = c_begin + warp * per_warp;
  const long long w_end = min(c_end, w_begin + per_warp);
  const long long row = (long long)KV * DH;       // elements per position
  const TKV* kb = k + ((long long)b * C * KV + h) * DH + sub * E;
  const TKV* vb = v + ((long long)b * C * KV + h) * DH + sub * E;
  const uint8_t* ok_b = valid + (long long)b * C;

  uint4 kn[U][NV], vn[U][NV];
  bool inn[U], okn[U];
  auto fetch = [&](long long c0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long c = c0 + u * NGR + grp;
      inn[u] = c < w_end;
      okn[u] = false;
#pragma unroll
      for (int i = 0; i < NV; ++i) kn[u][i] = vn[u][i] = make_uint4(0, 0, 0, 0);
      if (inn[u]) {
        const uint4* kp = reinterpret_cast<const uint4*>(kb + c * row);
        const uint4* vp = reinterpret_cast<const uint4*>(vb + c * row);
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          kn[u][i] = kp[i];
          vn[u][i] = vp[i];
        }
        okn[u] = ok_b[c] != 0;
      }
    }
  };

  if (w_begin < w_end) fetch(w_begin);
  for (long long c0 = w_begin; c0 < w_end; c0 += kStep) {
    uint4 kc[U][NV], vc[U][NV];
    bool in[U], ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      in[u] = inn[u];
      ok[u] = okn[u];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        kc[u][i] = kn[u][i];
        vc[u][i] = vn[u][i];
      }
    }
    if (c0 + kStep < w_end) fetch(c0 + kStep);     // the next step's rows

    float s[U][GB];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[E];
      unpack_row<TKV>(kc[u], kf);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g >= G) break;
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          float qe;
          if constexpr (kQShared) qe = sm_q[g][sub * E + e];
          else qe = qv[g][e];
          d = fmaf(qe, kf[e], d);
        }
        d = group_allsum<LPR>(d);
        // a masked entry scores -1e30 and takes part; a position past the
        // end of this warp's run takes no part at all
        s[u][g] = ok[u] ? d / sqrt_dh : kNeg;
      }
    }
    float p[U][GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g >= G) break;
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (in[u]) mx = fmaxf(mx, s[u][g]);
      const float corr = expf(m[g] - mx);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u][g] = in[u] ? expf(s[u][g] - mx) : 0.f;
        psum += p[u][g];
      }
      l[g] = l[g] * corr + psum;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= corr;
      m[g] = mx;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[E];
      unpack_row<TKV>(vc[u], vf);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g >= G) break;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p[u][g], vf[e], acc[g][e]);
      }
    }
  }

  // merge the block's lane groups in order, one head at a time
  const int gid = warp * NGR + grp;
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      sm_m[gid][g] = m[g];
      sm_l[gid][g] = l[g];
    }
  }
  const long long part = bh * gridDim.x + split;   // (b, h, split)
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[gid][sub * E + e] = acc[g][e];
    __syncthreads();
    float mb = sm_m[0][g];
#pragma unroll
    for (int w = 1; w < NGT; ++w) mb = fmaxf(mb, sm_m[w][g]);
    float wt[NGT];
#pragma unroll
    for (int w = 0; w < NGT; ++w) wt[w] = expf(sm_m[w][g] - mb);
    float* out_acc = part_acc + (part * G + g) * DH;
    for (int d = threadIdx.x; d < DH; d += kThreads) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < NGT; ++w) a = fmaf(sm_acc[w][d], wt[w], a);
      out_acc[d] = a;
    }
    if (threadIdx.x == 0) {
      float lb = 0.f;
#pragma unroll
      for (int w = 0; w < NGT; ++w) lb = fmaf(sm_l[w][g], wt[w], lb);
      part_ml[(part * G + g) * 2] = mb;
      part_ml[(part * G + g) * 2 + 1] = lb;
    }
    __syncthreads();
  }
}

// Block (b * KV + kv, y): elements [y * kCombineThreads, ...) of that
// (b, kv)'s (G, DH) output, one a thread: the splits' (m, l, acc) merged
// in split order with a running max (one pass, so all of a thread's loads
// are in flight together), out = acc / max(l, 1e-30).
template <typename TQ>
__global__ void __launch_bounds__(kCombineThreads)
flash_decode_combine_kernel(const float* __restrict__ part_ml,
                            const float* __restrict__ part_acc, int G, int DH,
                            int splits, TQ* __restrict__ out) {
  const long long bh = blockIdx.x;
  const int i = blockIdx.y * kCombineThreads + threadIdx.x;
  if (i >= G * DH) return;
  const int g = i / DH, d = i - g * DH;
  const float* ml = part_ml + (bh * splits * G + g) * 2;   // split stride 2G
  const float* ac = part_acc + (bh * splits * G + g) * DH + d;
  const long long sm = 2LL * G, sa = (long long)G * DH;
  float M = ml[0], L = ml[1], A = ac[0];
#pragma unroll 8
  for (int s = 1; s < splits; ++s) {
    const float m = ml[sm * s], mn = fmaxf(M, m);
    const float a = expf(M - mn), b = expf(m - mn);
    L = fmaf(L, a, ml[sm * s + 1] * b);
    A = fmaf(A, a, ac[sa * s] * b);
    M = mn;
  }
  out[(bh * G + g) * DH + d] = from_f32<TQ>(A / fmaxf(L, 1e-30f));
}

template <typename TQ, typename TKV, int DH, int GB>
int launch(const void* q, const void* k, const void* v, const uint8_t* valid,
           int B, int KV, int G, long long C, long long chunk, int splits,
           float* part_ml, float* part_acc, void* out, cudaStream_t st) {
  const dim3 grid((unsigned int)splits, (unsigned int)KV, (unsigned int)B);
  flash_decode_split_kernel<TQ, TKV, DH, GB><<<grid, kThreads, 0, st>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), valid, KV, G, C, chunk, part_ml, part_acc);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid2((unsigned int)(B * KV),
                   (unsigned int)((G * DH + kCombineThreads - 1) /
                                  kCombineThreads));
  flash_decode_combine_kernel<TQ><<<grid2, kCombineThreads, 0, st>>>(
      part_ml, part_acc, G, DH, splits, static_cast<TQ*>(out));
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV, int DH>
int by_g(const void* q, const void* k, const void* v, const uint8_t* valid,
         int B, int KV, int G, long long C, long long chunk, int splits,
         float* part_ml, float* part_acc, void* out, cudaStream_t st) {
#define K6_G(GB)                                                             \
  if (G <= GB)                                                               \
    return launch<TQ, TKV, DH, GB>(q, k, v, valid, B, KV, G, C, chunk,       \
                                   splits, part_ml, part_acc, out, st);
  K6_G(1) K6_G(2) K6_G(4) K6_G(8) K6_G(16)
#undef K6_G
  return (int)cudaErrorInvalidValue;
}

template <typename TQ, typename TKV>
int by_dh(const void* q, const void* k, const void* v, const uint8_t* valid,
          int B, int KV, int G, int dh, long long C, long long chunk,
          int splits, float* part_ml, float* part_acc, void* out,
          cudaStream_t st) {
  switch (dh) {
    case 64:
      return by_g<TQ, TKV, 64>(q, k, v, valid, B, KV, G, C, chunk, splits,
                               part_ml, part_acc, out, st);
    case 128:
      return by_g<TQ, TKV, 128>(q, k, v, valid, B, KV, G, C, chunk, splits,
                                part_ml, part_acc, out, st);
    case 256:
      return by_g<TQ, TKV, 256>(q, k, v, valid, B, KV, G, C, chunk, splits,
                                part_ml, part_acc, out, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// K6: q (B, KV, G, dh), k/v (B, C, KV, dh) contiguous, f32 (0) or bf16 (1)
// each; valid (B, C) uint8; part_ml (B * KV * splits * G * 2,) and
// part_acc (B * KV * splits * G * dh,) f32 scratch the caller allocates,
// splits = ceil(C / chunk); out (B, KV, G, dh) in q's type.  G <= 16,
// dh in {64, 128, 256}; anything else returns cudaErrorInvalidValue.
int flash_decode(const void* q, const void* k, const void* v,
                 const uint8_t* valid, int B, int KV, int G, int dh,
                 long long C, long long chunk, int splits, int q_bf16,
                 int kv_bf16, float* part_ml, float* part_acc, void* out,
                 cudaStream_t st) {
  if (G < 1 || G > 16 || B < 1 || KV < 1 || C < 1 || chunk < 1 ||
      splits != (int)((C + chunk - 1) / chunk))
    return (int)cudaErrorInvalidValue;
#define K6_T(TQ, TKV)                                                        \
  return by_dh<TQ, TKV>(q, k, v, valid, B, KV, G, dh, C, chunk, splits,      \
                        part_ml, part_acc, out, st);
  if (!q_bf16 && !kv_bf16) { K6_T(float, float) }
  if (!q_bf16 && kv_bf16) { K6_T(float, __nv_bfloat16) }
  if (q_bf16 && !kv_bf16) { K6_T(__nv_bfloat16, float) }
  K6_T(__nv_bfloat16, __nv_bfloat16)
#undef K6_T
}

}  // extern "C"
