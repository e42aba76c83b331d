// Flash decode (K6) for Hopper (sm_90a): single-token GQA attention of q
// (B, KV, G, dh) against a KV cache k/v (B, C, KV, dh) with a (B, C) valid
// mask, in f32 with an online softmax.  Plain C entry point, loaded with
// ctypes by repro_torch/kernels/build.py; the Python wrapper, the split
// geometry and the plain PyTorch version live in
// repro_torch/kernels/flash_decode.py.
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
// memory bandwidth bounds it at G <= 8.  The TPU kernel walks the cache as
// a sequential grid axis and carries (m, l, acc) in VMEM scratch; blocks
// here run in parallel, and B * KV alone (64 at qwen3-1.7b with 8 slots)
// would fill under half of the 132 SMs.  So one launch splits the cache of
// each (b, kv) over kSplits blocks:
//
//   * grid (kSplits, KV, B).  Block `rank` of (b, kv) takes positions
//     [rank * per, (rank + 1) * per) clipped to C, `per` = ceil(C /
//     kSplits) rounded up to the stage tile.  A block whose range is empty contributes m = -1e30,
//     l = 0, acc = 0.
//   * K and V reach shared memory by Hopper's tensor copies
//     (cp.async.bulk.tensor, the TMA): one producer thread copies a stage
//     tile (T positions x dh of K, and of V: 8 KB, 7.5 at dh 80) with one
//     instruction for K and one for V, described by a tensor map of the
//     cache as the 4-d tensor (dh, KV, C, B) that the wrapper's call encodes
//     on the host; its completion is counted in bytes on the stage's "full"
//     mbarrier, into a ring of kStages stages.  Rows past C arrive as zeros
//     and are never read from memory.  (scripts/kernel_variants.py times
//     one cp.async.bulk a row against this.)
//   * Four consumer warps take every tile, each a quarter of its rows, and
//     release the stage on its "empty" mbarrier.  A row is read by a group
//     of LPR lanes, two 16-byte vectors a lane where G <= 4 (sub and
//     sub + LPR: no bank conflicts); a row of 10 or 20 vectors (dh 80) by
//     16 or 32 lanes, one vector a lane, the rest idle.  The G partial
//     sums q . k of a row are reduced and scattered over the group (about
//     G shuffles, not G log2(LPR)), so each lane ends up owning one head:
//     one IEEE division and one expf a row and lane, where an all-reduce
//     would repeat them for every head in every lane.  The owners keep the
//     running (m, l) of their heads; p and the rescale factor reach the
//     other lanes by shuffles, and the accumulators are rescaled only when
//     some head's running max of the warp grew (exp(0) = 1 otherwise, so
//     skipping changes no bit).  The mask bytes of a tile, read with plain
//     loads (rows of C bytes are not 16-byte aligned), are loaded one tile
//     ahead.
//   * After the last tile the lane groups of a warp merge by butterfly
//     shuffles, the four warps' states merge through shared memory in warp
//     order, and the block writes its (m, l, acc[G][dh]) to its slot of a
//     workspace; one thread fences the block's writes and draws a ticket of
//     (b, kv); the block that draws the last one merges the kSplits slots
//     in rank order with the running-max formula, writes out and puts the
//     ticket back to 0.  (A merge inside a cluster of the kSplits blocks
//     measured slower at the serving shape, where this kernel's registers
//     leave room for fewer clusters than the shape launches:
//     scripts/kernel_variants.py, cluster_merge.)
//
// So there is one launch, the workspace and tickets are the wrapper's and
// kept, and the only atomic counts blocks: the result is the same from
// run to run.  The cache may have any length C >= 1 (the TPU kernel asked
// for C % 512 == 0).  No tensor cores: at G <= 8 the kernel is bound by
// bytes, and a bf16 or TF32 product would round the f32 q.
//
// Built WITHOUT --use_fast_math: the scale is an IEEE division and the
// exponentials are expf, as in the plain version.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSplits = 8;           // blocks a (b, kv)
constexpr int kConsumerWarps = 4;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;   // + one producer warp
constexpr int kStages = 4;           // ring depth
constexpr int kStageBytes = 8192;    // K + V of one stage tile
constexpr int kDefaultSmem = 48 * 1024;
constexpr float kNeg = -1e30f;       // a masked score, the TPU kernel's NEG
constexpr uint64_t kWaitNs = 4000000000ull;   // 4 s

// ---- mbarriers and tensor copies (PTX) -----------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
// Wait until the phase of parity `parity` has completed.  A wait that
// outlasts kWaitNs traps (the launch fails with an error) rather than hang
// the card: no stage of a correct pipeline waits that long.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  uint64_t t0 = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (t0 == 0) t0 = now;
    else if (now - t0 > kWaitNs) __trap();
  }
}
// T rows of dh elements of kv head h, positions c.., batch row b, of the
// 4-d (dh, KV, C, B) tensor `map` describes, to this block's shared
// memory; completion counted on `bar`.  Rows past C arrive as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int h, int c, int b,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(0),
         "r"(h), "r"(c), "r"(b), "r"(smem_addr(bar))
      : "memory");
}
// the consumer warps' own barrier (id 1; id 0 is __syncthreads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

// ---- types ---------------------------------------------------------------
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

__device__ __forceinline__ void unpack(const uint4& r, float* x, float) {
  x[0] = __uint_as_float(r.x);
  x[1] = __uint_as_float(r.y);
  x[2] = __uint_as_float(r.z);
  x[3] = __uint_as_float(r.w);
}
// bf16 -> f32 is exact: the bf16 bits are the high half of the f32's
__device__ __forceinline__ void unpack(const uint4& r, float* x,
                                       __nv_bfloat16) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The geometry of one instantiation.  GB >= G is the compile-time bound on
// the query heads a kv head; heads g >= G get q = 0 and are never written.
template <typename TQ, typename TKV, int DH, int GB> struct Geo {
  static constexpr int kRow = DH * (int)sizeof(TKV);     // bytes a cache row
  static constexpr int EPV = 16 / (int)sizeof(TKV);      // elements a vector
  static constexpr int VPR = kRow / 16;                  // vectors a row
  // a row of a power of two of vectors (dh 64, 128, 256) is read by a group
  // of LPR lanes, NV 16-byte vectors a lane (lane sub holds vectors sub,
  // sub + LPR, ...: E elements): two a lane while the GB x E accumulator
  // stays small, so a group spans fewer lanes.  Any other row (dh 80: 10
  // vectors in bf16, 20 in f32) is read one vector a lane by the next power
  // of two of lanes, and the lanes sub >= VPR hold no vector: their partial
  // sums are zeros and they write nothing (kPad), so the reduce-scatter's
  // xor shuffles still span a power of two
  static constexpr bool kPow2 = (VPR & (VPR - 1)) == 0;
  static constexpr int NV = !kPow2 ? 1 : (GB <= 4 || kRow > 512) ? 2 : 1;
  static constexpr int LPR = kPow2 ? VPR / NV : VPR <= 8 ? 8
                             : VPR <= 16 ? 16 : 32;
  static constexpr bool kPad = NV * LPR != VPR;
  static constexpr int E = NV * EPV;
  static constexpr int NGR = 32 / LPR;                   // rows a warp load
  // positions a tile: the rows of K and V an 8 KB stage holds, cut to a
  // whole number of the consumer warps' loads (a cut only where kPad: 25 ->
  // 24 at dh 80 over bf16; 12 over f32 stays)
  static constexpr int T = kStageBytes / (2 * kRow) / (kConsumerWarps * NGR)
                           * (kConsumerWarps * NGR);
  static constexpr int U = T / (kConsumerWarps * NGR);   // rows a group a tile
  // after the reduce-scatter of the GB partial sums a lane owns HPL heads,
  // and a head's owner lanes are SPAN apart
  static constexpr int HPL = GB > LPR ? GB / LPR : 1;
  static constexpr int SPAN = GB > LPR ? 1 : LPR / GB;
  static constexpr bool kQShared = GB * E > 32;          // q slice in smem
  // shared memory: the ring, q, the barriers
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kQ = kQShared ? GB * DH * 4 : 0;
  static constexpr int kSmem = kRing + kQ + 2 * kStages * 8;
  // a block's state in the workspace: m[GB], l[GB], acc[GB][DH]; the
  // epilogue merges the warps' states HC heads at a time through the ring
  // and the q buffer
  static constexpr int kState = 2 * GB + GB * DH;
  static constexpr int kEpi = (kRing + kQ) / (4 * kConsumerWarps * (DH + 2));
  static constexpr int HC = kEpi >= GB ? GB : kEpi >= 8 ? 8 : kEpi >= 4 ? 4
                            : kEpi >= 2 ? 2 : 1;

  static_assert(kRow % 32 == 0 && LPR >= 1 && LPR <= 32, "lanes a row");
  static_assert(T % (kConsumerWarps * NGR) == 0 && U >= 1, "rows");
  static_assert(E % 2 == 0 && GB <= 16, "two partial sums a lane");
  static_assert(HC >= 1 && kEpi >= HC && GB % HC == 0, "epilogue chunks");
  static_assert(!kPad || (NV == 1 && VPR <= LPR), "padded rows");
  static_assert(T * kRow % 128 == 0, "V's tile on a 128-byte boundary");

  // whether lane sub of a group holds vector i of a row
  static __device__ __forceinline__ bool has(int sub, int i) {
    return !kPad || sub + i * LPR < VPR;
  }
};

// Vector i of lane sub's share of a row (the row's vectors at p), as f32
// into x[i * EPV ..]; zeros where the lane holds no such vector (kPad).
template <typename L, typename TKV>
__device__ __forceinline__ void load_vec(const uint4* p, int sub, int i,
                                         float* x) {
  if (L::has(sub, i)) {
    unpack(p[sub + i * L::LPR], x + i * L::EPV, TKV());
  } else {
#pragma unroll
    for (int j = 0; j < L::EPV; ++j) x[i * L::EPV + j] = 0.f;
  }
}

// q . k partial sums of GB heads over the LPR lanes of a group, reduced and
// scattered: on return d[j], j < HPL, is the full sum of head sub / SPAN
// (GB <= LPR) or sub * HPL + j (GB > LPR).  At each of the first log2(GB)
// levels a lane keeps one half of its heads and adds its partner's partial
// sums of that half; the levels after that add the one head's sums.  That
// is about GB + log2(LPR / GB) shuffles a row, where an all-reduce of
// every head takes GB log2(LPR).
template <int H, int OFF, int GB>
__device__ __forceinline__ void reduce_scatter(float (&d)[GB], int sub) {
  if constexpr (OFF > 0) {
    if constexpr (H > 1) {
      const bool up = (sub & OFF) != 0;
#pragma unroll
      for (int j = 0; j < H / 2; ++j) {
        const float keep = up ? d[j + H / 2] : d[j];
        const float send = up ? d[j] : d[j + H / 2];
        d[j] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      reduce_scatter<H / 2, OFF / 2, GB>(d, sub);
    } else {
      d[0] += __shfl_xor_sync(0xffffffffu, d[0], OFF);
      reduce_scatter<1, OFF / 2, GB>(d, sub);
    }
  }
}

template <typename TQ, typename TKV, int DH, int GB>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const __grid_constant__ CUtensorMap tmk,
                    const __grid_constant__ CUtensorMap tmv,
                    const TQ* __restrict__ q,
                    const uint8_t* __restrict__ valid, int KV, int G,
                    long long C, long long per, float* __restrict__ ws,
                    unsigned int* __restrict__ tickets,
                    TQ* __restrict__ out) {
  using L = Geo<TQ, TKV, DH, GB>;
  constexpr int T = L::T, E = L::E, NV = L::NV, LPR = L::LPR, NGR = L::NGR;
  constexpr int U = L::U, EPV = L::EPV, HPL = L::HPL, SPAN = L::SPAN;
  const int rank = blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long bh = (long long)b * KV + h;

  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  float* sq = reinterpret_cast<float*>(smem + L::kRing);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kRing + L::kQ);
  uint64_t* empty = full + kStages;
  float* st = reinterpret_cast<float*>(ring);   // the epilogue's buffer

  const long long lo = min(C, (long long)rank * per);
  const long long hi = min(C, lo + per);
  const int ntiles = (int)((hi - lo + T - 1) / T);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---- producer: one tensor copy of T rows of K and one of V a stage;
    // rows past C are zero-filled by the copy engine, never read --------
    if (lane == 0) {
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kStages;
        mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        const int c0 = (int)(lo + (long long)t * T);
        unsigned char* kt = ring + s * kStageBytes;
        mbar_expect_tx(&full[s], 2u * T * L::kRow);
        tma_load_4d(kt, &tmk, h, c0, b, &full[s]);
        tma_load_4d(kt + T * L::kRow, &tmv, h, c0, b, &full[s]);
      }
    }
    __syncwarp();
  } else {
    // ---- consumers: lane group grp of warp w takes rows
    // (u * kConsumerWarps + w) * NGR + grp of each tile, u < U.  Each lane
    // accumulates acc[g] over its E elements of dh for every head; the
    // running (m, l) of a head live in its owner lanes ---------------------
    const int grp = lane / LPR, sub = lane % LPR;
    const int base = lane - sub;                   // the group's lane 0
    const float sqrt_dh = sqrtf((float)DH);
    const uint8_t* ok_b = valid + (long long)b * C;
    auto owner = [&](int g) {                      // a lane owning head g
      return base + (GB > LPR ? g / HPL : g * SPAN);
    };
    // q in f32, heads g >= G zero; element of vector i, entry j of a lane:
    // (sub + i * LPR) * EPV + j
    float qv[L::kQShared ? 1 : GB][L::kQShared ? 1 : E];
    if constexpr (L::kQShared) {
      for (int i = tid; i < GB * DH; i += kConsumers)
        sq[i] = i < G * DH ? to_f32(q[bh * G * DH + i]) : 0.f;
      consumers_sync();
    } else {
#pragma unroll
      for (int g = 0; g < GB; ++g) {
#pragma unroll
        for (int i = 0; i < NV; ++i) {
#pragma unroll
          for (int j = 0; j < EPV; ++j)
            qv[g][i * EPV + j] =
                g < G && L::has(sub, i)
                    ? to_f32(q[(bh * G + g) * DH + (sub + i * LPR) * EPV + j])
                    : 0.f;
        }
      }
    }
    float acc[GB][E], m[HPL], l[HPL];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < HPL; ++j) {
      m[j] = kNeg;
      l[j] = 0.f;
    }
    // the mask bytes of the next tile are loaded one tile ahead
    auto row_of = [&](int u) { return (u * kConsumerWarps + warp) * NGR + grp; };
    bool okn[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long c = lo + row_of(u);
      okn[u] = ntiles > 0 && c < hi && ok_b[c] != 0;
    }
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % kStages;
      const long long c0 = lo + (long long)t * T;
      bool ok[U], in[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        ok[u] = okn[u];
        in[u] = c0 + row_of(u) < hi;
        const long long cn = c0 + T + row_of(u);
        okn[u] = cn < hi && ok_b[cn] != 0;
      }
      const TKV* kt = reinterpret_cast<const TKV*>(ring + s * kStageBytes);
      const TKV* vt = kt + T * DH;
      mbar_wait(&full[s], (t / kStages) & 1);

      // the scores of the group's rows for its own heads
      float sc[U][HPL];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const uint4* kp = reinterpret_cast<const uint4*>(kt + row_of(u) * DH);
        float kf[E];
#pragma unroll
        for (int i = 0; i < NV; ++i) load_vec<L, TKV>(kp, sub, i, kf);
        float d[GB];
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          float d0 = 0.f, d1 = 0.f;
#pragma unroll
          for (int i = 0; i < NV; ++i) {
#pragma unroll
            for (int j = 0; j < EPV; j += 2) {
              float q0, q1;
              if constexpr (L::kQShared) {
                const bool on = L::has(sub, i);
                q0 = on ? sq[g * DH + (sub + i * LPR) * EPV + j] : 0.f;
                q1 = on ? sq[g * DH + (sub + i * LPR) * EPV + j + 1] : 0.f;
              } else {
                q0 = qv[g][i * EPV + j];
                q1 = qv[g][i * EPV + j + 1];
              }
              d0 = fmaf(q0, kf[i * EPV + j], d0);
              d1 = fmaf(q1, kf[i * EPV + j + 1], d1);
            }
          }
          d[g] = d0 + d1;
        }
        reduce_scatter<GB, LPR / 2, GB>(d, sub);
        // a masked entry scores -1e30 and takes part; a row past the
        // block's range scores -inf and takes no part at all
#pragma unroll
        for (int j = 0; j < HPL; ++j)
          sc[u][j] = in[u] ? (ok[u] ? d[j] / sqrt_dh : kNeg) : -INFINITY;
      }
      // the running max of the owned heads; the accumulators are rescaled
      // only when some head's max of the warp grew (exp(0) = 1 elsewhere)
      float mx[HPL];
      bool grow = false;
#pragma unroll
      for (int j = 0; j < HPL; ++j) {
        mx[j] = m[j];
#pragma unroll
        for (int u = 0; u < U; ++u) mx[j] = fmaxf(mx[j], sc[u][j]);
        grow |= mx[j] > m[j];
      }
      if (__any_sync(0xffffffffu, grow)) {
        float corr[HPL];
#pragma unroll
        for (int j = 0; j < HPL; ++j) {
          corr[j] = expf(m[j] - mx[j]);
          l[j] *= corr[j];
          m[j] = mx[j];
        }
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          const float c = __shfl_sync(0xffffffffu, corr[g % HPL], owner(g));
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] *= c;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int j = 0; j < HPL; ++j) {
          sc[u][j] = expf(sc[u][j] - m[j]);          // p; 0 past the range
          l[j] += sc[u][j];
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const uint4* vp = reinterpret_cast<const uint4*>(vt + row_of(u) * DH);
        float vf[E];
#pragma unroll
        for (int i = 0; i < NV; ++i) load_vec<L, TKV>(vp, sub, i, vf);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          const float p = __shfl_sync(0xffffffffu, sc[u][g % HPL], owner(g));
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // ---- the block's state: every lane takes its group's (m, l) of each
    // head from the owners; the groups of a warp are merged by butterfly
    // shuffles (the lower group first), then the warps in order ----------
    float mg[GB], lg[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      mg[g] = __shfl_sync(0xffffffffu, m[g % HPL], owner(g));
      lg[g] = __shfl_sync(0xffffffffu, l[g % HPL], owner(g));
    }
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1) {
      const bool low = (lane & off) == 0;
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const float mo = __shfl_xor_sync(0xffffffffu, mg[g], off);
        const float lo_ = __shfl_xor_sync(0xffffffffu, lg[g], off);
        const float ma = low ? mg[g] : mo, mb = low ? mo : mg[g];
        const float mn = fmaxf(ma, mb);
        const float ea = expf(ma - mn), eb = expf(mb - mn);
        const float la = low ? lg[g] : lo_, lb = low ? lo_ : lg[g];
        lg[g] = la * ea + lb * eb;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
          const float aa = low ? acc[g][e] : ao, ab = low ? ao : acc[g][e];
          acc[g][e] = aa * ea + ab * eb;
        }
        mg[g] = mn;
      }
    }
    // the four warps' states, HC heads at a time, through the ring and the
    // q buffer (free now: every tile's copies completed before its
    // consumers read it), merged in warp order into this block's slot of
    // the workspace: m[GB], l[GB], acc[GB][DH]
    constexpr int HC = L::HC;
    constexpr int WS = HC * (DH + 2);            // one warp's chunk, floats
    float* slot = ws + (bh * kSplits + rank) * L::kState;
#pragma unroll
    for (int c = 0; c < GB / HC; ++c) {
      consumers_sync();
      float* mine = st + warp * WS;              // [m HC][l HC][acc HC][DH]
#pragma unroll
      for (int g = c * HC; g < (c + 1) * HC; ++g) {
        const int gl = g - c * HC;
        if (grp == 0) {
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            if (!L::has(sub, i)) continue;
#pragma unroll
            for (int j = 0; j < EPV; ++j)
              mine[2 * HC + gl * DH + (sub + i * LPR) * EPV + j] =
                  acc[g][i * EPV + j];
          }
        }
        if (lane == 0) {
          mine[gl] = mg[g];
          mine[HC + gl] = lg[g];
        }
      }
      consumers_sync();
      for (int i = tid; i < HC * DH; i += kConsumers) {
        const int gl = i / DH;
        float M = st[gl];
#pragma unroll
        for (int w = 1; w < kConsumerWarps; ++w) M = fmaxf(M, st[w * WS + gl]);
        float A = 0.f, Lw = 0.f;
#pragma unroll
        for (int w = 0; w < kConsumerWarps; ++w) {
          const float e = expf(st[w * WS + gl] - M);
          A = fmaf(st[w * WS + 2 * HC + i], e, A);
          Lw = fmaf(st[w * WS + HC + gl], e, Lw);
        }
        slot[2 * GB + c * HC * DH + i] = A;
        if (i % DH == 0) {
          slot[c * HC + gl] = M;
          slot[GB + c * HC + gl] = Lw;
        }
      }
    }
  }

  // ---- the merge of the kSplits blocks of (b, kv) in rank order, with the
  // running-max formula, into out -----------------------------------------
  const int ne = G * DH;
  auto merge = [&](auto part, int i) {       // part(r, k): rank r's slot[k]
    const int g = i / DH;
    float M = 0.f, Lr = 0.f, A = 0.f;
#pragma unroll
    for (int r = 0; r < kSplits; ++r) {
      const float mr = part(r, g), lr = part(r, GB + g);
      const float ar = part(r, 2 * GB + i);
      if (r == 0) {
        M = mr;
        Lr = lr;
        A = ar;
      } else {
        const float mn = fmaxf(M, mr);
        const float ea = expf(M - mn), eb = expf(mr - mn);
        Lr = fmaf(Lr, ea, lr * eb);
        A = fmaf(A, ea, ar * eb);
        M = mn;
      }
    }
    out[bh * ne + i] = from_f32<TQ>(A / fmaxf(Lr, 1e-30f));
  };
  {
    // the block's state is in its workspace slot: take a ticket of (b, kv)
    // (one thread fences the block's writes first); the block drawing the
    // last one merges the slots and puts the ticket back to 0
    __shared__ bool s_last;
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
    if (tid == 0) tickets[bh] = 0u;
  }
}

// The dynamic shared memory limit raised past 48 KB where the instantiation
// needs it.
template <typename TQ, typename TKV, int DH, int GB>
cudaError_t configure() {
  using L = Geo<TQ, TKV, DH, GB>;
  if (L::kSmem <= kDefaultSmem) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_decode_kernel<TQ, TKV, DH, GB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) cudaGetLastError();   // the next launch must not see it
  return err;
}

// libcuda's cuTensorMapEncodeTiled, reached through the runtime's entry
// point lookup, so the library needs no link against libcuda; null if the
// installed libcuda lacks it.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    cudaGetLastError();
    return found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// The tensor map of a cache k or v (B, C, KV, DH) as the 4-d tensor
// (DH, KV, C, B), innermost first, whose box is one stage tile: DH x 1 x T
// x 1, no swizzle, out-of-range rows filled with zeros.
template <typename TKV, int DH, int T>
cudaError_t cache_map(CUtensorMap* map, const void* base, int B, int KV,
                      long long C) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t el = sizeof(TKV);
  const cuuint64_t dims[4] = {(cuuint64_t)DH, (cuuint64_t)KV, (cuuint64_t)C,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {DH * el, (cuuint64_t)KV * DH * el,
                                 (cuuint64_t)C * KV * DH * el};
  const cuuint32_t box[4] = {(cuuint32_t)DH, 1, (cuuint32_t)T, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map, sizeof(TKV) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      4, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename TQ_, typename TKV_, int DH_, int GB_> struct Inst {
  using TQ = TQ_;
  using TKV = TKV_;
  static constexpr int DH = DH_, GB = GB_;
};

// f(Inst<TQ, TKV, DH, GB>{}) for the instantiation that takes (q type,
// cache type, dh, G): GB is the least of {1, 2, 4, 8, 16} at or above G.
template <typename TQ, typename TKV, int DH, typename F>
int by_g(int G, F&& f) {
  if (G <= 1) return f(Inst<TQ, TKV, DH, 1>{});
  if (G <= 2) return f(Inst<TQ, TKV, DH, 2>{});
  if (G <= 4) return f(Inst<TQ, TKV, DH, 4>{});
  if (G <= 8) return f(Inst<TQ, TKV, DH, 8>{});
  if (G <= 16) return f(Inst<TQ, TKV, DH, 16>{});
  return (int)cudaErrorInvalidValue;
}

template <typename TQ, typename TKV, typename F>
int by_dh(int dh, int G, F&& f) {
  switch (dh) {
    case 64: return by_g<TQ, TKV, 64>(G, f);
    case 80: return by_g<TQ, TKV, 80>(G, f);
    case 128: return by_g<TQ, TKV, 128>(G, f);
    case 256: return by_g<TQ, TKV, 256>(G, f);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename F>
int dispatch(int q_bf16, int kv_bf16, int dh, int G, F&& f) {
  if (G < 1) return (int)cudaErrorInvalidValue;
  if (!q_bf16 && !kv_bf16) return by_dh<float, float>(dh, G, f);
  if (!q_bf16 && kv_bf16) return by_dh<float, __nv_bfloat16>(dh, G, f);
  if (q_bf16 && !kv_bf16) return by_dh<__nv_bfloat16, float>(dh, G, f);
  return by_dh<__nv_bfloat16, __nv_bfloat16>(dh, G, f);
}

}  // namespace

extern "C" {

// K6: q (B, KV, G, dh), k/v (B, C, KV, dh) contiguous and 16-byte aligned,
// f32 (0) or bf16 (1) each; valid (B, C) uint8; out (B, KV, G, dh) in q's
// type.  A block takes per = ceil(C / 8) positions rounded up to the
// instantiation's tile T (Geo: 8192 / (2 * dh * sizeof(cache element))
// positions, cut to a whole number of warp loads at dh 80;
// flash_decode_tile reports it).  ws (ws_floats) and tickets (n_tickets,
// zeros) are the caller's, kept from call to call: B * KV * 8 * (2 * GB + GB * dh) floats
// and B * KV tickets, GB the least power of two >= G; the kernel leaves the
// tickets zero.  G <= 16, dh in {64, 80, 128, 256}; anything else returns
// cudaErrorInvalidValue, a launch the card refuses its error.
int flash_decode(const void* q, const void* k, const void* v,
                 const uint8_t* valid, int B, int KV, int G, int dh,
                 long long C, int q_bf16, int kv_bf16,
                 float* ws, long long ws_floats, unsigned int* tickets,
                 long long n_tickets, void* out, cudaStream_t st) {
  if (B < 1 || KV < 1 || C < 1) return (int)cudaErrorInvalidValue;
  return dispatch(q_bf16, kv_bf16, dh, G, [&](auto inst) -> int {
    using I = decltype(inst);
    using TQ = typename I::TQ;
    using TKV = typename I::TKV;
    using L = Geo<TQ, TKV, I::DH, I::GB>;
    // a block's positions: ceil(C / kSplits) rounded up to the tile
    const long long per =
        ((C + kSplits - 1) / kSplits + L::T - 1) / L::T * L::T;
    if (ws_floats < (long long)B * KV * kSplits * L::kState ||
        n_tickets < (long long)B * KV)
      return (int)cudaErrorInvalidValue;
    CUtensorMap tmk, tmv;
    cudaError_t err = cache_map<TKV, I::DH, L::T>(&tmk, k, B, KV, C);
    if (err == cudaSuccess) err = cache_map<TKV, I::DH, L::T>(&tmv, v, B, KV, C);
    if (err != cudaSuccess) return (int)err;
    err = configure<TQ, TKV, I::DH, I::GB>();
    if (err != cudaSuccess) return (int)err;
    flash_decode_kernel<TQ, TKV, I::DH, I::GB>
        <<<dim3(kSplits, (unsigned int)KV, (unsigned int)B), kThreads,
           L::kSmem, st>>>(tmk, tmv, static_cast<const TQ*>(q), valid, KV, G,
                           C, per, ws, tickets, static_cast<TQ*>(out));
    return (int)cudaGetLastError();
  });
}

// The positions a stage tile of K6's instantiation for (q type, cache
// type, dh, G) holds (Geo::T), into *tile; returns the CUDA error.
int flash_decode_tile(int G, int dh, int q_bf16, int kv_bf16, int* tile) {
  return dispatch(q_bf16, kv_bf16, dh, G, [&](auto inst) -> int {
    using I = decltype(inst);
    *tile = Geo<typename I::TQ, typename I::TKV, I::DH, I::GB>::T;
    return (int)cudaSuccess;
  });
}

// How many blocks of K6's instantiation for (q type, cache type, dh, G)
// one SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// into *blocks; returns the CUDA error.
int flash_decode_blocks_per_sm(int G, int dh, int q_bf16, int kv_bf16,
                               int* blocks) {
  return dispatch(q_bf16, kv_bf16, dh, G, [&](auto inst) -> int {
    using I = decltype(inst);
    using L = Geo<typename I::TQ, typename I::TKV, I::DH, I::GB>;
    cudaError_t err = configure<typename I::TQ, typename I::TKV, I::DH, I::GB>();
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks,
        flash_decode_kernel<typename I::TQ, typename I::TKV, I::DH, I::GB>,
        kThreads, L::kSmem);
    const cudaError_t last = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : last);
  });
}

}  // extern "C"
