// The Elias-omega payload decode (elias_decode) for Hopper (sm_90a): the
// "elias" wire's stream of one message back to its int8 QSGD levels.
// Plain C entry point, loaded with ctypes by repro_torch/kernels/build.py;
// the Python wrapper and the plain version (the same walk on the host)
// live in repro_torch/kernels/elias.py.
//
// Replaces no TPU kernel: the JAX package decodes in jnp, a lax.scan over
// the codewords (src/repro/compress/elias.py decode_levels).  In PyTorch
// without a kernel that walk would be a launch per codeword.
//
// Stream layout (the encoder's, compress/elias.py): one triple
// omega(gap) omega(|level|) sign per nonzero level, then omega(terminal
// gap); transmitted bit j of a codeword at stream bit offset + j, omega
// groups MSB-first, stream bit b at bit b & 31 of word b >> 5.
//
// What bounds it: the stream is a prefix code, so codeword k+1 starts
// where codeword k ends, and one thread walks it; its time is the latency
// of that chain of dependent steps (a few shifts and a bit reversal a
// group, a refill from L1 every 32 bits), not bytes.  The design keeps the
// walk's state in registers (a 64-bit window of unread bits), writes only
// the nonzero levels, and gives each message (row) its own block, whose
// threads first zero the row.  A parallel decode (split points found by a
// first pass) is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// A little-endian reader of one row's stream: after refill() at least 33
// unread bits sit in buf, bit 0 next; words past the row's capacity read
// as zeros (a malformed stream then ends: omega of a 0 bit is 1, and the
// positions run past d).
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

// One Elias-omega codeword: n = 1; while the next bit is 1, the next n + 1
// bits (MSB first) are the new n; a 0 bit ends it.  -> its value, or 0 for
// a group longer than 32 bits (never in a stream of the encoder).
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

// Block r decodes row r: its threads zero the row's d levels, then thread
// 0 walks the stream and writes each nonzero level at its position.
__global__ void __launch_bounds__(kThreads)
elias_decode_kernel(const uint32_t* __restrict__ words, long long cap,
                    long long d, int8_t* __restrict__ out) {
  const long long row = blockIdx.x;
  int8_t* o = out + row * d;
  for (long long i = threadIdx.x; i < d; i += kThreads) o[i] = 0;
  __syncthreads();                 // the zeros, before thread 0's levels
  if (threadIdx.x != 0) return;
  BitReader r(words + row * cap, cap);
  long long pos = -1;
  for (;;) {
    const unsigned int g = omega(r);
    if (g == 0u || pos + (long long)g >= d) break;    // the terminal gap
    pos += g;
    const unsigned int m = omega(r);
    const unsigned int neg = r.peek() & 1u;
    r.skip(1);
    o[pos] = (int8_t)(neg ? -(int)m : (int)m);
  }
}

}  // namespace

extern "C" {

// words (rows, cap) 32-bit words of one stream a row -> out (rows, d) int8
// levels; rows >= 1, d >= 1.
int elias_decode(const uint32_t* words, long long rows, long long cap,
                 long long d, int8_t* out, cudaStream_t st) {
  elias_decode_kernel<<<(unsigned int)rows, kThreads, 0, st>>>(words, cap, d,
                                                               out);
  return (int)cudaGetLastError();
}

}  // extern "C"
