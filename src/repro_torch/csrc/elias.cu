// The Elias-omega payload decode (elias_decode) for Hopper (sm_90a): the
// "elias" wire's stream of one message back to its int8 QSGD levels.
// Plain C entry point, loaded with ctypes by repro_torch/kernels/build.py;
// the Python wrapper and the plain version (the sequential walk on the
// host) live in repro_torch/kernels/elias.py.
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
// What bounds it: the stream is a prefix code, so where triple k + 1
// starts is known only once triple k is read.  One thread walking a row
// (the design this replaces) took 219 ns a codeword on this card.  The
// design breaks the chain with a parallel split-point decode, in three
// launches on the caller's stream, no host synchronisation:
//   1 extent   the last nonzero word of each row (a max over its words),
//              and the rows zeroed.  Past that word every bit is 0, and a
//              walk over zero bits decodes the triple (gap 1, level 1,
//              sign +) again and again: a closed form, never walked.
//   2 tables   the stream up to the extent in chunks of kChunkBits bits.
//              A triple of an encoder stream is at most 50 bits (gap
//              codeword <= 36, |level| <= 13, sign 1), so the first triple
//              that starts in a chunk starts at one of its first kWindow
//              offsets.  A walk from each (chunk, entry offset) reads the
//              triples that start in the chunk and records where it leaves
//              it (exit offset into the next chunk) and the sum of its
//              gaps (the position advance).  An entry whose stream bit two
//              before it is 1 cannot follow a triple (a |level| codeword
//              ends in 0, then one sign bit) and is not walked; walks that
//              meet stop and link (see elias_table_kernel).  A block
//              composes its kSegChunks chunks' tables in shared memory.
//              Then the last block of the row resolves it: each segment's
//              true entry (its predecessor's one exit, nearly always) and,
//              by a block scan, its absolute position.
//   3 decode   one thread a chunk walks once from its true entry and
//              position, applies the walk's stop rule (pos + gap >= d) and
//              writes the nonzero levels; the positions past the last
//              chunk's triples take the closed-form +1 tail.
// An omega codeword is read by a 12-bit table lookup where it fits (both
// codewords of a triple from one 33-bit window), by the group loop past
// it.  Even so a walk is a chain of ~60 dependent instructions a triple,
// and the lanes of a warp walk different chunks down different branches:
// the time is the chunk walk's latency, not bytes (PERF.md).
// A row whose true chain meets a codeword group longer than 32 bits or a
// triple longer than the window (words no encoder produced) before its
// stop is finished by the sequential walk inside the decode launch and
// counted in *malformed; the result is the plain walk's on every input.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

// Shared with repro_torch/kernels/elias.py (CHUNK_BITS, WINDOW,
// SEGMENT_CHUNKS): the entry point refuses other values.
constexpr int kChunkBits = 128;
constexpr int kWindow = 50;
constexpr int kSegChunks = 8;

constexpr int kExtentWords = 1024;          // words a block of launch 1
constexpr int kExtentThreads = 256;
constexpr int kTableThreads = kSegChunks * kWindow;   // 400
constexpr int kDecodeThreads = 64;
constexpr int kLutBits = 12;                // omega decoded by lookup
constexpr unsigned char kBad = 255;         // no entry: the chain breaks
constexpr long long kMaxRows = 65535;       // grid.y

static_assert(kWindow < kBad && kWindow <= kChunkBits, "window");
static_assert(kWindow <= 64, "the constant-exit reduction is two warps");

// A little-endian reader of one row's stream from any bit, counting down
// the bits `left` before its walk's end (Span: int for a chunk's walk,
// long long for a row's): after peek() at least 33 unread bits sit in buf,
// bit 0 next; words past the row's capacity read as zeros.  Every skip
// after a peek leaves at least one bit (a triple's fast path takes at most
// 25 of the 33, a group at most 32), so one refill a peek is enough; the
// word it takes was loaded at the refill before.
template <typename Span>
struct BitReader {
  const uint32_t* __restrict__ w;
  long long cap, next;              // next: the word held in `ahead`
  unsigned long long buf;
  int have;
  unsigned int ahead;
  Span left;
  __device__ __forceinline__ unsigned int load(long long i) const {
    return i < cap ? __ldg(w + i) : 0u;
  }
  __device__ __forceinline__ BitReader(const uint32_t* w_, long long cap_,
                                       long long bit, Span span)
      : w(w_), cap(cap_), next((bit >> 5) + 1), left(span) {
    buf = (unsigned long long)load(next - 1) >> (bit & 31);
    have = 32 - (int)(bit & 31);
    ahead = load(next);
  }
  __device__ __forceinline__ unsigned int peek() {
    if (have <= 32) {
      buf |= (unsigned long long)ahead << have;
      have += 32;
      ahead = load(++next);
    }
    return (unsigned int)buf;
  }
  __device__ __forceinline__ void skip(int k) {
    buf >>= k;
    have -= k;
    left -= k;
  }
};

enum : int { kReachedEnd = 0, kLongGroup = 1, kStopRule = 2 };

constexpr unsigned int kLutMask = (1u << kLutBits) - 1u;
constexpr unsigned int kDone = 0x8000u;

// An omega codeword read from the next kLutBits bits as far as they go
// (the key, bit 0 next): its value | length << 8 | kDone where it ends
// inside them, else the last complete group's value | the bits of the
// complete groups << 8.  Built at compile time; 8 KB.
struct alignas(16) OmegaLut {
  uint16_t e[1 << kLutBits];
};

__host__ __device__ constexpr OmegaLut make_omega_lut() {
  OmegaLut t{};
  for (int key = 0; key < (1 << kLutBits); ++key) {
    unsigned int n = 1u, out = 0u;
    int used = 0;
    for (;;) {
      if (used < kLutBits && ((key >> used) & 1) == 0) {
        out = n | ((unsigned int)(used + 1) << 8) | kDone;
        break;
      }
      const int ln = (int)n + 1;
      if (used + ln > kLutBits) {
        out = n | ((unsigned int)used << 8);
        break;
      }
      unsigned int v = 0u;
      for (int i = 0; i < ln; ++i) v = (v << 1) | ((key >> (used + i)) & 1);
      n = v;
      used += ln;
    }
    t.e[key] = (uint16_t)out;
  }
  return t;
}

__device__ const OmegaLut kOmegaLut = make_omega_lut();

// Copies the table into a block's shared memory (all threads call it; a
// barrier must follow before any lookup).
__device__ __forceinline__ void copy_lut(uint16_t* lut) {
  const uint4* src = reinterpret_cast<const uint4*>(kOmegaLut.e);
  uint4* dst = reinterpret_cast<uint4*>(lut);
  for (int i = threadIdx.x; i < (1 << kLutBits) / 8; i += blockDim.x)
    dst[i] = src[i];
}

// The rest of an Elias-omega codeword whose next kLutBits bits gave the
// table entry e: n = 1; while the next bit is 1, the next n + 1 bits (MSB
// first) are the new n; a 0 bit ends it.  -> its value, or 0 for a group
// longer than 32 bits, which is left unread (the plain walk's omega;
// never in a stream of the encoder).
template <typename Span>
__device__ __forceinline__ unsigned int omega_rest(BitReader<Span>& r,
                                                   unsigned int e) {
  unsigned int n = e & 0xFFu;
  r.skip((int)((e >> 8) & 0xFu));
  if (e & kDone) return n;
  for (;;) {
    const unsigned int win = r.peek();
    if ((win & 1u) == 0u) {
      r.skip(1);
      return n;
    }
    if (n >= 32u) return 0u;
    const int ln = (int)n + 1;
    const unsigned int grp = ln == 32 ? win : (win & ((1u << ln) - 1u));
    n = __brev(grp) >> (32 - ln);
    r.skip(ln);
  }
}

// A triple whose gap or |level| codeword runs past the table's bits: the
// general omega loop (read_triple's arguments and result).
template <bool kStop, typename Span>
__device__ __forceinline__ int read_triple_slow(BitReader<Span>& r,
                                                const uint16_t* lut,
                                                unsigned int e1,
                                                unsigned int lim,
                                                unsigned int& g,
                                                unsigned int& m,
                                                unsigned int& neg) {
  g = omega_rest(r, e1);
  if (g == 0u) return kLongGroup;
  if (kStop && g >= lim) return kStopRule;
  m = omega_rest(r, lut[r.peek() & kLutMask]);
  neg = r.peek() & 1u;
  r.skip(1);
  return kReachedEnd;
}

// One triple from the reader's bit: -> kReachedEnd with its gap g, |level|
// m and sign neg (the reader past it), kLongGroup (a gap of 0: a group
// longer than 32 bits) or kStopRule (kStop: g >= lim = d - pos, the plain
// walk's stop before the level).  Where both codewords end inside the
// table's reach, one window of 33 bits holds the whole triple (<= 25
// bits): two lookups and one skip.  A |level| of 0 (a group longer than 32
// bits) leaves the reader on that group, whose first bit (1) is then read
// as the sign, as in the plain walk.
template <bool kStop, typename Span>
__device__ __forceinline__ int read_triple(BitReader<Span>& r,
                                           const uint16_t* lut,
                                           unsigned int lim, unsigned int& g,
                                           unsigned int& m,
                                           unsigned int& neg) {
  const unsigned int win = r.peek();
  const unsigned int e1 = lut[win & kLutMask];
  const int l1 = (int)((e1 >> 8) & 0xFu);
  const unsigned int e2 = lut[(win >> l1) & kLutMask];
  if (!(e1 & e2 & kDone))
    return read_triple_slow<kStop>(r, lut, e1, lim, g, m, neg);
  const int l2 = (int)((e2 >> 8) & 0xFu);
  g = e1 & 0xFFu;
  m = e2 & 0xFFu;
  neg = (win >> (l1 + l2)) & 1u;
  if (kStop && g >= lim) return kStopRule;
  r.skip(l1 + l2 + 1);
  return kReachedEnd;
}

// Decodes the triples that start before the reader's end, from its bit (a
// triple start), with the plain walk's stop rule (d < 2^31, pos < d),
// writing each level at its position.  -> kReachedEnd, or how the walk
// stopped.
template <typename Span>
__device__ __forceinline__ int walk(BitReader<Span>& r, const uint16_t* lut,
                                    int d, int8_t* __restrict__ o,
                                    int& pos) {
  while (r.left > 0) {
    unsigned int g, m, neg;
    const int how = read_triple<true>(
        r, lut, (unsigned int)d - (unsigned int)pos, g, m, neg);
    if (how != kReachedEnd) return how;
    pos += (int)g;
    o[pos] = (int8_t)(uint8_t)(neg ? 0u - m : m);
  }
  return kReachedEnd;
}

__device__ __forceinline__ unsigned int sat32(unsigned long long v) {
  return v > 0xFFFFFFFFull ? 0xFFFFFFFFu : (unsigned int)v;
}

// The lanes of this thread's warp (the block's last warp may be partial).
__device__ __forceinline__ unsigned int warp_lanes() {
  const unsigned int rest = blockDim.x - (threadIdx.x & ~31u);
  return rest >= 32u ? 0xffffffffu : (1u << rest) - 1u;
}

// The max of p[0..n) over the block (every thread gets it).
__device__ int block_max(const int* __restrict__ p, int n) {
  __shared__ int s[32];
  int m = -1;
  for (int i = threadIdx.x; i < n; i += blockDim.x) m = max(m, p[i]);
  m = __reduce_max_sync(warp_lanes(), m);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) s[wid] = m;
  __syncthreads();
  if (wid == 0) {
    m = lane < (int)((blockDim.x + 31) >> 5) ? s[lane] : -1;
    m = __reduce_max_sync(0xffffffffu, m);
    if (lane == 0) s[0] = m;
  }
  __syncthreads();
  m = s[0];
  __syncthreads();
  return m;
}

// Chunks of a row whose last nonzero word is `last` (-1: none): through
// bit 32 (last + 1), at least one.
__device__ __forceinline__ long long chunks_of(int last) {
  const long long z = 32ll * (last + 1);
  return z <= kChunkBits ? 1 : (z + kChunkBits - 1) / kChunkBits;
}

// Launch 1, grid (>= ceil(cap / kExtentWords), rows): block (b, r) writes
// the last nonzero word among row r's words [b * kExtentWords, ...) to
// part[r][b] (-1 for none); all blocks zero the rows' d levels.
__global__ void __launch_bounds__(kExtentThreads)
elias_extent_kernel(const uint32_t* __restrict__ words, long long cap,
                    int nblk, int* __restrict__ part,
                    int8_t* __restrict__ out, long long n_out) {
  const long long row = blockIdx.y;
  if ((int)blockIdx.x < nblk) {
    const uint32_t* w = words + row * cap;
    const long long lo = (long long)blockIdx.x * kExtentWords;
    const long long hi = min(lo + kExtentWords, cap);
    int last = -1;
    for (long long i = lo + threadIdx.x; i < hi; i += kExtentThreads)
      if (__ldg(w + i) != 0u) last = (int)i;
    __shared__ int s[kExtentThreads / 32];
    last = __reduce_max_sync(0xffffffffu, last);
    if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = last;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int i = 1; i < kExtentThreads / 32; ++i) last = max(last, s[i]);
      part[row * nblk + blockIdx.x] = last;
    }
  }
  const long long blk = row * gridDim.x + blockIdx.x;
  const long long stride = (long long)gridDim.x * gridDim.y * kExtentThreads;
  const long long head =
      min(n_out,
          (long long)((16u - (reinterpret_cast<uintptr_t>(out) & 15u)) & 15u));
  uint4* o4 = reinterpret_cast<uint4*>(out + head);
  const long long n16 = (n_out - head) >> 4;
  for (long long i = blk * kExtentThreads + threadIdx.x; i < n16; i += stride)
    o4[i] = make_uint4(0u, 0u, 0u, 0u);
  if (blk == 0 && threadIdx.x < 16) {
    if (threadIdx.x < head) out[threadIdx.x] = 0;
    const long long k = head + (n16 << 4) + threadIdx.x;
    if (k < n_out) out[k] = 0;
  }
}

// The resolve, by the last table block of a row (kTableThreads threads),
// kTableThreads segments at a time.  A segment's true entry is its
// predecessor's constant exit where that table sends every entry it does
// not reject to one exit (walks from wrong entries meet the true chain
// within a few triples, so nearly all do), else its predecessor's table
// at the predecessor's entry, one step a round from the left.  Each
// segment's advance from its entry, then an exclusive scan of them from
// position -1: seg_e/seg_p = each segment's entry and the position before
// it (>= d: the walk stopped before it).  The chain breaks where it
// reaches kBad at a position < d: the row is malformed.  info[r] = (chunks,
// malformed, tail start, zero-region bit); the tail of +1 levels starts
// past the last segment's position.
__device__ void resolve_row(long long row, int last, long long nseg_cap,
                            long long d, const unsigned char* comp_x,
                            const unsigned int* comp_a, const int* comp_c,
                            int* __restrict__ seg_e,
                            long long* __restrict__ seg_p,
                            long long* __restrict__ info,
                            unsigned long long* __restrict__ malformed) {
  __shared__ int ent[kTableThreads];
  __shared__ long long scan[2][kTableThreads];
  __shared__ int s_prev;
  const int t = threadIdx.x;
  const long long nch = chunks_of(last);
  const long long nseg = (nch + kSegChunks - 1) / kSegChunks;
  const long long r0 = row * nseg_cap;
  long long base = -1;                      // the position before the tile
  int bad = 0;
  for (long long k0 = 0; k0 < nseg && !bad; k0 += kTableThreads) {
    const long long k = k0 + t;
    const bool in = k < nseg;
    int e = 0;
    if (in && k > 0) e = __ldcg(comp_c + r0 + k - 1);
    ent[t] = e;
    for (;;) {                              // entries behind varying tables
      const bool open = in && e < 0;
      if (!__syncthreads_or(open)) break;
      const int pe = t > 0 ? ent[t - 1] : s_prev;
      if (open && pe >= 0)
        e = pe == kBad ? kBad : __ldcg(comp_x + (r0 + k - 1) * kWindow + pe);
      __syncthreads();
      ent[t] = e;
    }
    unsigned int a = 0u;
    int x = kBad;
    if (in && e != kBad) {
      a = __ldcg(comp_a + (r0 + k) * kWindow + e);
      x = __ldcg(comp_x + (r0 + k) * kWindow + e);
    }
    // inclusive scan of the advances over the tile (Hillis-Steele)
    int cur = 0;
    scan[0][t] = a;
    __syncthreads();
    for (int off = 1; off < kTableThreads; off <<= 1) {
      scan[cur ^ 1][t] = scan[cur][t] + (t >= off ? scan[cur][t - off] : 0);
      cur ^= 1;
      __syncthreads();
    }
    const long long p = base + scan[cur][t] - a;
    if (in) {
      seg_e[r0 + k] = e;
      seg_p[r0 + k] = p;
    }
    bad = __syncthreads_or(in && ((e == kBad && p < d) ||
                                  (x == kBad && p + (long long)a < d)));
    base += scan[cur][kTableThreads - 1];
    if (t == kTableThreads - 1) s_prev = e;
    __syncthreads();
  }
  if (t == 0) {
    info[row * 4 + 0] = nch;
    info[row * 4 + 1] = bad;
    info[row * 4 + 2] = bad ? d : min(base + 1, d);
    info[row * 4 + 3] = 32ll * (last + 1);
    if (bad) atomicAdd(malformed, 1ull);
  }
}

// A table block's shared memory for one segment: the omega table, a claim
// word for each bit of its chunks, and each walk's state.
struct TableSmem {
  uint16_t lut[1 << kLutBits];
  unsigned long long claim[kSegChunks * kChunkBits];
  long long stop_a[kTableThreads];
  unsigned int link_a[kTableThreads];
  unsigned int ta[kTableThreads];
  short link[kTableThreads];
  uint16_t item[kTableThreads];
  unsigned char rx[kTableThreads];
  unsigned char tx[kTableThreads];
  int lo[2], hi[2];
};

constexpr int kTableSmem = (int)sizeof(TableSmem);

// Launch 2, grid (gx, rows), kTableThreads: block (x, r) takes row r's
// segments x, x + gx, ...  Walk (j, e) starts chunk c = seg * kSegChunks
// + j at entry e; the candidates are packed onto the first threads.
// Walks that reach one triple start are the same walk from there on: each
// marks the triple starts it reaches (a word per bit: its advance so far
// and its index), and a walk that finds one marked stops and links to the
// walk that marked it; the links are followed once all have stopped.  (A
// plain load and store: two walks that reach a start at once both walk
// on, which costs time, not results.)  Then thread e < kWindow chases the
// segment's chunks from entry e: pre[seg][e][j] = (entry, advance) on
// reaching chunk j, comp[seg][e] = the state past the segment, and
// comp_c[seg] its one exit where every entry it keeps leads there (-1:
// several, kBad: none).  kBad marks an entry that no true chain can take
// (chunk 0 past offset 0, a bit 1 two before it) or a walk that met a gap
// group longer than 32 bits or left the chunk past the window; the row's
// last chunk has no window (the zero tail follows it).  Advances saturate
// at 2^32 - 1 (>= any d).  The block that finishes its row's segments last
// (by the row's ticket, set back to 0 after) resolves the row.
__global__ void __launch_bounds__(kTableThreads)
elias_table_kernel(const uint32_t* __restrict__ words, long long cap,
                   const int* __restrict__ part, int nblk, long long nseg_cap,
                   long long d, unsigned char* __restrict__ pre_x,
                   unsigned int* __restrict__ pre_a,
                   unsigned char* __restrict__ comp_x,
                   unsigned int* __restrict__ comp_a,
                   int* __restrict__ comp_c,
                   unsigned int* __restrict__ tickets,
                   int* __restrict__ seg_e, long long* __restrict__ seg_p,
                   long long* __restrict__ info,
                   unsigned long long* __restrict__ malformed) {
  extern __shared__ __align__(16) unsigned char smem[];    // kTableSmem
  TableSmem& sm = *reinterpret_cast<TableSmem*>(smem);
  __shared__ int n_items;
  __shared__ bool s_last;
  const int t = threadIdx.x;
  const long long row = blockIdx.y;
  const uint32_t* w = words + row * cap;
  copy_lut(sm.lut);                         // block_max's barriers publish it
  const int last = block_max(part + row * nblk, nblk);
  const long long nch = chunks_of(last);
  const long long nseg = (nch + kSegChunks - 1) / kSegChunks;
  if ((long long)blockIdx.x >= nseg) return;
  for (long long seg = blockIdx.x; seg < nseg; seg += gridDim.x) {
    {
      const int j = t / kWindow, e = t % kWindow;
      const long long c = seg * kSegChunks + j;
      const long long start = c * kChunkBits + e;
      const bool cand =
          c < nch && (c == 0 ? e == 0
                             : (((start - 2) >> 5) >= cap ||
                                ((__ldg(w + ((start - 2) >> 5)) >>
                                  ((start - 2) & 31)) & 1u) == 0u));
      for (int i = t; i < kSegChunks * kChunkBits; i += kTableThreads)
        sm.claim[i] = 0ull;
      sm.tx[t] = kBad;
      sm.ta[t] = 0u;
      if (t == 0) n_items = 0;
      __syncthreads();
      if (cand) sm.item[atomicAdd(&n_items, 1)] = (uint16_t)t;
      __syncthreads();
    }
    const int me = t < n_items ? sm.item[t] : -1;
    if (me >= 0) {
      const int j = me / kWindow;
      const long long c = seg * kSegChunks + j;
      const long long c0 = c * kChunkBits, end = c0 + kChunkBits;
      BitReader<int> r(w, cap, c0 + me % kWindow, kChunkBits - me % kWindow);
      unsigned int adv = 0u;                // saturates at 2^32 - 1
      unsigned char x = kBad;
      int lk = -1;
      unsigned int la = 0u;
      for (;;) {
        if (r.left <= 0) {                  // -left: the exit offset
          x = c == nch - 1 ? (unsigned char)0
                           : (-r.left < kWindow ? (unsigned char)(-r.left)
                                                : kBad);
          break;
        }
        // the mark of this triple start, read while the triple is
        volatile unsigned long long* cl =
            &sm.claim[j * kChunkBits + kChunkBits - r.left];
        const unsigned long long old = *cl;
        unsigned int g, m, neg;
        const int how = read_triple<false>(r, sm.lut, 0u, g, m, neg);
        if (adv != 0xFFFFFFFFu) {           // saturated advances never mark
          if (old != 0ull) {
            lk = (int)(old & 0xFFFFu) - 1;
            la = (unsigned int)(old >> 16);
            break;
          }
          *cl = ((unsigned long long)adv << 16) | (unsigned int)(me + 1);
        }
        if (how != kReachedEnd) break;      // a gap of 0
        adv = adv + g < adv ? 0xFFFFFFFFu : adv + g;
      }
      sm.rx[me] = x;
      sm.stop_a[me] = (long long)adv;
      sm.link[me] = (short)lk;
      sm.link_a[me] = la;
    }
    __syncthreads();
    // the links, followed by pointer jumping: a linked walk's stop_a holds
    // its advance past its link's, and each round adds its link's and
    // takes its link's link, until every walk points at a walk that ended
    if (me >= 0 && sm.link[me] >= 0)
      sm.stop_a[me] -= (long long)sm.link_a[me];
    for (;;) {
      __syncthreads();
      const int l = me >= 0 ? sm.link[me] : -1;
      int nl = -1;
      long long add = 0;
      unsigned char lx = 0;
      if (l >= 0) {
        nl = sm.link[l];
        add = sm.stop_a[l];
        lx = sm.rx[l];
      }
      if (!__syncthreads_or(l >= 0)) break;
      if (l >= 0) {
        sm.stop_a[me] += add;
        sm.link[me] = (short)nl;
        if (nl < 0) sm.rx[me] = lx;
      }
    }
    if (me >= 0) {
      sm.tx[me] = sm.rx[me];
      sm.ta[me] = sat32((unsigned long long)sm.stop_a[me]);
    }
    __syncthreads();
    if (t < 64) {                           // two whole warps
      int lo = kBad, hi = -1;
      if (t < kWindow) {
        const long long base = (row * nseg_cap + seg) * kWindow + t;
        const int nj =
            (int)min((long long)kSegChunks, nch - seg * kSegChunks);
        unsigned int st = t;
        unsigned long long rel = 0;
        for (int q = 0; q < nj; ++q) {
          pre_x[base * kSegChunks + q] = (unsigned char)st;
          pre_a[base * kSegChunks + q] = sat32(rel);
          if (st != kBad) {
            rel += sm.ta[q * kWindow + st];
            st = sm.tx[q * kWindow + st];
          }
        }
        comp_x[base] = (unsigned char)st;
        comp_a[base] = sat32(rel);
        if (st != kBad) lo = hi = (int)st;
      }
      lo = __reduce_min_sync(0xffffffffu, lo);
      hi = __reduce_max_sync(0xffffffffu, hi);
      if ((t & 31) == 0) {
        sm.lo[t >> 5] = lo;
        sm.hi[t >> 5] = hi;
      }
    }
    __syncthreads();
    if (t == 0) {                           // the segment's constant exit
      const int lo = min(sm.lo[0], sm.lo[1]), hi = max(sm.hi[0], sm.hi[1]);
      comp_c[row * nseg_cap + seg] = hi < 0 ? kBad : (lo == hi ? lo : -1);
    }
    __syncthreads();
  }
  __threadfence();                          // the tables, before the ticket
  __syncthreads();
  if (t == 0)
    s_last = atomicAdd(tickets + row, 1u) ==
             (unsigned int)min(nseg, (long long)gridDim.x) - 1u;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  resolve_row(row, last, nseg_cap, d, comp_x, comp_a, comp_c, seg_e, seg_p,
              info, malformed);
  if (t == 0) tickets[row] = 0u;
}

// Launch 3, grid (gx, rows), kDecodeThreads: thread (x, t) of row r walks
// chunks x * kDecodeThreads + t, + gx * kDecodeThreads, ... from their true
// entries and positions, then the row's blocks write the +1 tail.  A
// malformed row: block 0 walks it sequentially (thread 0) up to the zero
// region, then its threads write the tail; the others return.
__global__ void __launch_bounds__(kDecodeThreads)
elias_decode_kernel(const uint32_t* __restrict__ words, long long cap,
                    long long d, long long nseg_cap,
                    const unsigned char* __restrict__ pre_x,
                    const unsigned int* __restrict__ pre_a,
                    const int* __restrict__ seg_e,
                    const long long* __restrict__ seg_p,
                    const long long* __restrict__ info,
                    int8_t* __restrict__ out) {
  __shared__ __align__(16) uint16_t lut[1 << kLutBits];
  __shared__ long long s_tail;
  const long long row = blockIdx.y;
  const uint32_t* w = words + row * cap;
  int8_t* o = out + row * d;
  const long long stride = (long long)gridDim.x * kDecodeThreads;
  // the first chunk's segment state, the row's info and the table load
  // together (a segment past the row's last holds no state: unused)
  const long long c1 = (long long)blockIdx.x * kDecodeThreads + threadIdx.x;
  const long long s1 = row * nseg_cap + min(c1 / kSegChunks, nseg_cap - 1);
  const long long p1 = seg_p[s1];
  const int e1 = seg_e[s1];
  const long long nch = info[row * 4 + 0];
  const long long bad = info[row * 4 + 1];
  const long long tail = info[row * 4 + 2];
  copy_lut(lut);
  __syncthreads();
  if (bad) {
    if (blockIdx.x != 0) return;
    if (threadIdx.x == 0) {
      BitReader<long long> r(w, cap, 0, info[row * 4 + 3]);
      int pos = -1;
      const int how = walk(r, lut, (int)d, o, pos);
      s_tail = how == kReachedEnd ? min(pos + 1ll, d) : d;
    }
    __syncthreads();
    for (long long i = s_tail + threadIdx.x; i < d; i += kDecodeThreads)
      o[i] = 1;
    return;
  }
  for (long long c = c1; c < nch; c += stride) {
    const long long seg = row * nseg_cap + c / kSegChunks;
    const long long p0 = c == c1 ? p1 : seg_p[seg];
    if (p0 >= d) continue;
    const long long idx =
        (seg * kWindow + (c == c1 ? e1 : seg_e[seg])) * kSegChunks +
        c % kSegChunks;
    const long long p = p0 + (long long)pre_a[idx];
    if (p >= d) continue;
    const int e = pre_x[idx];
    BitReader<int> r(w, cap, c * kChunkBits + e, kChunkBits - e);
    int pos = (int)p;
    walk(r, lut, (int)d, o, pos);
  }
  for (long long i = tail + c1; i < d; i += stride) o[i] = 1;
}

struct Layout {
  long long nblk, nch_cap, nseg_cap;
  long long part, pre_x, pre_a, comp_x, comp_a, comp_c, seg_e, seg_p, info,
      bytes;
};

long long up16(long long v) { return (v + 15) & ~15ll; }

Layout layout(long long rows, long long cap) {
  Layout L;
  L.nblk = (cap + kExtentWords - 1) / kExtentWords;
  L.nch_cap = (cap * 32 + kChunkBits - 1) / kChunkBits;
  L.nseg_cap = (L.nch_cap + kSegChunks - 1) / kSegChunks;
  const long long ent = rows * L.nseg_cap * kWindow;
  long long off = 0;
  L.part = off;   off += up16(rows * L.nblk * 4);
  L.pre_x = off;  off += up16(ent * kSegChunks);
  L.pre_a = off;  off += up16(ent * kSegChunks * 4);
  L.comp_x = off; off += up16(ent);
  L.comp_a = off; off += up16(ent * 4);
  L.comp_c = off; off += up16(rows * L.nseg_cap * 4);
  L.seg_e = off;  off += up16(rows * L.nseg_cap * 4);
  L.seg_p = off;  off += up16(rows * L.nseg_cap * 8);
  L.info = off;   off += up16(rows * 4 * 8);
  L.bytes = off;
  return L;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n < 1)
      n = 132;
  }
  return n;
}

}  // namespace

extern "C" {

// Bytes of scratch elias_decode wants for (rows, cap).
long long elias_decode_scratch_bytes(long long rows, long long cap) {
  return layout(rows, cap).bytes;
}

// words (rows, cap) 32-bit words of one stream a row -> out (rows, d) int8
// levels; rows >= 1, 1 <= cap < 2^31, 1 <= d < 2^31.
// chunk_bits, window, seg_chunks: the caller's constants, which must be
// this source's.  scratch: elias_decode_scratch_bytes(rows, cap) bytes,
// 16-byte aligned; *malformed gains one for each row decoded by the
// sequential walk.  tickets: min(rows, 65,535) zeroed ints, left zeroed.
// Three launches on st; no host synchronisation.
int elias_decode(const uint32_t* words, long long rows, long long cap,
                 long long d, int chunk_bits, int window, int seg_chunks,
                 void* scratch, unsigned int* tickets,
                 unsigned long long* malformed, int8_t* out, cudaStream_t st) {
  if (chunk_bits != kChunkBits || window != kWindow ||
      seg_chunks != kSegChunks || rows < 1 || cap < 1 || cap >= (1ll << 31) ||
      d < 1 || d >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t smem_ok = cudaFuncSetAttribute(
      elias_table_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kTableSmem);
  if (smem_ok != cudaSuccess) return (int)smem_ok;
  static int table_blocks = 0;              // table blocks an SM holds
  if (table_blocks == 0 &&
      (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &table_blocks, elias_table_kernel, kTableThreads, kTableSmem) !=
           cudaSuccess ||
       table_blocks < 1))
    table_blocks = 1;
  const Layout L = layout(rows, cap);
  char* s = static_cast<char*>(scratch);
  const int sms = sm_count();
  for (long long r0 = 0; r0 < rows; r0 += kMaxRows) {
    const long long nr = std::min(kMaxRows, rows - r0);
    const uint32_t* wr = words + r0 * cap;
    int8_t* orow = out + r0 * d;
    int* part = reinterpret_cast<int*>(s + L.part) + r0 * L.nblk;
    const long long seg0 = r0 * L.nseg_cap;
    unsigned char* pre_x =
        reinterpret_cast<unsigned char*>(s + L.pre_x) + seg0 * kWindow *
                                                            kSegChunks;
    unsigned int* pre_a =
        reinterpret_cast<unsigned int*>(s + L.pre_a) + seg0 * kWindow *
                                                           kSegChunks;
    unsigned char* comp_x =
        reinterpret_cast<unsigned char*>(s + L.comp_x) + seg0 * kWindow;
    unsigned int* comp_a =
        reinterpret_cast<unsigned int*>(s + L.comp_a) + seg0 * kWindow;
    int* comp_c = reinterpret_cast<int*>(s + L.comp_c) + seg0;
    int* seg_e = reinterpret_cast<int*>(s + L.seg_e) + seg0;
    long long* seg_p = reinterpret_cast<long long*>(s + L.seg_p) + seg0;
    long long* info = reinterpret_cast<long long*>(s + L.info) + r0 * 4;
    const long long fill_blocks =
        std::min(4096ll, (nr * d + 16 * kExtentThreads - 1) /
                             (16 * kExtentThreads));
    const dim3 g1((unsigned int)std::max(L.nblk, (fill_blocks + nr - 1) / nr),
                  (unsigned int)nr);
    elias_extent_kernel<<<g1, kExtentThreads, 0, st>>>(
        wr, cap, (int)L.nblk, part, orow, nr * d);
    const long long gx2 =
        std::max(1ll, std::min(L.nseg_cap, (table_blocks * sms) / nr));
    elias_table_kernel<<<dim3((unsigned int)gx2, (unsigned int)nr),
                         kTableThreads, kTableSmem, st>>>(
        wr, cap, part, (int)L.nblk, L.nseg_cap, d, pre_x, pre_a, comp_x,
        comp_a, comp_c, tickets, seg_e, seg_p, info, malformed);
    const long long gx4 = std::max(
        1ll, std::min((L.nch_cap + kDecodeThreads - 1) / kDecodeThreads,
                      (8ll * sms + nr - 1) / nr));
    elias_decode_kernel<<<dim3((unsigned int)gx4, (unsigned int)nr),
                          kDecodeThreads, 0, st>>>(
        wr, cap, d, L.nseg_cap, pre_x, pre_a, seg_e, seg_p, info, orow);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
