// The gather stages of the seed search for Hopper (sm_90a), one thread
// per lane: FM backward search (FS1), SA decode (FS2) and packed
// verification (FS3). Each reproduces its plain-torch version in
// soap3dp_tpu_torch/fm/fmindex.py element for element.
//
// FS1, soap3dp_fm_search, replaces the XLA programs of
// soap3dp_tpu/fm/fmindex.py:391 `backward_search`, :456
// `backward_search_packed` and the LUT-only branch of `_search_batch`
// (soap3dp_tpu/fm/search.py:207-214); which of the three a launch
// reproduces is its `mode`, with their different edges (the LUT-only
// branch reads the A-padded k-mer at the segment start whatever the
// segment's length; the packed branch clamps the k-mer tail and the
// extension offset; the general branch clamps every base position and
// takes no LUT below lut_k bases).
// FS2, soap3dp_sa_decode, replaces `sa_decode` (fmindex.py:509): the
// bounded LF walk over the mark bitvector, then the rank and sample
// gathers (or, for an SA table split over a mesh, the rank and step
// count, which the caller routes to the slice that owns the row).
// FS3, soap3dp_verify, replaces `count_mismatches_packed`
// (fmindex.py:653): W+1 packed genome words, the funnel shift to the
// 2-bit grid, XOR with the read words, the length mask, popcount.
//
// What bounds them on this card: random 4-byte gathers into index
// tables of 1.4 GB (250 Mbp) to 8 GB (3.1 Gbp), each a 32-byte sector
// from device memory, and in FS1 and FS2 a chain of dependent gathers
// per lane (each step's rows come from the last step's counts). The
// arithmetic (a match mask, `__popc` of the 16-base BWT word) is a few
// dozen integer operations per step. Design: one thread per lane with
// the l and r chains of FS1 interleaved, read-only loads, no shared
// memory and no synchronisation, so a launch of ~0.5 M lanes keeps
// thousands of gathers in flight; a lane stops as soon as its interval
// is empty or its segment is consumed (the plain version's masked steps
// leave l and r unchanged there). The reads are read where they lie:
// packed 2-bit words or code bytes, the reverse-complement rows made on
// the fly, so nothing of the (2B, L) oriented matrix, the rolling
// 16-base codes or the packed oriented words is materialized.
// Positions, SA rows and intervals are 64-bit throughout: on a 3.1 Gbp
// index they pass 2^31. Shifts by a variable amount are guarded where
// the plain version's 64-bit shift reaches 32.
//
// Plain C interface for ctypes; each launcher returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint32_t LANES = 0x55555555u;  // one bit per 2-bit base slot
constexpr int THREADS = 256;

// where the bases of the oriented rows come from: rows 0..B-1 the
// forward reads, rows B..2B-1 their reverse complements
enum : int {
  SRC_CODES = 0,   // (B, L) uint8 codes
  SRC_PACKED = 1,  // (B, W) int32 packed words
};

// FS1 modes: the three branches of the reference's `_search_batch`
enum : int { MODE_LUT = 0, MODE_PACKED = 1, MODE_GENERAL = 2 };

struct Reads {
  const void* data;
  const int64_t* rc_len;  // (B,) bases of each reverse-complement row
  int64_t B;              // forward rows
  int kind;
  int L;                  // bases per oriented row
  int W;                  // words per packed source row
};

struct Tables {
  const int32_t* occ;     // (4 * nw,) occ[4w + c]
  const int32_t* bwt;     // (nw,) packed BWT words
  const int64_t* counts;  // (5,) the C array
  int64_t primary;        // the sentinel's row
};

__device__ __forceinline__ uint32_t u32_at(const int32_t* p, int64_t i) {
  return static_cast<uint32_t>(__ldg(p + i));
}

__device__ __forceinline__ int64_t ld64(const int64_t* p) {
  return __ldg(reinterpret_cast<const long long*>(p));
}

__device__ __forceinline__ int64_t clamp64(int64_t x, int64_t lo,
                                           int64_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// base i of forward read b
__device__ __forceinline__ uint32_t fwd_base(const Reads& s, int64_t b,
                                             int64_t i) {
  if (s.kind == SRC_CODES)
    return __ldg(static_cast<const uint8_t*>(s.data) + b * s.L + i);
  const uint32_t w =
      u32_at(static_cast<const int32_t*>(s.data), b * s.W + (i >> 4));
  return (w >> (2 * (i & 15))) & 3u;
}

// base i (0 <= i < L) of oriented row `row`, as the plain versions'
// materialized matrix holds it (fmindex.OrientedReads.matrix: a
// reverse-complement row is 3 - read[n-1-i] for i < n, else 0)
__device__ uint32_t base_at(const Reads& s, int64_t row, int64_t i) {
  if (row < s.B) return fwd_base(s, row, i);
  const int64_t b = row - s.B;
  const int64_t n = ld64(s.rc_len + b);
  if (i >= n) return 0u;
  return (3u - fwd_base(s, b, clamp64(n - 1 - i, 0, s.L - 1))) & 0xFFu;
}

// the 16 bases p..p+15 (0 <= p < L) of a row, MSB-first, 'A' past L:
// fmindex.rolling_kmer_codes(oriented, 16)[row, p]
__device__ uint32_t word16(const Reads& s, int64_t row, int64_t p) {
  const int n = static_cast<int>(s.L - p < 16 ? s.L - p : 16);
  uint32_t w = 0;
  for (int j = 0; j < n; ++j) w |= base_at(s, row, p + j) << (2 * (15 - j));
  return w;
}

// packed word j of a row (bases 16j..16j+15, LSB-first, zero past L):
// fmindex.pack_reads(oriented)[row, j]
__device__ uint32_t read_word(const Reads& s, int64_t row, int j) {
  const int64_t i0 = 16 * static_cast<int64_t>(j);
  if (i0 >= s.L) return 0u;
  const int n = static_cast<int>(s.L - i0 < 16 ? s.L - i0 : 16);
  if (s.kind == SRC_PACKED && row < s.B) {
    const uint32_t w = u32_at(static_cast<const int32_t*>(s.data),
                              row * s.W + j);
    return n == 16 ? w : w & ((1u << (2 * n)) - 1u);
  }
  uint32_t w = 0;
  for (int t = 0; t < n; ++t) w |= base_at(s, row, i0 + t) << (2 * t);
  return w;
}

// occurrences of base c in the first q (0..15) bases of a BWT word
// (q == 0: none; the plain version's 64-bit shift by 32 gives 0)
__device__ __forceinline__ uint32_t count_in_word(uint32_t word, uint32_t c,
                                                  uint32_t q) {
  const uint32_t x = word ^ (c * LANES);
  const uint32_t match = ~(x | (x >> 1)) & LANES;
  return q == 0 ? 0u : __popc(match & (LANES >> (32 - 2 * q)));
}

// C[c] + Occ(c, k), the sentinel row skipped: one bound of a backward
// extension (fmindex.backward_extend)
__device__ __forceinline__ int64_t extend(const Tables& t, uint32_t c,
                                          int64_t k, int64_t cc) {
  const int64_t kp = k - (k > t.primary ? 1 : 0);
  const int64_t w = kp >> 4;
  return cc + u32_at(t.occ, 4 * w + c) +
         count_in_word(u32_at(t.bwt, w), c, static_cast<uint32_t>(kp & 15));
}

__global__ void __launch_bounds__(THREADS)
fm_search_kernel(Reads s, int S,
                 const int64_t* __restrict__ start,
                 const int64_t* __restrict__ length, int64_t N, int mode,
                 int max_steps, int k, Tables t,
                 const int32_t* __restrict__ lut_lo,
                 const int32_t* __restrict__ lut_hi, int64_t n1,
                 int64_t* __restrict__ l_out, int64_t* __restrict__ r_out) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (i >= N) return;
  const int64_t row = i / S;
  const int64_t st = ld64(start + i);
  const int64_t len = ld64(length + i);
  const int64_t last = s.L - 1;
  if (mode == MODE_LUT) {
    const uint32_t m = word16(s, row, clamp64(st, 0, last)) >> (2 * (16 - k));
    l_out[i] = u32_at(lut_lo, m);
    r_out[i] = u32_at(lut_hi, m);
    return;
  }
  const bool can_lut = len >= k;
  uint32_t m = 0, wext = 0;
  if (mode == MODE_PACKED) {
    if (can_lut)
      m = word16(s, row, clamp64(st + len - k, 0, last)) >> (2 * (16 - k));
    wext = word16(s, row, clamp64(st, 0, last));
  } else if (can_lut) {
    const int64_t tail = st + len - k;
    for (int j = 0; j < k; ++j)
      m |= base_at(s, row, clamp64(tail + j, 0, last)) << (2 * (k - 1 - j));
  }
  int64_t l = can_lut ? static_cast<int64_t>(u32_at(lut_lo, m)) : 0;
  int64_t r = can_lut ? static_cast<int64_t>(u32_at(lut_hi, m)) : n1;
  const int64_t rem = can_lut ? len - k : len;
  const int64_t steps = rem < max_steps ? rem : max_steps;
  for (int64_t step = 0; step < steps && l < r; ++step) {
    uint32_t c;
    if (mode == MODE_PACKED)
      c = (wext >> (2 * (15 - clamp64(rem - 1 - step, 0, 15)))) & 3u;
    else
      c = base_at(s, row, clamp64(st + rem - 1 - step, 0, last));
    const int64_t cc = ld64(t.counts + c);
    const int64_t l2 = extend(t, c, l, cc);
    r = extend(t, c, r, cc);
    l = l2;
  }
  l_out[i] = l;
  r_out[i] = r;
}

__global__ void __launch_bounds__(THREADS)
sa_decode_kernel(const int64_t* __restrict__ rows,
                 const uint8_t* __restrict__ valid, int64_t N, int sa_rate,
                 const int32_t* __restrict__ mark_words,
                 const int32_t* __restrict__ mark_rank, Tables t,
                 const int32_t* __restrict__ sa, int64_t n_sa,
                 int64_t* __restrict__ out, int64_t* __restrict__ rank_out,
                 int64_t* __restrict__ step_out) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (i >= N) return;
  const bool ok = __ldg(valid + i) != 0;
  int64_t row = ok ? ld64(rows + i) : 0;
  int64_t rank = row, t_hit = 0;
  if (sa_rate > 1) {
    // a row never found marked keeps (word 0, 0 below, step 0), as the
    // plain version's records start
    int64_t mw_hit = 0;
    uint32_t below_hit = 0;
    for (int step = 0; ok; ++step) {
      const int64_t mw = row >> 5;
      const uint32_t word = u32_at(mark_words, mw);
      const uint32_t bsel = static_cast<uint32_t>(row & 31);
      if ((word >> bsel) & 1u) {
        mw_hit = mw;
        below_hit =
            bsel == 0 ? 0u : __popc(word & (0xFFFFFFFFu >> (32 - bsel)));
        t_hit = step;
        break;
      }
      if (step == sa_rate - 1) break;  // the final probe takes no LF step
      const int64_t kp = row - (row > t.primary ? 1 : 0);
      const int64_t w = kp >> 4;
      const uint32_t word_b = u32_at(t.bwt, w);
      const uint32_t q = static_cast<uint32_t>(kp & 15);
      const uint32_t c = (word_b >> (2 * q)) & 3u;
      row = ld64(t.counts + c) + u32_at(t.occ, 4 * w + c) +
            count_in_word(word_b, c, q);
    }
    rank = static_cast<int64_t>(u32_at(mark_rank, mw_hit)) + below_hit;
  }
  if (rank_out) {
    rank_out[i] = rank;
    step_out[i] = t_hit;
    return;
  }
  const int64_t value = u32_at(sa, rank < n_sa - 1 ? rank : n_sa - 1);
  out[i] = ok ? ((value + t_hit) & 0xFFFFFFFFll) : 0;
}

__global__ void __launch_bounds__(THREADS)
verify_kernel(Reads s, const int64_t* __restrict__ rows,
              const int64_t* __restrict__ tp,
              const int64_t* __restrict__ read_len, int64_t M, int W,
              const int32_t* __restrict__ pac, int64_t n_pac,
              int64_t* __restrict__ out) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (i >= M) return;
  const int64_t row = ld64(rows + i);
  const int64_t p = ld64(tp + i);
  const int64_t len = ld64(read_len + i);
  const int64_t w0 = p >> 4;
  const uint32_t sh = 2 * static_cast<uint32_t>(p & 15);
  uint32_t lo = u32_at(pac, clamp64(w0, 0, n_pac - 1));
  int64_t total = 0;
  for (int j = 0; j < W; ++j) {
    const int64_t m = clamp64(len - 16 * static_cast<int64_t>(j), 0, 16);
    if (m == 0) break;  // this word and every later one are masked out
    const uint32_t hi = u32_at(pac, clamp64(w0 + j + 1, 0, n_pac - 1));
    const uint32_t g = sh == 0 ? lo : (lo >> sh) | (hi << (32 - sh));
    const uint32_t x = g ^ read_word(s, row, j);
    const uint32_t bits = (x | (x >> 1)) & LANES;
    total += __popc(bits & (LANES >> (32 - 2 * static_cast<uint32_t>(m))));
    lo = hi;
  }
  out[i] = total;
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + THREADS - 1) / THREADS);
}

}  // namespace

extern "C" {

int soap3dp_fm_search(const void* reads, int kind, long long B, int L, int W,
                      const int64_t* rc_len, int S,
                      const int64_t* start, const int64_t* length,
                      long long N, int mode, int max_steps, int k,
                      const int32_t* occ, const int32_t* bwt,
                      const int64_t* counts, const int32_t* lut_lo,
                      const int32_t* lut_hi, long long primary, long long n1,
                      int64_t* l_out, int64_t* r_out, void* stream) {
  const Reads s{reads, rc_len, B, kind, L, W};
  const Tables t{occ, bwt, counts, primary};
  fm_search_kernel<<<blocks_for(N), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      s, S, start, length, N, mode, max_steps, k, t, lut_lo,
      lut_hi, n1, l_out, r_out);
  return static_cast<int>(cudaGetLastError());
}

int soap3dp_sa_decode(const int64_t* rows, const uint8_t* valid, long long N,
                      int sa_rate, const int32_t* mark_words,
                      const int32_t* mark_rank, const int32_t* occ,
                      const int32_t* bwt, const int64_t* counts,
                      long long primary, const int32_t* sa, long long n_sa,
                      int64_t* out, int64_t* rank_out, int64_t* step_out,
                      void* stream) {
  const Tables t{occ, bwt, counts, primary};
  sa_decode_kernel<<<blocks_for(N), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      rows, valid, N, sa_rate, mark_words, mark_rank, t, sa, n_sa, out,
      rank_out, step_out);
  return static_cast<int>(cudaGetLastError());
}

int soap3dp_verify(const void* reads, int kind, long long B, int L, int Ws,
                   const int64_t* rc_len, const int64_t* rows,
                   const int64_t* tp, const int64_t* read_len, long long M,
                   int W, const int32_t* pac, long long n_pac, int64_t* out,
                   void* stream) {
  const Reads s{reads, rc_len, B, kind, L, Ws};
  verify_kernel<<<blocks_for(M), THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      s, rows, tp, read_len, M, W, pac, n_pac, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
