// The gather stages of the seed search for Hopper (sm_90a), one thread
// per lane or slot: FM backward search (FS1), SA decode (FS2, with the
// lane expansions of the search and of the DP seeding), packed
// verification (FS3) and the hash dedupe (FS4). Each reproduces its
// plain-torch version in soap3dp_tpu_torch/fm/fmindex.py element for
// element.
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
// FS2 replaces `sa_decode` (fmindex.py:509): the bounded LF walk over
// the mark bitvector, then the rank and sample gathers (or, for an SA
// table split over a mesh, the rank and step count, which the caller
// routes to the slice that owns the row). Three entries share the walk:
// soap3dp_sa_decode decodes ready rows; soap3dp_expand_decode (FS2x)
// also does the lane expansion of the reference's `_search_batch`
// (soap3dp_tpu/fm/search.py:247-273): output slot k belongs to the
// first lane whose inclusive count exceeds k (a binary search in the
// counts' cumsum, whose upper levels the slots of a block share in L1),
// decodes row l[lane] + (k - the lane's offset), and writes the hash
// dedupe's keys (oriented row, text position, or the sentinel where the
// placement leaves the text) directly; soap3dp_seed_expand_decode
// (FS2s) does the same expansion for the DP seeding
// (soap3dp_tpu/pipeline/dp_rescue.py:176-188, whose (lanes, occ_cap)
// slot mask and nonzero give the same slot order) and writes its
// candidates (oriented row, read start, valid). The three forms are one
// template (expand_slot).
// FS4, soap3dp_dedupe, replaces the scatter-min hash dedupe of the
// reference's `_search_batch` (soap3dp_tpu/fm/search.py:275-301) and
// the nonzero of its first occurrences: five short passes (clear the
// table, atomicMax of K - k into it, the first test with a ballot word
// a warp and a count a block, one block's scan of the counts, the
// ordered write), no sort and no library scan. What bounds it: the
// table's random atomics and reads (4 MB at round 1's K, L2-resident)
// and the gathers of the winners' keys; the keys and outputs stream.
// FS3, soap3dp_verify, replaces `count_mismatches_packed`
// (fmindex.py:653): W+1 packed genome words, the funnel shift to the
// 2-bit grid, XOR with the read words, the length mask, popcount. What
// bounds it: the latency of its gathers (the genome words at a random
// place of the ~60 MB to ~0.8 GB pac, then the read's row), a few
// hundred bytes a placement. Design: one thread a placement with every
// load issued at once (the kernel is templated on the words, 8 or 16,
// so the loops unroll and masks replace the early exit): the genome
// window as two or three aligned 16-byte vectors, the read's packed row
// as whole vectors, and a reverse-complement word made in registers from
// two of the row's words (a funnel shift, the bases reversed and
// complemented) where it was 16 loads of single bases; code bytes and
// other widths keep the word-at-a-time form (verify_kernel_any).
// Placements of one read share its row in L1, not in registers.
//
// What bounds them on this card: random gathers into index tables of
// about 1 GB (250 Mbp) to 5 GB (3.1 Gbp), each a 32-byte sector from
// device memory, and in FS1 and FS2 a chain of dependent gathers per
// lane (each step's rows come from the last step's counts). The
// arithmetic (a match mask, popcounts of 16-base BWT words) is a few
// dozen integer operations per step. So the index holds its occ counts
// and BWT on the card as occ blocks (fmindex.occ_block_table): one
// 32-byte block per 64 BWT positions, the four counts before it and its
// four BWT words, so one FM bound or LF step is one sector where
// separate occ and BWT tables cost two, and FS1 fetches r's block only
// when it is not l's (after the LUT jumpstart an interval of a few rows
// mostly lies in one block). One
// thread per lane with the l and r chains interleaved, read-only loads,
// no shared memory and no synchronisation, so a launch of ~0.5 M lanes
// keeps thousands of gathers in flight; a lane stops as soon as its
// interval is empty or its segment is consumed (the plain version's
// masked steps leave l and r unchanged there). The reads are read where
// they lie: packed 2-bit words (a 16-base window inside a row is two
// loads and a funnel shift) or code bytes, the reverse-complement rows
// made on the fly, so nothing of the (2B, L) oriented matrix, the
// rolling 16-base codes or the packed oriented words is materialized.
// Positions, SA rows and intervals are 64-bit throughout: on a 3.1 Gbp
// index they pass 2^31. Shifts by a variable amount are guarded where
// the plain version's 64-bit shift reaches 32.
//
// Plain C interface for ctypes; each launcher returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint32_t LANES = 0x55555555u;  // one bit per 2-bit base slot
constexpr int64_t MASK32 = 0xFFFFFFFFll;
constexpr int64_t SENTINEL = 0xFFFFFFFFll;  // fm/search.py SENTINEL
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
  const uint4* blocks;    // (nb, 8) occ blocks, two uint4 each
  const int64_t* counts;  // (5,) the C array
  int64_t primary;        // the sentinel's row
};

// what FS2's walk reads besides the occ blocks
struct Marks {
  const int32_t* words;   // (nmw,) the SA-sample bitvector
  const int32_t* rank;    // (nmw,) exclusive rank of each word
  const int32_t* sa;      // the samples
  int64_t n_sa;
  int sa_rate;
};

// one occ block: the counts of bases 0-3 before BWT position 64j, then
// the BWT words 4j..4j+3
struct Block {
  uint4 occ;
  uint4 bwt;
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

// forward bases q..q+15 of packed read b (q + 16 <= L), LSB-first: the
// funnel of the one or two words that hold them
__device__ __forceinline__ uint32_t packed_window(const Reads& s, int64_t b,
                                                  int64_t q) {
  const int32_t* words = static_cast<const int32_t*>(s.data) + b * s.W;
  const uint32_t sh = 2 * static_cast<uint32_t>(q & 15);
  const uint32_t lo = u32_at(words, q >> 4);
  if (sh == 0) return lo;
  return (lo >> sh) | (u32_at(words, (q >> 4) + 1) << (32 - sh));
}

// the 2-bit bases of a word in reverse order
__device__ __forceinline__ uint32_t reverse_bases(uint32_t w) {
  const uint32_t x = __brev(w);
  return ((x >> 1) & LANES) | ((x & LANES) << 1);
}

// the 16 bases p..p+15 (0 <= p < L) of a row, MSB-first, 'A' past L:
// fmindex.rolling_kmer_codes(oriented, 16)[row, p]. From packed words
// two loads where the 16 bases lie inside the row (a reverse-complement
// row's bases p..p+15 are the complements of forward bases
// n-16-p..n-1-p, whose LSB-first window is already in MSB-first order),
// else base by base.
__device__ uint32_t word16(const Reads& s, int64_t row, int64_t p) {
  if (s.kind == SRC_PACKED) {
    if (row < s.B) {
      if (p + 16 <= s.L) return reverse_bases(packed_window(s, row, p));
    } else {
      const int64_t n = ld64(s.rc_len + row - s.B);
      if (n <= s.L && p + 16 <= n)
        return ~packed_window(s, row - s.B, n - 16 - p);
    }
  }
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

// the lane mask of the first q (0..15) bases of a word (q == 0: none;
// the plain version's 64-bit shift by 32 gives 0)
__device__ __forceinline__ uint32_t first_bases(uint32_t q) {
  return q == 0 ? 0u : LANES >> (32 - 2 * q);
}

// the bits of the first nb bases of a word (all of them past 16, none
// at nb <= 0)
__device__ __forceinline__ uint32_t base_bits(int64_t nb) {
  return nb <= 0 ? 0u : (nb >= 16 ? 0xFFFFFFFFu : (1u << (2 * nb)) - 1u);
}

// one bit per base of `word` equal to c
__device__ __forceinline__ uint32_t match_bits(uint32_t word, uint32_t c) {
  const uint32_t x = word ^ (c * LANES);
  return ~(x | (x >> 1)) & LANES;
}

__device__ __forceinline__ uint32_t pick(const uint4& v, uint32_t i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// the sentinel row skipped: the BWT position of row k
__device__ __forceinline__ int64_t bwt_pos(const Tables& t, int64_t k) {
  return k - (k > t.primary ? 1 : 0);
}

__device__ __forceinline__ Block load_block(const Tables& t, int64_t kp) {
  const uint4* p = t.blocks + 2 * (kp >> 6);
  return Block{__ldg(p), __ldg(p + 1)};
}

// c's matches in BWT word i of a block, below the within-block offset
// (full words before word fw, the first q bases of word fw, none after)
__device__ __forceinline__ int64_t word_occ(uint32_t word, uint32_t c,
                                            uint32_t i, uint32_t fw,
                                            uint32_t part) {
  const uint32_t mask = i < fw ? LANES : (i == fw ? part : 0u);
  return __popc(match_bits(word, c) & mask);
}

// Occ(c, kp) for BWT position kp in block b: the block's count of c plus
// c's matches in its words below kp (fmindex.occ)
__device__ __forceinline__ int64_t block_occ(const Block& b, uint32_t c,
                                             int64_t kp) {
  const uint32_t within = static_cast<uint32_t>(kp & 63);
  const uint32_t fw = within >> 4;
  const uint32_t part = first_bases(within & 15);
  return static_cast<int64_t>(pick(b.occ, c)) +
         word_occ(b.bwt.x, c, 0, fw, part) +
         word_occ(b.bwt.y, c, 1, fw, part) +
         word_occ(b.bwt.z, c, 2, fw, part) +
         word_occ(b.bwt.w, c, 3, fw, part);
}

// one LF step of SA row `row` (fmindex.lf_step)
__device__ __forceinline__ int64_t lf_step(const Tables& t, int64_t row) {
  const int64_t kp = bwt_pos(t, row);
  const Block b = load_block(t, kp);
  const uint32_t word = pick(b.bwt, static_cast<uint32_t>((kp >> 4) & 3));
  const uint32_t c = (word >> (2 * (kp & 15))) & 3u;
  return ld64(t.counts + c) + block_occ(b, c, kp);
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
    if (tail >= 0 && tail + k <= s.L) {
      m = word16(s, row, tail) >> (2 * (16 - k));
    } else {
      for (int j = 0; j < k; ++j)
        m |= base_at(s, row, clamp64(tail + j, 0, last)) << (2 * (k - 1 - j));
    }
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
    const int64_t kl = bwt_pos(t, l), kr = bwt_pos(t, r);
    const Block bl = load_block(t, kl);
    const Block br = (kr >> 6) == (kl >> 6) ? bl : load_block(t, kr);
    l = cc + block_occ(bl, c, kl);
    r = cc + block_occ(br, c, kr);
  }
  l_out[i] = l;
  r_out[i] = r;
}

struct Ranked {
  int64_t rank;  // the sample's rank (the row itself at sa_rate 1)
  int64_t step;  // LF steps to the first marked row
};

// the bounded LF walk of SA row `row` to its first marked row; a row
// that is not `ok` (or never found marked) keeps (word 0, 0 below, step
// 0), as the plain version's records start
__device__ Ranked walk(const Marks& mk, const Tables& t, int64_t row,
                       bool ok) {
  if (mk.sa_rate == 1) return Ranked{ok ? row : 0, 0};
  int64_t mw_hit = 0, t_hit = 0;
  uint32_t below_hit = 0;
  for (int step = 0; ok; ++step) {
    const int64_t mw = row >> 5;
    const uint32_t word = u32_at(mk.words, mw);
    const uint32_t bsel = static_cast<uint32_t>(row & 31);
    if ((word >> bsel) & 1u) {
      mw_hit = mw;
      below_hit = bsel == 0 ? 0u : __popc(word & (0xFFFFFFFFu >> (32 - bsel)));
      t_hit = step;
      break;
    }
    if (step == mk.sa_rate - 1) break;  // the final probe takes no LF step
    row = lf_step(t, row);
  }
  return Ranked{static_cast<int64_t>(u32_at(mk.rank, mw_hit)) + below_hit,
                t_hit};
}

// the text position of a walked row: its sample plus the steps, mod 2^32
__device__ __forceinline__ int64_t position(const Marks& mk,
                                            const Ranked& rk) {
  const int64_t value = u32_at(mk.sa, rk.rank < mk.n_sa - 1 ? rk.rank
                                                            : mk.n_sa - 1);
  return (value + rk.step) & MASK32;
}

__global__ void __launch_bounds__(THREADS)
sa_decode_kernel(const int64_t* __restrict__ rows,
                 const uint8_t* __restrict__ valid, int64_t N, Marks mk,
                 Tables t, int64_t* __restrict__ out,
                 int64_t* __restrict__ rank_out,
                 int64_t* __restrict__ step_out) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (i >= N) return;
  const bool ok = __ldg(valid + i) != 0;
  const Ranked rk = walk(mk, t, ok ? ld64(rows + i) : 0, ok);
  if (rank_out) {
    rank_out[i] = rk.rank;
    step_out[i] = rk.step;
    return;
  }
  out[i] = ok ? position(mk, rk) : 0;
}

// the lanes of a lane expansion: lane j (row j / S) owns the slots
// incl[j - 1] .. incl[j] - 1, slot k of them SA row lo[j] + k - incl[j - 1]
struct Lanes {
  const int64_t* lo;     // (RS,) each lane's SA interval start
  const int64_t* incl;   // (RS,) the inclusive cumsum of the lanes' counts
  const int64_t* start;  // (RS,) each lane's segment (seed) start in its row
  const int64_t* olens;  // (RS / S,) each row's read length (the search's)
  int64_t RS;
  int64_t n;             // the text's length
  int S;                 // lanes a row
};

// what an expansion writes for each slot, by its form
struct Slots {
  int64_t* a;     // krow | row | lane
  int64_t* b;     // ktp | pos | rank
  uint8_t* ok;    // pos_ok | valid | -
  int64_t* step;  // - | - | LF steps
};

// the three forms: the search's dedupe keys (FS2x), the DP seeding's
// candidates (FS2s), and, for an SA table split over a mesh, each slot's
// lane, sample rank and steps, whose samples the owner routing gathers
enum : int { OUT_KEYS = 0, OUT_SEED = 1, OUT_RANKS = 2 };

// slot k of the expansion, decoded and written in form OUT
template <int OUT>
__device__ __forceinline__ void expand_slot(const Lanes& e, const Marks& mk,
                                            const Tables& t, const Slots& o,
                                            int64_t k) {
  const bool live = k < ld64(e.incl + e.RS - 1);
  int64_t lane = 0, row = 0;
  if (live) {
    // the first lane whose inclusive count exceeds k: it holds slot k
    int64_t a = 0, b = e.RS - 1;
    while (a < b) {
      const int64_t m = (a + b) >> 1;
      if (ld64(e.incl + m) > k)
        b = m;
      else
        a = m + 1;
    }
    lane = a;
    row = ld64(e.lo + lane) + k - (lane ? ld64(e.incl + lane - 1) : 0);
  }
  const Ranked rk = walk(mk, t, row, live);
  if (OUT == OUT_RANKS) {
    o.a[k] = lane;
    o.b[k] = rk.rank;
    o.step[k] = rk.step;
    return;
  }
  const int64_t pos = live ? position(mk, rk) : 0;
  const int64_t st = ld64(e.start + lane);
  const int64_t orow = lane / e.S;
  if (OUT == OUT_SEED) {
    // dp_rescue._seed_cand_batch: the read's start, no test of its end;
    // a slot past the total keeps row 0 (lane 0's)
    const bool ok = live && pos >= st;
    o.a[k] = orow;
    o.b[k] = ok ? pos - st : 0;
    o.ok[k] = ok ? 1 : 0;
    return;
  }
  const int64_t tp = pos - st;
  const bool ok = live && pos >= st && tp + ld64(e.olens + orow) <= e.n;
  o.a[k] = ok ? orow : SENTINEL;
  o.b[k] = ok ? (tp & MASK32) : SENTINEL;
  o.ok[k] = ok ? 1 : 0;
}

// FS2x: the search's lane expansion (OUT_KEYS or OUT_RANKS)
template <int OUT>
__global__ void __launch_bounds__(THREADS)
expand_decode_kernel(Lanes e, int64_t K, Marks mk, Tables t, Slots o) {
  const int64_t k = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (k < K) expand_slot<OUT>(e, mk, t, o, k);
}

// FS2s: the DP seeding's lane expansion (OUT_SEED or OUT_RANKS)
template <int OUT>
__global__ void __launch_bounds__(THREADS)
seed_expand_kernel(Lanes e, int64_t K, Marks mk, Tables t, Slots o) {
  const int64_t k = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (k < K) expand_slot<OUT>(e, mk, t, o, k);
}

// FS4, the hash dedupe of the search's keys (krow, ktp, pos_ok). Slot k
// with pos_ok hashes to table slot hslot (dedupe_slot); the table keeps
// K - k of the least such k (atomicMax of K - k in a table of zeros, so
// the winner does not depend on the order of the atomics); k is a first
// unless the winner is another slot with the same key. The firsts are
// one ballot word a warp and a count a block; one block scans the
// counts; the last pass writes the first K2 firsts, in ascending k, by
// their ranks.
constexpr uint32_t HASH_ROW = 0x9E3779B1u;
constexpr uint32_t HASH_TP = 0x85EBCA77u;
constexpr uint32_t HASH_MIX = 0xC2B2AE3Du;
constexpr int64_t ROW_SENTINEL = 0x7FFFFFFFll;  // fm/search.py ROW_SENTINEL
constexpr int SCAN_THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr uint32_t FULL = 0xFFFFFFFFu;

// the table slot of a key (32-bit products, as fmindex.mul32)
__device__ __forceinline__ uint32_t dedupe_slot(int64_t row, int64_t tp,
                                                int hb) {
  const uint32_t h = (static_cast<uint32_t>(row) * HASH_ROW) ^
                     (static_cast<uint32_t>(tp) * HASH_TP);
  return (h * HASH_MIX) >> (32 - hb);
}

__global__ void __launch_bounds__(THREADS)
dedupe_clear_kernel(uint4* __restrict__ table, int64_t n4) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (i < n4) table[i] = make_uint4(0u, 0u, 0u, 0u);
}

__global__ void __launch_bounds__(THREADS)
dedupe_scatter_kernel(const int64_t* __restrict__ krow,
                      const int64_t* __restrict__ ktp,
                      const uint8_t* __restrict__ pos_ok, int64_t K, int hb,
                      int32_t* __restrict__ table) {
  const int64_t k = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (k >= K || !__ldg(pos_ok + k)) return;
  atomicMax(table + dedupe_slot(ld64(krow + k), ld64(ktp + k), hb),
            static_cast<int32_t>(K - k));
}

// whether each slot is a first: bits (one ballot word a warp of slots)
// and the block's count of firsts
__global__ void __launch_bounds__(THREADS)
dedupe_first_kernel(const int64_t* __restrict__ krow,
                    const int64_t* __restrict__ ktp,
                    const uint8_t* __restrict__ pos_ok, int64_t K, int hb,
                    const int32_t* __restrict__ table,
                    uint32_t* __restrict__ bits,
                    int32_t* __restrict__ counts) {
  __shared__ int32_t warp_n[WARPS];
  const int64_t k = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  bool first = false;
  if (k < K && __ldg(pos_ok + k)) {
    const int64_t row = ld64(krow + k), tp = ld64(ktp + k);
    const int64_t won = K - __ldg(table + dedupe_slot(row, tp, hb));
    const int64_t w = won < K - 1 ? won : K - 1;
    first = w == k || ld64(krow + w) != row || ld64(ktp + w) != tp;
  }
  const uint32_t ballot = __ballot_sync(FULL, first);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    if (k < K) bits[k >> 5] = ballot;  // lane 0 holds the warp's first slot
    warp_n[warp] = __popc(ballot);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t n = 0;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) n += warp_n[i];
    counts[blockIdx.x] = n;
  }
}

// the inclusive scan of x over a warp
__device__ __forceinline__ int32_t warp_scan(int32_t x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// one block: the exclusive offsets of the nb block counts, 1024 at a
// time with the running carry, and their total (uniq)
__global__ void __launch_bounds__(SCAN_THREADS)
dedupe_scan_kernel(const int32_t* __restrict__ counts, int64_t nb,
                   int32_t* __restrict__ offsets, int64_t* __restrict__ uniq) {
  __shared__ int32_t warp_sum[SCAN_THREADS / 32];
  __shared__ int32_t carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int64_t base = 0; base < nb; base += SCAN_THREADS) {
    const int64_t i = base + threadIdx.x;
    const int32_t v = i < nb ? counts[i] : 0;
    const int32_t x = warp_scan(v, lane);
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) warp_sum[lane] = warp_scan(warp_sum[lane], lane);
    __syncthreads();
    if (i < nb) offsets[i] = carry + (warp ? warp_sum[warp - 1] : 0) + x - v;
    __syncthreads();
    if (threadIdx.x == 0) carry += warp_sum[SCAN_THREADS / 32 - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) *uniq = carry;
}

// the firsts of rank < K2 to their output slots, and the slots past the
// firsts filled as the plain version's gathers of slot 0 fill them
__global__ void __launch_bounds__(THREADS)
dedupe_write_kernel(const int64_t* __restrict__ krow,
                    const int64_t* __restrict__ ktp, int64_t K, int64_t K2,
                    const uint32_t* __restrict__ bits,
                    const int32_t* __restrict__ offsets,
                    const int64_t* __restrict__ uniq,
                    int64_t* __restrict__ urow, int64_t* __restrict__ utp,
                    uint8_t* __restrict__ uvalid) {
  __shared__ int32_t warp_n[WARPS];
  const int64_t k = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t word = k - lane < K ? __ldg(bits + (k >> 5)) : 0u;
  if (lane == 0) warp_n[warp] = __popc(word);
  __syncthreads();
  if ((word >> lane) & 1u) {
    int64_t rank = __ldg(offsets + blockIdx.x) +
                   __popc(word & ((1u << lane) - 1u));
    for (int i = 0; i < warp; ++i) rank += warp_n[i];
    if (rank < K2) {
      urow[rank] = ld64(krow + k);
      utp[rank] = ld64(ktp + k);
      uvalid[rank] = 1;
    }
  }
  const int64_t u = ld64(uniq);
  const int64_t tp0 = ld64(ktp);
  for (int64_t j = k; j < K2; j += gridDim.x * static_cast<int64_t>(THREADS))
    if (j >= u) {
      urow[j] = ROW_SENTINEL;
      utp[j] = tp0;
      uvalid[j] = 0;
    }
}

// count_mismatches_packed of placement i over W words: the genome word
// j (0 <= j < W) funnel-shifted from gw[j], gw[j + 1] to the 2-bit
// grid, against read word j, over the first read_len bases
__device__ __forceinline__ int64_t mismatches(uint32_t glo, uint32_t ghi,
                                              uint32_t sh, uint32_t rw,
                                              int64_t len, int j) {
  const int64_t m = clamp64(len - 16 * static_cast<int64_t>(j), 0, 16);
  const uint32_t x = __funnelshift_r(glo, ghi, sh) ^ rw;
  const uint32_t bits = (x | (x >> 1)) & LANES;
  return __popc(bits & first_bases(static_cast<uint32_t>(m)));
}

// e[y] = e[y + s] (0 past the end), a barrel shift of registers by a
// runtime s < N, one stage a bit of s
template <int BIT, int N>
__device__ __forceinline__ void shift_down(uint32_t (&e)[N], int s) {
  if constexpr (BIT < N) {
    const bool on = (s & BIT) != 0;
#pragma unroll
    for (int y = 0; y + BIT < N; ++y) e[y] = on ? e[y + BIT] : e[y];
#pragma unroll
    for (int y = N - BIT; y < N; ++y) e[y] = on ? 0u : e[y];
    shift_down<2 * BIT, N>(e, s);
  }
}

// FS3 for any W: the words one at a time (the read's base by base for
// code bytes and for reverse complements longer than L)
__global__ void __launch_bounds__(THREADS)
verify_kernel_any(Reads s, const int64_t* __restrict__ rows,
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
  for (int j = 0; j < W && len > 16 * static_cast<int64_t>(j); ++j) {
    const uint32_t hi = u32_at(pac, clamp64(w0 + j + 1, 0, n_pac - 1));
    total += mismatches(lo, hi, sh, read_word(s, row, j), len, j);
    lo = hi;
  }
  out[i] = total;
}

// FS3 for W <= NW and rows of L <= 16 NW bases, every load issued at
// once. A packed row is one to NW words (two 16-byte loads at L = 120);
// word j of its reverse complement of n <= L bases holds the complements
// of forward bases n-16-16j .. n-1-16j in reverse order, the window of
// words k = n/16 - 1 - j and k + 1 (k = -1: the bases below 0, zero)
// funnel-shifted by 2 (n % 16), reversed and complemented, its bases
// past n zero (not 3, the complement of the zero past the read). The
// genome's W + 1 words come as aligned 16-byte vectors (at most
// NW/4 + 2 of them) where they lie inside pac, else word by word with
// the index clamped to the last word.
template <int NW>
__global__ void __launch_bounds__(THREADS)
verify_kernel(Reads s, const int64_t* __restrict__ rows,
              const int64_t* __restrict__ tp,
              const int64_t* __restrict__ read_len, int64_t M, int W,
              const int32_t* __restrict__ pac, int64_t n_pac,
              int64_t* __restrict__ out) {
  constexpr int NG = (NW + 7) / 4;  // vectors covering NW + 1 words
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (i >= M) return;
  const int64_t row = ld64(rows + i);
  const int64_t p = ld64(tp + i);
  const int64_t len = ld64(read_len + i);

  // the genome: words w0 .. w0 + NW (only those up to w0 + W are used)
  const int64_t w0 = p >> 4;
  uint32_t gw[NW + 1];
  const int64_t a = w0 & ~3ll;
  if (w0 >= 0 && a + 4 * NG <= n_pac &&
      (reinterpret_cast<uintptr_t>(pac) & 15) == 0) {
    uint32_t v[4 * NG];
    const uint4* pv = reinterpret_cast<const uint4*>(pac + a);
#pragma unroll
    for (int q = 0; q < NG; ++q) {
      const uint4 x = __ldg(pv + q);
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
    const int o = static_cast<int>(w0 & 3);
#pragma unroll
    for (int x = 0; x <= NW; ++x)
      gw[x] = o == 0 ? v[x]
                     : (o == 1 ? v[x + 1] : (o == 2 ? v[x + 2] : v[x + 3]));
  } else {
#pragma unroll
    for (int x = 0; x <= NW; ++x)
      gw[x] = x <= W ? u32_at(pac, clamp64(w0 + x, 0, n_pac - 1)) : 0u;
  }

  // the read's words
  uint32_t rw[NW];
  const bool fwd = row < s.B;
  const int64_t b = fwd ? row : row - s.B;
  const int64_t n = fwd ? 0 : ld64(s.rc_len + b);
  if (s.kind == SRC_PACKED && (fwd || n <= s.L)) {
    uint32_t sw[NW];  // the stored row's words 0 .. NW-1, zero past W
    const int32_t* src = static_cast<const int32_t*>(s.data) + b * s.W;
    if ((s.W & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
#pragma unroll
      for (int q = 0; q < NW / 4; ++q) {
        const uint4 x = 4 * q < s.W
                            ? __ldg(reinterpret_cast<const uint4*>(src) + q)
                            : make_uint4(0, 0, 0, 0);
        sw[4 * q] = x.x;
        sw[4 * q + 1] = x.y;
        sw[4 * q + 2] = x.z;
        sw[4 * q + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int q = 0; q < NW; ++q) sw[q] = q < s.W ? u32_at(src, q) : 0u;
    }
    if (fwd) {
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        const int64_t nb = s.L - 16 * j;  // bases of word j inside L
        rw[j] = sw[j] & base_bits(nb);
      }
    } else {
      // e[y] = ext[NW + 1 - y], ext[x] = word x - 1 (0 at x = 0, NW + 1);
      // shifted left by NW - n/16: e[t] = ext[n/16 + 1 - t], so word j
      // is the funnel of e[j + 1] (low) and e[j] (high)
      uint32_t e[NW + 2];
#pragma unroll
      for (int y = 0; y <= NW + 1; ++y)
        e[y] = (y == 0 || y == NW + 1) ? 0u : sw[NW - y];
      shift_down<1>(e, NW - static_cast<int>(n >> 4));
      const uint32_t shr = 2 * static_cast<uint32_t>(n & 15);
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        const int64_t m = n - 16 * j;  // bases of word j inside n
        rw[j] = ~reverse_bases(__funnelshift_r(e[j + 1], e[j], shr)) &
                base_bits(m);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < NW; ++j) rw[j] = j < W ? read_word(s, row, j) : 0u;
  }

  const uint32_t sh = 2 * static_cast<uint32_t>(p & 15);
  int64_t total = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j)
    if (j < W) total += mismatches(gw[j], gw[j + 1], sh, rw[j], len, j);
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
                      const int32_t* blocks, const int64_t* counts,
                      const int32_t* lut_lo, const int32_t* lut_hi,
                      long long primary, long long n1,
                      int64_t* l_out, int64_t* r_out, void* stream) {
  const Reads s{reads, rc_len, B, kind, L, W};
  const Tables t{reinterpret_cast<const uint4*>(blocks), counts, primary};
  fm_search_kernel<<<blocks_for(N), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      s, S, start, length, N, mode, max_steps, k, t, lut_lo,
      lut_hi, n1, l_out, r_out);
  return static_cast<int>(cudaGetLastError());
}

int soap3dp_sa_decode(const int64_t* rows, const uint8_t* valid, long long N,
                      int sa_rate, const int32_t* mark_words,
                      const int32_t* mark_rank, const int32_t* blocks,
                      const int64_t* counts, long long primary,
                      const int32_t* sa, long long n_sa, int64_t* out,
                      int64_t* rank_out, int64_t* step_out, void* stream) {
  const Marks mk{mark_words, mark_rank, sa, n_sa, sa_rate};
  const Tables t{reinterpret_cast<const uint4*>(blocks), counts, primary};
  sa_decode_kernel<<<blocks_for(N), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      rows, valid, N, mk, t, out, rank_out, step_out);
  return static_cast<int>(cudaGetLastError());
}

int soap3dp_expand_decode(const int64_t* lo, const int64_t* incl,
                          long long RS, const int64_t* sstart,
                          const int64_t* olens, int S, long long n,
                          long long K, int sa_rate, const int32_t* mark_words,
                          const int32_t* mark_rank, const int32_t* blocks,
                          const int64_t* counts, long long primary,
                          const int32_t* sa, long long n_sa, int64_t* krow,
                          int64_t* ktp, uint8_t* pos_ok, int64_t* lane_out,
                          int64_t* rank_out, int64_t* step_out,
                          void* stream) {
  const Marks mk{mark_words, mark_rank, sa, n_sa, sa_rate};
  const Tables t{reinterpret_cast<const uint4*>(blocks), counts, primary};
  const Lanes e{lo, incl, sstart, olens, RS, n, S};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rank_out)
    expand_decode_kernel<OUT_RANKS><<<blocks_for(K), THREADS, 0, st>>>(
        e, K, mk, t, Slots{lane_out, rank_out, nullptr, step_out});
  else
    expand_decode_kernel<OUT_KEYS><<<blocks_for(K), THREADS, 0, st>>>(
        e, K, mk, t, Slots{krow, ktp, pos_ok, nullptr});
  return static_cast<int>(cudaGetLastError());
}

int soap3dp_seed_expand_decode(const int64_t* lo, const int64_t* incl,
                               long long RS, const int64_t* sp, int S,
                               long long K, int sa_rate,
                               const int32_t* mark_words,
                               const int32_t* mark_rank,
                               const int32_t* blocks, const int64_t* counts,
                               long long primary, const int32_t* sa,
                               long long n_sa, int64_t* row, int64_t* pos,
                               uint8_t* valid, int64_t* lane_out,
                               int64_t* rank_out, int64_t* step_out,
                               void* stream) {
  const Marks mk{mark_words, mark_rank, sa, n_sa, sa_rate};
  const Tables t{reinterpret_cast<const uint4*>(blocks), counts, primary};
  const Lanes e{lo, incl, sp, nullptr, RS, 0, S};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rank_out)
    seed_expand_kernel<OUT_RANKS><<<blocks_for(K), THREADS, 0, st>>>(
        e, K, mk, t, Slots{lane_out, rank_out, nullptr, step_out});
  else
    seed_expand_kernel<OUT_SEED><<<blocks_for(K), THREADS, 0, st>>>(
        e, K, mk, t, Slots{row, pos, valid, nullptr});
  return static_cast<int>(cudaGetLastError());
}

// scratch: int32 table (2^hb), bits (ceil(K / 32)), counts and offsets
// (ceil(K / THREADS) each), the table first (16-byte aligned)
int soap3dp_dedupe(const int64_t* krow, const int64_t* ktp,
                   const uint8_t* pos_ok, long long K, long long K2, int hb,
                   int32_t* scratch, int64_t* urow, int64_t* utp,
                   uint8_t* uvalid, int64_t* uniq, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t slots = 1ll << hb;
  const int64_t nb = (K + THREADS - 1) / THREADS;
  int32_t* table = scratch;
  uint32_t* bits = reinterpret_cast<uint32_t*>(scratch + slots);
  int32_t* counts = scratch + slots + (K + 31) / 32;
  int32_t* offsets = counts + nb;
  const unsigned grid = static_cast<unsigned>(nb);
  dedupe_clear_kernel<<<blocks_for(slots / 4), THREADS, 0, st>>>(
      reinterpret_cast<uint4*>(table), slots / 4);
  dedupe_scatter_kernel<<<grid, THREADS, 0, st>>>(krow, ktp, pos_ok, K, hb,
                                                   table);
  dedupe_first_kernel<<<grid, THREADS, 0, st>>>(krow, ktp, pos_ok, K, hb,
                                                table, bits, counts);
  dedupe_scan_kernel<<<1, SCAN_THREADS, 0, st>>>(counts, nb, offsets, uniq);
  dedupe_write_kernel<<<grid, THREADS, 0, st>>>(krow, ktp, K, K2, bits,
                                                offsets, uniq, urow, utp,
                                                uvalid);
  return static_cast<int>(cudaGetLastError());
}

int soap3dp_verify(const void* reads, int kind, long long B, int L, int Ws,
                   const int64_t* rc_len, const int64_t* rows,
                   const int64_t* tp, const int64_t* read_len, long long M,
                   int W, const int32_t* pac, long long n_pac, int64_t* out,
                   void* stream) {
  const Reads s{reads, rc_len, B, kind, L, Ws};
  const int need = W > (L + 15) / 16 ? W : (L + 15) / 16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (need <= 8)
    verify_kernel<8><<<blocks_for(M), THREADS, 0, st>>>(
        s, rows, tp, read_len, M, W, pac, n_pac, out);
  else if (need <= 16)
    verify_kernel<16><<<blocks_for(M), THREADS, 0, st>>>(
        s, rows, tp, read_len, M, W, pac, n_pac, out);
  else
    verify_kernel_any<<<blocks_for(M), THREADS, 0, st>>>(
        s, rows, tp, read_len, M, W, pac, n_pac, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
