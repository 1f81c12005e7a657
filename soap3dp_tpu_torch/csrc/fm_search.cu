// The gather stages of the seed search for Hopper (sm_90a), one thread
// per lane or slot: FM backward search (FS1), SA decode (FS2, with the
// lane expansions of the search and of the DP seeding), packed
// verification (FS3), the hash dedupe (FS4), the lanes' counts and
// their scan (FS5) and the result wire (FS6); and the DP rescue's
// gapless prescan (GP, one warp a candidate) and problem pack (PK, one
// thread a 16-byte unit of its outputs), which read the genome as FS3
// does and their read rows as whole aligned words (oriented16). Each
// reproduces its plain-torch version in soap3dp_tpu_torch/fm/fmindex.py
// (GP, PK: pipeline/dp_rescue.py) element for element.
//
// FS1, soap3dp_fm_search, replaces the XLA programs of
// soap3dp_tpu/fm/fmindex.py:391 `backward_search`, :456
// `backward_search_packed` and the LUT-only branch of `_search_batch`
// (soap3dp_tpu/fm/search.py:207-214); which of the three a launch
// reproduces is its `mode`, with their different edges (the LUT-only
// branch reads the A-padded k-mer at the segment start whatever the
// segment's length; the packed branch clamps the k-mer tail and the
// extension offset; the general branch clamps every base position and
// takes no LUT below lut_k bases). A lane's segment is given or made
// from its row's read length (Seeds: the search's pigeonhole segments,
// the reference's `_seed_bounds` at soap3dp_tpu/fm/search.py:120 and its
// seed range, :199; the DP seeding's staged seeds clamped into the read,
// soap3dp_tpu/pipeline/dp_rescue.py:155-164), as FS2x and FS2s make
// their lanes' seed starts, so no plain-torch pass makes the lanes'
// arrays.
// FS2 replaces `sa_decode` (fmindex.py:509): the bounded LF walk over
// the mark bitvector, then the rank and sample gathers (or, for an SA
// table split over a mesh, the rank and step count, which the caller
// routes to the slice that owns the row). Three entries share the walk:
// soap3dp_sa_decode decodes ready rows; soap3dp_expand_decode (FS2x)
// also does the lane expansion of the reference's `_search_batch`
// (soap3dp_tpu/fm/search.py:247-273): output slot k belongs to the
// first lane whose inclusive count exceeds k (found a warp of slots at
// a time, warp_slot_lane: a 32-ary search, then a window of 32 counts
// read once and searched by shuffles), decodes row l[lane] + (k - the
// lane's offset), and writes the hash dedupe's keys (oriented row, text
// position, or the sentinel where the placement leaves the text)
// directly; soap3dp_seed_expand_decode (FS2s) does the same expansion
// for the DP seeding (soap3dp_tpu/pipeline/dp_rescue.py:176-188, whose
// (lanes, occ_cap) slot mask and nonzero give the same slot order) and
// writes its candidates (oriented row, read start, valid) as the u32
// words of the reference's one packed transfer, [row | pos | valid]
// (dp_rescue.py:184-190). The three forms are one template (expand_at,
// expand_slot).
// FS5, soap3dp_lane_counts, replaces the counts and their cumsum of the
// reference's `_search_batch` (soap3dp_tpu/fm/search.py:232-252: the
// overflow mask, the per-read any, the where / minimum, the cumsum) and
// of the DP seeding (the widths' minimum and the slot count,
// soap3dp_tpu/pipeline/dp_rescue.py:176-178): each lane's count, their
// inclusive scan (the look-back of FS4's scan, shared; tiles of 2,048
// lanes read as 16-byte vectors) and the total, and in
// the search's mode the flagged words of the result wire, ORed by the
// tiles. What bounds it: bytes (each lane's l, r and incl, 24 B).
// FS6, soap3dp_search_wire, replaces the hit test and the packing of
// `_search_batch_wire` (soap3dp_tpu/fm/search.py:312, :322-346): one
// thread a unique placement writes its two words of the wire, the
// first thread the totals.
// FS4, soap3dp_dedupe, replaces the scatter-min hash dedupe of the
// reference's `_search_batch` (soap3dp_tpu/fm/search.py:275-301) and
// the nonzero of its first occurrences: two launches, no sort and no
// library scan. The scatter (a 64-bit atomicMax of generation << 32 |
// K - k into a table the wrapper keeps across calls, so no pass clears
// it); then the first test, a single-pass scan of the firsts (decoupled
// look-back between tiles that take tickets in order) and the ordered
// write of the firsts, the keys read once there. What bounds it: the
// table's random atomics and reads (the slots the keys touch,
// L2-resident) and the gathers of the winners' keys; the keys and
// outputs stream.
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
// Placements of one read share its row in L1, not in registers. It
// takes the dedupe's outputs as they are and does the reference's
// argument prep (soap3dp_tpu/fm/search.py:305-310: the rows' clamp, the
// positions' where, the lengths' gather) as it loads them.
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
// GP, soap3dp_prescan, replaces the XLA program of the DP rescue's
// gapless prescan (soap3dp_tpu/pipeline/dp_rescue.py:276 `_prescan_impl`,
// over soap3dp_tpu/fm/fmindex.py:593 `extract_genome` and :670
// `revcomp_reads`: L shift-and-add steps of (M, O) byte compares, then a
// min, an argmax and a sum over the offsets): the mismatches of each
// candidate's read placed gapless at every valid offset of its genome
// window, reduced in the kernel to the least count, its leftmost offset
// and the count of zero-mismatch offsets, so no (M, O) matrix and no
// (M, W) window of codes is written. What bounds it: operations at wide
// windows (each valid offset costs, a read word, a funnel shift, XOR,
// fold, mask, popcount and add: ~0.14 ms of int32 work at the mate-pair
// cell's 16,384 x 4,224 x 120 against ~5 us of bytes); at the paired-end
// cell's O = 384 a candidate has ~190 valid offsets, so its set-up, the
// read's words and the window's, is as long as its offset loop. Its
// arguments are the host's: a row of words a candidate (the read, its
// strand, its window start as two u32 words, its lengths), the row
// index and the 64-bit start made here, and the result written as int32,
// so the call runs no other kernel. Design:
// one warp a candidate (its ~26 groups of offsets fill it); its words,
// its window's first words and its read row are all loaded before any
// is waited on, the row as whole aligned words (lane j reads bytes
// 16j..16j+15 with oriented16, two or three 8-byte loads, and packs them
// to a 2-bit word and its mask by SWAR, read_word_mask, the codes above
// 3 counted apart, with no loop over bases); the window's packed words
// and the read's words in
// the warp's slice of shared memory; a lane counts 8 consecutive offsets
// at once from the same two shared window words a read word, so each
// shared load serves 8 offsets and the loop is the int32 work alone; the
// (min, leftmost argmin, zero count) reduction is the lane's running one,
// then warp shuffles.
//
// PK, soap3dp_pack_problems, replaces the XLA program of the DP rescue's
// problem pack (soap3dp_tpu/pipeline/dp_rescue.py:357 `_pack_problems`,
// over soap3dp_tpu/fm/fmindex.py:593 `extract_genome`, :642
// `aligned_genome_words`, :670 `revcomp_reads` and :679
// `revcomp_reads_uniform`): each DP problem's read oriented by its strand
// and its genome window as 2-bit codes, the two uint8 inputs of K1 and
// K2. What bounds it: bytes: the outputs written once, a window's pac
// words and a read row read once (81 MB, 0.024 ms at 3.35 TB/s, at the
// mate-pair cell's largest call, 16,384 x 4,224); no arithmetic to speak
// of. At the paired-end cell's 256-wide windows a call is a few
// microseconds, and the bytes do not hold it: a read unit's chain of
// dependent loads (the problem's words, then the read's bytes) does, and
// a block that held read units beside window units would wait on them.
// Its arguments are the host's: a row of four words a problem (the read
// row and strand, the window start as two u32 words, the reverse
// complement's length: the problem's own read length), so the call
// uploads one block and runs no other kernel. The plain version's cost is its temporaries: the
// batch's reverse complement and a gather of it, and an (M, W, 16) int64
// code tensor (554 MB at that call). Design: no temporaries. One thread a
// unit of 16 output bytes, with a 32-bit index (the wrapper keeps P
// times the units below 2^31); read units and window units in blocks of
// their own, so no warp diverges between the two. A read unit is one
// oriented16 (the 16 bytes of its oriented row from two or three aligned
// 8-byte loads, reversed and complemented in registers for a reverse
// strand) and one store. A window unit is
// the funnel shift of two pac words (pac_word, the index clamped as
// aligned_genome_words clamps it; a shift of 0 takes no bits of the
// second word), spread to 16 code bytes and stored as one 16-byte
// vector. A problem's units are consecutive, so a warp's loads and
// stores are contiguous. Window starts and pac indices are 64-bit (past
// 2^31 on a 3.1 Gbp text).
//
// Plain C interface for ctypes; each launcher returns cudaGetLastError().

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "tile_lookback.cuh"

namespace {

using soap3dp_lookback::tile_lookback;
using soap3dp_lookback::warp_scan;

constexpr uint32_t LANES = 0x55555555u;  // one bit per 2-bit base slot
constexpr int64_t MASK32 = 0xFFFFFFFFll;
constexpr int64_t SENTINEL = 0xFFFFFFFFll;  // fm/search.py SENTINEL
constexpr int THREADS = 256;
constexpr uint32_t FULL = 0xFFFFFFFFu;  // a whole warp

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
  const int32_t* rc_len;  // (B,) bases of each reverse-complement row, or
  int64_t rc_all;         // null: every one has rc_all bases
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

// the bases of reverse-complement row B + b
__device__ __forceinline__ int64_t rc_bases(const Reads& s, int64_t b) {
  return s.rc_len ? static_cast<int64_t>(__ldg(s.rc_len + b)) : s.rc_all;
}

__device__ __forceinline__ int64_t clamp64(int64_t x, int64_t lo,
                                           int64_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// packed genome word k, the index clamped to pac (a window past the
// text's end repeats the last word, as aligned_genome_words clamps it)
__device__ __forceinline__ uint32_t pac_word(const int32_t* pac,
                                             int64_t n_pac, int64_t k) {
  return u32_at(pac, clamp64(k, 0, n_pac - 1));
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

// an oriented row: its forward read b and, for a reverse complement,
// its n bases, read once for a lane's many bases (FS1's walk reads one
// a step)
struct RowRef {
  int64_t b, n;
  bool rc;
};

__device__ __forceinline__ RowRef row_ref(const Reads& s, int64_t row) {
  if (row < s.B) return RowRef{row, 0, false};
  return RowRef{row - s.B, rc_bases(s, row - s.B), true};
}

// base i (0 <= i < L) of an oriented row, as the plain versions'
// materialized matrix holds it (fmindex.OrientedReads.matrix: a
// reverse-complement row is 3 - read[n-1-i] for i < n, else 0)
__device__ uint32_t base_at(const Reads& s, const RowRef& r, int64_t i) {
  if (!r.rc) return fwd_base(s, r.b, i);
  if (i >= r.n) return 0u;
  return (3u - fwd_base(s, r.b, clamp64(r.n - 1 - i, 0, s.L - 1))) & 0xFFu;
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
__device__ uint32_t word16(const Reads& s, const RowRef& r, int64_t p) {
  if (s.kind == SRC_PACKED) {
    if (!r.rc) {
      if (p + 16 <= s.L) return reverse_bases(packed_window(s, r.b, p));
    } else if (r.n <= s.L && p + 16 <= r.n) {
      return ~packed_window(s, r.b, r.n - 16 - p);
    }
  }
  const int n = static_cast<int>(s.L - p < 16 ? s.L - p : 16);
  uint32_t w = 0;
  for (int j = 0; j < n; ++j) w |= base_at(s, r, p + j) << (2 * (15 - j));
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
  const RowRef r = row_ref(s, row);
  uint32_t w = 0;
  for (int t = 0; t < n; ++t) w |= base_at(s, r, i0 + t) << (2 * t);
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

// Where seed lane i's segment lies in its row i / S (S lanes a row):
// given, a start and a length a lane; or made from the read length of
// the row as the reference makes it, so no (lanes,) arrays of starts and
// lengths are made on the card: the search's pigeonhole segments
// (soap3dp_tpu/fm/search.py:120 `_seed_bounds`, then its seed range:
// segment j = lo + i % S of `segments` a read, [j n / segments,
// (j + 1) n / segments), truncated to q bases where q > 0), or the DP
// seeding's staged seeds (soap3dp_tpu/pipeline/dp_rescue.py:155-164:
// seed i % S at pos, of slen bases, clamped into the read). Row r's read
// is r mod nl (rows B + b are read b's reverse complement).
struct Seeds {
  const int64_t* start;   // (N,) given starts, or null: made
  const int64_t* length;  // (N,) given lengths (FS1 only)
  const int32_t* lens;    // (nl,) read lengths, or null
  const int32_t* pos;     // (nl, S) the DP seeding's seed starts, or null
  const int32_t* slen;    // (nl,) the DP seeding's seed lengths
  int64_t nl;
  int segments;           // pigeonhole segments a read
  int lo;                 // the segment of a row's first lane
  int q;                  // the seed prefix (seed_q; 0: untruncated)
};

// row's read, r mod n (rows of a batch and its reverse complements lie
// below 2n)
__device__ __forceinline__ int64_t read_of(int64_t row, int64_t n) {
  return row < n ? row : (row < 2 * n ? row - n : row % n);
}

// the read length of oriented row `row`
__device__ __forceinline__ int64_t row_len(const Seeds& sd, int64_t row) {
  return __ldg(sd.lens + read_of(row, sd.nl));
}

struct Segment {
  int64_t start, length;
};

// a Seeds' form, a template parameter of the kernels that take one, so
// each instantiation holds only its own form's loads and arithmetic
enum : int { SEED_GIVEN = 0, SEED_PIGEONHOLE = 1, SEED_STAGED = 2 };

int seed_form(const Seeds& sd) {
  return sd.start ? SEED_GIVEN : (sd.pos ? SEED_STAGED : SEED_PIGEONHOLE);
}

// f(std::integral_constant<int, form>) for sd's form: the launchers'
// dispatch to the instantiation of that form
template <typename F>
void with_seed_form(const Seeds& sd, F&& f) {
  switch (seed_form(sd)) {
    case SEED_GIVEN:
      f(std::integral_constant<int, SEED_GIVEN>{});
      break;
    case SEED_STAGED:
      f(std::integral_constant<int, SEED_STAGED>{});
      break;
    default:
      f(std::integral_constant<int, SEED_PIGEONHOLE>{});
  }
}

// lane i's segment (S lanes a row), sd of form FORM
template <int FORM>
__device__ __forceinline__ Segment seed_at(const Seeds& sd, int64_t i, int S) {
  if (FORM == SEED_GIVEN)
    return Segment{ld64(sd.start + i), sd.length ? ld64(sd.length + i) : 0};
  const int64_t row = i / S;
  const int64_t j = i - row * S;
  const int64_t b = read_of(row, sd.nl);
  const int64_t n = __ldg(sd.lens + b);
  if (FORM == SEED_STAGED) {
    const int64_t sp = __ldg(sd.pos + b * S + j);
    const int64_t sl = __ldg(sd.slen + b);
    const int64_t room = n - sl > 0 ? n - sl : 0;
    return Segment{sp < room ? sp : room, sl < n ? sl : n};
  }
  const int64_t seg = sd.lo + j;
  const int64_t st = seg * n / sd.segments;
  const int64_t len = (seg + 1) * n / sd.segments - st;
  return Segment{st, sd.q > 0 && len > sd.q ? sd.q : len};
}

template <int FORM>
__global__ void __launch_bounds__(THREADS)
fm_search_kernel(Reads s, int S, Seeds sd, int64_t N, int mode,
                 int max_steps, int k, Tables t,
                 const int32_t* __restrict__ lut_lo,
                 const int32_t* __restrict__ lut_hi, int64_t n1,
                 int64_t* __restrict__ l_out, int64_t* __restrict__ r_out) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (i >= N) return;
  const RowRef row = row_ref(s, i / S);
  const Segment seg = seed_at<FORM>(sd, i, S);
  const int64_t st = seg.start;
  const int64_t len = seg.length;
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
  Seeds sd;              // each lane's segment (seed) start in its row, and
                         // each row's read length (the search's)
  int64_t RS;
  int64_t n;             // the text's length
  int S;                 // lanes a row
};

// what an expansion writes for each slot, by its form
struct Slots {
  int64_t* a;       // krow | - | lane
  int64_t* b;       // ktp | - | rank
  uint8_t* ok;      // pos_ok | - | -
  int64_t* step;    // - | - | LF steps
  uint32_t* words;  // - | [row (K) | pos (K) | valid (K)] | -
  int64_t K;        // the slots
};

// the three forms: the search's dedupe keys (FS2x), the DP seeding's
// candidates as the u32 words of the reference's one packed transfer
// (FS2s), and, for an SA table split over a mesh, each slot's lane,
// sample rank and steps, whose samples the owner routing gathers
enum : int { OUT_KEYS = 0, OUT_SEED = 1, OUT_RANKS = 2 };

// the lane of live slot k in lanes [a, b] (incl[b] > k): the first lane
// whose inclusive count exceeds k, by binary search
__device__ __forceinline__ int64_t lane_in(const Lanes& e, int64_t k,
                                           int64_t a, int64_t b) {
  while (a < b) {
    const int64_t m = (a + b) >> 1;
    if (ld64(e.incl + m) > k)
      b = m;
    else
      a = m + 1;
  }
  return a;
}

// the whole warp narrows [a, b], which holds the lane of slot `key`, to
// fewer than 32 lanes: each round it probes 32 counts and one ballot
// keeps a 32nd of the range. The same probes bound the lane of a later
// slot `key2`: hi, if not below it, becomes the first probe above key2.
__device__ __forceinline__ void warp_narrow(const Lanes& e, int64_t key,
                                            int64_t key2, int64_t& a,
                                            int64_t& b, int64_t& hi,
                                            int lane_id) {
  while (b - a >= 32) {
    const int64_t n = b - a + 1;
    const int64_t p = a + (lane_id + 1) * n / 32 - 1;
    const int64_t v = ld64(e.incl + p);
    const uint32_t above = __ballot_sync(FULL, v > key);
    const uint32_t above2 = __ballot_sync(FULL, v > key2);
    const int f = __ffs(above) - 1;  // bit 31 (p == b) is always set
    const int64_t pf = __shfl_sync(FULL, p, f);
    const int64_t pb = __shfl_sync(FULL, p, f > 0 ? f - 1 : 0);
    const int64_t p2 = __shfl_sync(FULL, p, above2 ? __ffs(above2) - 1 : 31);
    if (above2 && p2 < hi) hi = p2;
    a = f > 0 ? pb + 1 : a;
    b = pf;
  }
}

// of the 32 counts w held one a thread (ascending), how many are at most
// key: shuffles only
__device__ __forceinline__ int window_count(int64_t w, int64_t key) {
  int pos = 0;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    if (__shfl_sync(FULL, w, pos + d - 1) <= key) pos += d;
  const int64_t last = __shfl_sync(FULL, w, 31);  // every thread shuffles
  return pos == 31 && last <= key ? 32 : pos;
}

// the 32 counts from lane a on, one a thread (past the last lane: above
// any slot)
__device__ __forceinline__ int64_t window_at(const Lanes& e, int64_t a,
                                             int lane_id) {
  const int64_t j = a + lane_id;
  return j < e.RS ? ld64(e.incl + j) : INT64_MAX;
}

// the lane of live slot k, found by the whole warp for its 32
// consecutive slots: the lowest live slot's lane narrowed to 32 lanes
// (warp_narrow: 3 rounds at 107,648 lanes, where a binary search takes
// 17 dependent loads), then those 32 counts read once, in which each
// slot finds its lane by shuffles. Where the warp's slots reach past
// those 32 lanes (empty lanes between them), each slot past the window
// binary-searches from it up to the bound that the same probes gave the
// highest live slot's lane. Every thread of the warp calls it.
__device__ int64_t warp_slot_lane(const Lanes& e, int64_t k, bool live,
                                  int lane_id) {
  const uint32_t pending = __ballot_sync(FULL, live);
  if (pending == 0) return 0;
  const int64_t kmin = __shfl_sync(FULL, k, __ffs(pending) - 1);
  const int64_t kmax = __shfl_sync(FULL, k, 31 - __clz(pending));
  int64_t a = 0, b = e.RS - 1, hi = e.RS - 1;  // incl[hi] > kmax
  warp_narrow(e, kmin, kmax, a, b, hi, lane_id);
  const int64_t w = window_at(e, a, lane_id);
  const int pos = window_count(w, k);
  if (!live) return 0;  // a slot past the total keeps lane 0
  return pos < 32 ? a + pos : lane_in(e, k, a + 32, hi);
}

// slot k of the expansion (``live`` below the total count, of lane
// ``lane``), decoded and written in form OUT, the seeds of form FORM
template <int OUT, int FORM>
__device__ __forceinline__ void expand_slot(const Lanes& e, const Marks& mk,
                                            const Tables& t, const Slots& o,
                                            int64_t k, bool live,
                                            int64_t lane) {
  const int64_t row =
      live ? ld64(e.lo + lane) + k - (lane ? ld64(e.incl + lane - 1) : 0)
           : 0;
  const Ranked rk = walk(mk, t, row, live);
  if (OUT == OUT_RANKS) {
    o.a[k] = lane;
    o.b[k] = rk.rank;
    o.step[k] = rk.step;
    return;
  }
  const int64_t pos = live ? position(mk, rk) : 0;
  const int64_t st = seed_at<FORM>(e.sd, lane, e.S).start;
  const int64_t orow = lane / e.S;
  if (OUT == OUT_SEED) {
    // dp_rescue._seed_cand_batch: the read's start (below 2^32: pos is),
    // no test of its end; a slot past the total keeps row 0 (lane 0's)
    const bool ok = live && pos >= st;
    o.words[k] = static_cast<uint32_t>(orow);
    o.words[o.K + k] = ok ? static_cast<uint32_t>(pos - st) : 0u;
    o.words[2 * o.K + k] = ok ? 1u : 0u;
    return;
  }
  const int64_t tp = pos - st;
  const bool ok = live && pos >= st && tp + row_len(e.sd, orow) <= e.n;
  o.a[k] = ok ? orow : SENTINEL;
  o.b[k] = ok ? (tp & MASK32) : SENTINEL;
  o.ok[k] = ok ? 1 : 0;
}

// slot k of an expansion of K slots, its lane found a warp at a time
// (warp_slot_lane); every thread of the warp reaches it
template <int OUT, int FORM>
__device__ __forceinline__ void expand_at(const Lanes& e, int64_t K,
                                          const Marks& mk, const Tables& t,
                                          const Slots& o) {
  const int64_t k = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  const bool live = k < K && k < ld64(e.incl + e.RS - 1);
  const int64_t lane = warp_slot_lane(e, k, live, threadIdx.x & 31);
  if (k < K) expand_slot<OUT, FORM>(e, mk, t, o, k, live, lane);
}

// FS2x: the search's lane expansion (OUT_KEYS or OUT_RANKS)
template <int OUT, int FORM>
__global__ void __launch_bounds__(THREADS)
expand_decode_kernel(Lanes e, int64_t K, Marks mk, Tables t, Slots o) {
  expand_at<OUT, FORM>(e, K, mk, t, o);
}

// FS2s: the DP seeding's lane expansion (OUT_SEED or OUT_RANKS)
template <int OUT, int FORM>
__global__ void __launch_bounds__(THREADS)
seed_expand_kernel(Lanes e, int64_t K, Marks mk, Tables t, Slots o) {
  expand_at<OUT, FORM>(e, K, mk, t, o);
}

// FS4, the hash dedupe of the search's keys (krow, ktp, pos_ok). Slot k
// with pos_ok hashes to table slot dedupe_slot; the table keeps K - k of
// the least such k (a 64-bit atomicMax of gen << 32 | K - k, so the
// winner does not depend on the order of the atomics); k is a first
// unless the winner is another slot with the same key. Two launches:
// the scatter, then the first test, a single-pass scan of the firsts and
// their ordered write. The table is the wrapper's, kept across calls on
// one card and stream and zeroed once: each call's generation `gen` is
// above every earlier one's, so a call's first atomicMax on a slot
// replaces what an earlier call left there, and nothing is cleared.
// The first launch also fills every output slot as the plain version
// fills the slots past the firsts, and the second overwrites the firsts'.
// Its blocks take tickets from a counter: a tile of 1,024 slots (4 rows
// of 256) counts its firsts (a ballot word a warp and row, one warp's
// scan of the 32 counts) and finds the firsts before it by decoupled
// look-back over the tiles before it (a 64-bit status word a tile: a
// flag and its count, or the count of every first up to it), so it
// waits only on blocks that already run. The statuses and the ticket
// counter are kept across calls too, shared with FS5 and DW
// (tile_lookback.cuh).
constexpr uint32_t HASH_ROW = 0x9E3779B1u;
constexpr uint32_t HASH_TP = 0x85EBCA77u;
constexpr uint32_t HASH_MIX = 0xC2B2AE3Du;
constexpr int64_t ROW_SENTINEL = 0x7FFFFFFFll;  // fm/search.py ROW_SENTINEL
constexpr int WARPS = THREADS / 32;
constexpr int DEDUPE_ROWS = 4;                // slots a thread of a tile
constexpr int TILE = DEDUPE_ROWS * THREADS;   // slots a tile

// the table slot of a key (32-bit products, as fmindex.mul32)
__device__ __forceinline__ uint32_t dedupe_slot(int64_t row, int64_t tp,
                                                int hb) {
  const uint32_t h = (static_cast<uint32_t>(row) * HASH_ROW) ^
                     (static_cast<uint32_t>(tp) * HASH_TP);
  return (h * HASH_MIX) >> (32 - hb);
}

// the scatter; output slot k (< K2) filled as past the firsts
// (ROW_SENTINEL, ktp[0], 0), which the second launch overwrites for the
// firsts
__global__ void __launch_bounds__(THREADS)
dedupe_scatter_kernel(const int64_t* __restrict__ krow,
                      const int64_t* __restrict__ ktp,
                      const uint8_t* __restrict__ pos_ok, int64_t K,
                      int64_t K2, int hb, uint32_t gen,
                      unsigned long long* __restrict__ table,
                      int64_t* __restrict__ urow, int64_t* __restrict__ utp,
                      uint8_t* __restrict__ uvalid) {
  const int64_t k = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (k < K2) {
    urow[k] = ROW_SENTINEL;
    utp[k] = ld64(ktp);
    uvalid[k] = 0;
  }
  if (k >= K || !__ldg(pos_ok + k)) return;
  atomicMax(table + dedupe_slot(ld64(krow + k), ld64(ktp + k), hb),
            (static_cast<unsigned long long>(gen) << 32) |
                static_cast<uint32_t>(K - k));
}

// the first test of a tile's slots, the firsts before each (look-back;
// tickets counted from `base`, statuses tagged `tag`), the firsts of
// rank < K2 to their output slots; the last tile writes uniq
__global__ void __launch_bounds__(THREADS)
dedupe_scan_kernel(const int64_t* __restrict__ krow,
                   const int64_t* __restrict__ ktp,
                   const uint8_t* __restrict__ pos_ok, int64_t K, int64_t K2,
                   int hb, const unsigned long long* __restrict__ table,
                   unsigned long long* status, int64_t tiles,
                   unsigned* __restrict__ ticket, uint32_t base,
                   uint32_t tag, int64_t* __restrict__ urow,
                   int64_t* __restrict__ utp, uint8_t* __restrict__ uvalid,
                   int64_t* __restrict__ uniq) {
  __shared__ unsigned my_ticket;
  __shared__ int32_t off[DEDUPE_ROWS * WARPS];  // (row, warp): firsts before
  __shared__ int32_t tile_before;
  if (threadIdx.x == 0) my_ticket = atomicAdd(ticket, 1u) - base;
  __syncthreads();
  const int64_t t = my_ticket;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t k0 = t * TILE + threadIdx.x;
  int64_t row[DEDUPE_ROWS], tp[DEDUPE_ROWS];
  bool first[DEDUPE_ROWS];
#pragma unroll
  for (int r = 0; r < DEDUPE_ROWS; ++r) {  // every load of a slot at once
    const int64_t k = k0 + r * THREADS;
    first[r] = k < K && __ldg(pos_ok + k);
    row[r] = k < K ? ld64(krow + k) : 0;
    tp[r] = k < K ? ld64(ktp + k) : 0;
  }
  uint32_t ballot[DEDUPE_ROWS];
#pragma unroll
  for (int r = 0; r < DEDUPE_ROWS; ++r) {
    const int64_t k = k0 + r * THREADS;
    if (first[r]) {
      const int64_t won = K - static_cast<int64_t>(static_cast<uint32_t>(
                                  __ldg(table + dedupe_slot(row[r], tp[r], hb))));
      const int64_t w = won < K - 1 ? won : K - 1;
      first[r] = w == k || ld64(krow + w) != row[r] || ld64(ktp + w) != tp[r];
    }
    ballot[r] = __ballot_sync(FULL, first[r]);
    if (lane == 0) off[r * WARPS + warp] = __popc(ballot[r]);
  }
  __syncthreads();
  if (warp == 0) {
    const int32_t x = off[lane];
    const int32_t incl = warp_scan(x, lane);
    off[lane] = incl - x;
    const int32_t count = __shfl_sync(FULL, incl, 31);
    const int32_t before = tile_lookback<false>(status, t, count, lane, tag);
    if (lane == 0) {
      tile_before = before;
      if (t == tiles - 1) *uniq = before + count;
    }
  }
  __syncthreads();
  const uint32_t below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < DEDUPE_ROWS; ++r) {
    if (!first[r]) continue;
    const int64_t rank = static_cast<int64_t>(tile_before) +
                         off[r * WARPS + warp] + __popc(ballot[r] & below);
    if (rank < K2) {
      urow[rank] = row[r];
      utp[rank] = tp[r];
      uvalid[rank] = 1;
    }
  }
}

// FS5, the lanes' counts and their inclusive scan. Lane k's count from
// its SA interval [l, r): in the search's mode (flags given) 0 where the
// width passes cap, else the width (fm/search.py's where / minimum); in
// the seeding's, the width clamped to [0, cap]. The wrapper keeps RS x
// cap below 2^31, so every count and partial sum fits 32 bits.
//
// What bounds it: bytes, each lane's l and r read and its incl written
// once (24 B a lane). Design: each l and r is read once, as 16-byte
// vectors of two lanes. A block takes a ticket and scans a tile of
// COUNT_TILE lanes (COUNT_PAIRS pairs of lanes a thread, pair row q of
// thread j at pair q THREADS + j, so a warp's vectors are contiguous;
// of 2, 4 and 8 pairs, 4 was the fastest on an H100 at both of the
// path's shapes: 8 leave too few tiles to fill the card at the
// seeding's, 2 take twice the tickets and look-backs), finds the
// counts before it by FS4's look-back on the scan state the
// two share (tile_lookback) and writes its incl as 16-byte vectors; the
// last tile writes the total. In the search's mode the tiles also set
// the wire's flagged words: read b (of B = RS / 2S) is bit b % 32 of
// word b / 32 where any of its lanes on either strand (rows b and B + b)
// overflowed. A read's two strands lie in different tiles, so a word is
// an OR across tiles: the tile of ticket 0 zeroes the words before it
// publishes its status, and every other tile sets its bits (an atomicOr
// a word a warp, and only where a lane overflowed) after its look-back,
// which ends at a status published after tile 0's (every inclusive
// count descends from tile 0's), each side behind a fence. So no pass
// reads l and r again for the flags, and no launch zeroes them.
constexpr int COUNT_PAIRS = 4;                        // pairs a thread
constexpr int COUNT_TILE = 2 * COUNT_PAIRS * THREADS;  // lanes a tile

__global__ void __launch_bounds__(THREADS)
lane_counts_kernel(const int64_t* __restrict__ l,
                   const int64_t* __restrict__ r, int64_t RS, int64_t cap,
                   int S, int64_t tiles, unsigned long long* status,
                   unsigned* __restrict__ ticket, uint32_t base,
                   uint32_t tag, int64_t* __restrict__ incl,
                   int64_t* __restrict__ total, uint32_t* __restrict__ flags,
                   int64_t nf) {
  constexpr int E = COUNT_PAIRS * WARPS;  // (pair row, warp) sums of a tile
  constexpr int PER = (E + 31) / 32;  // of them a lane of warp 0 scans
  __shared__ unsigned my_ticket;
  __shared__ int32_t off[E];  // (pair row, warp): the counts before it
  __shared__ int32_t tile_before;
  if (threadIdx.x == 0) my_ticket = atomicAdd(ticket, 1u) - base;
  __syncthreads();
  const int64_t t = my_ticket;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool search = flags != nullptr;
  const int64_t p0 = t * (COUNT_PAIRS * THREADS) + threadIdx.x;  // row 0's
  longlong2 lv[COUNT_PAIRS], rv[COUNT_PAIRS];
#pragma unroll
  for (int q = 0; q < COUNT_PAIRS; ++q) {  // every load of the tile at once
    const int64_t k = 2 * (p0 + q * THREADS);
    if (k + 1 < RS) {
      lv[q] = __ldg(reinterpret_cast<const longlong2*>(l + k));
      rv[q] = __ldg(reinterpret_cast<const longlong2*>(r + k));
    } else {
      lv[q] = make_longlong2(k < RS ? ld64(l + k) : 0, 0);
      rv[q] = make_longlong2(k < RS ? ld64(r + k) : 0, 0);
    }
  }
  int32_t c1[COUNT_PAIRS], x[COUNT_PAIRS];
  uint32_t over = 0u;  // bit 2 q + e: lane e of pair row q overflowed
#pragma unroll
  for (int q = 0; q < COUNT_PAIRS; ++q) {
    const int64_t w0 = rv[q].x - lv[q].x, w1 = rv[q].y - lv[q].y;
    int32_t c0;
    if (search) {
      c0 = static_cast<int32_t>(w0 > cap ? 0 : w0);
      c1[q] = static_cast<int32_t>(w1 > cap ? 0 : w1);
      over |= ((w0 > cap ? 1u : 0u) | (w1 > cap ? 2u : 0u)) << (2 * q);
    } else {
      c0 = static_cast<int32_t>(clamp64(w0, 0, cap));
      c1[q] = static_cast<int32_t>(clamp64(w1, 0, cap));
    }
    x[q] = warp_scan(c0 + c1[q], lane);  // every lane takes part
    if (lane == 31) off[q * WARPS + warp] = x[q];
  }
  if (search && t == 0) {  // zeroed before tile 0 publishes its status
    for (int64_t j = threadIdx.x; j < nf; j += THREADS) flags[j] = 0u;
    __threadfence();
  }
  __syncthreads();
  if (warp == 0) {
    int32_t v[PER];
    int32_t sum = 0;
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int j = lane * PER + e;
      v[e] = j < E ? off[j] : 0;
      sum += v[e];
    }
    const int32_t inc = warp_scan(sum, lane);
    int32_t run = inc - sum;
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int j = lane * PER + e;
      if (j < E) off[j] = run;
      run += v[e];
    }
    const int32_t count = __shfl_sync(FULL, inc, 31);
    if (search && t == 0) __threadfence();
    const int32_t before =
        search ? tile_lookback<true>(status, t, count, lane, tag)
               : tile_lookback<false>(status, t, count, lane, tag);
    if (lane == 0) {
      tile_before = before;
      if (t == tiles - 1) *total = before + count;
    }
  }
  __syncthreads();
  const int32_t tb = tile_before;
#pragma unroll
  for (int q = 0; q < COUNT_PAIRS; ++q) {
    const int64_t k = 2 * (p0 + q * THREADS);
    const int64_t b = static_cast<int64_t>(tb + off[q * WARPS + warp] + x[q]);
    const int64_t a = b - c1[q];
    if (k + 1 < RS)
      *reinterpret_cast<longlong2*>(incl + k) = make_longlong2(a, b);
    else if (k < RS)
      incl[k] = a;
  }
  if (!search) return;
  // a warp's 64 lanes of a pair row lie in rows of at most 33
  // consecutive reads (S >= 2), so in words w0 and w0 + 1 of its first
  // lane's read: a warp ORs its bits of each and sets them with one
  // atomicOr; a bit of another word (a lane past the strand's end, whose
  // read starts at 0 again, or S = 1) is set alone
  // (lanes fit 32 bits: the wrapper keeps RS below 2^31)
  const uint32_t us = static_cast<uint32_t>(S);
  const uint32_t B = static_cast<uint32_t>(RS) / (2 * us);
#pragma unroll
  for (int q = 0; q < COUNT_PAIRS; ++q) {
    const uint32_t o = (over >> (2 * q)) & 3u;
    if (!__any_sync(FULL, o != 0u)) continue;  // the same for the warp
    const uint32_t k = static_cast<uint32_t>(2 * (p0 + q * THREADS));
    const uint32_t row0 = (k - 2 * lane) / us;
    const uint32_t w0 = (row0 < B ? row0 : row0 - B) >> 5;
    uint32_t lo = 0u, hi = 0u;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (!((o >> e) & 1u)) continue;
      const uint32_t row = (k + e) / us;
      const uint32_t b = row < B ? row : row - B;
      const uint32_t bit = 1u << (b & 31);
      if ((b >> 5) == w0)
        lo |= bit;
      else if ((b >> 5) == w0 + 1)
        hi |= bit;
      else
        atomicOr(flags + (b >> 5), bit);
    }
    lo = __reduce_or_sync(FULL, lo);
    hi = __reduce_or_sync(FULL, hi);
    if (lane == 0 && lo) atomicOr(flags + w0, lo);
    if (lane == 0 && hi) atomicOr(flags + w0 + 1, hi);
  }
}

// FS6, the search's result wire (fm/search.py _search_batch_wire): slot
// j's hit test (a unique placement verified within k mismatches), its
// text position's word and its meta word, row (24 bits, ROW_SENTINEL
// where no hit, clipped) | mismatches (7 bits, clipped) | hit (1 bit),
// at wire words 2 + nf + j and 2 + nf + K2 + j; thread 0 writes the
// totals, words 0 and 1, from FS5's and FS4's device scalars, so no
// host sync comes between the kernels. What bounds it: bytes, each
// slot's utp, nmis and uvalid read and its two words written (25 B),
// and urow read where the slot holds a hit (8 B).
__global__ void __launch_bounds__(THREADS)
search_wire_kernel(const int64_t* __restrict__ urow,
                   const int64_t* __restrict__ utp,
                   const uint8_t* __restrict__ uvalid,
                   const int64_t* __restrict__ nmis, int64_t K2, int k,
                   const int64_t* __restrict__ total,
                   const int64_t* __restrict__ uniq,
                   uint32_t* __restrict__ wire, int64_t nf) {
  const int64_t j = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (j == 0) {
    wire[0] = static_cast<uint32_t>(ld64(total));
    wire[1] = static_cast<uint32_t>(ld64(uniq));
  }
  if (j >= K2) return;
  const int64_t nm = ld64(nmis + j);
  const bool hit = __ldg(uvalid + j) != 0 && nm <= k;
  const int64_t row = hit ? ld64(urow + j) : ROW_SENTINEL;
  uint32_t* out = wire + 2 + nf;
  out[j] = static_cast<uint32_t>(ld64(utp + j));
  out[K2 + j] = static_cast<uint32_t>(clamp64(row, 0, 0xFFFFFF)) |
                (static_cast<uint32_t>(clamp64(nm, 0, 127)) << 24) |
                (hit ? 0x80000000u : 0u);
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

// FS3's placements as the search hands them over (fm/search.py
// _search_stages, the reference's soap3dp_tpu/fm/search.py:305-310): the
// dedupe's rows clamped to the 2B oriented rows, its text positions 0
// where the slot holds no placement, and each row's read length looked
// up, as the kernel loads them
struct Placements {
  const int64_t* rows;   // (M,) oriented rows
  const int64_t* tp;     // (M,) text positions
  const uint8_t* valid;  // (M,) 0: tp taken as 0; or null: every one
  const int32_t* lens;   // (nl,) read lengths: row r's is lens[r mod nl]
  int64_t nl;
  int64_t M;
};

struct Placement {
  int64_t row, tp, len;
};

__device__ __forceinline__ Placement placement_at(const Reads& s,
                                                  const Placements& v,
                                                  int64_t i) {
  const int64_t row = clamp64(ld64(v.rows + i), 0, 2 * s.B - 1);
  const bool ok = v.valid == nullptr || __ldg(v.valid + i) != 0;
  const int64_t tp = ld64(v.tp + i);  // not behind valid's load: the
                                      // genome's gathers wait on it
  return Placement{row, ok ? tp : 0, __ldg(v.lens + read_of(row, v.nl))};
}

// FS3 for any W: the words one at a time (the read's base by base for
// code bytes and for reverse complements longer than L)
__global__ void __launch_bounds__(THREADS)
verify_kernel_any(Reads s, Placements v, int W,
                  const int32_t* __restrict__ pac, int64_t n_pac,
                  int64_t* __restrict__ out) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (i >= v.M) return;
  const Placement pl = placement_at(s, v, i);
  const int64_t row = pl.row, p = pl.tp, len = pl.len;
  const int64_t w0 = p >> 4;
  const uint32_t sh = 2 * static_cast<uint32_t>(p & 15);
  uint32_t lo = pac_word(pac, n_pac, w0);
  int64_t total = 0;
  for (int j = 0; j < W && len > 16 * static_cast<int64_t>(j); ++j) {
    const uint32_t hi = pac_word(pac, n_pac, w0 + j + 1);
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
verify_kernel(Reads s, Placements v, int W, const int32_t* __restrict__ pac,
              int64_t n_pac, int64_t* __restrict__ out) {
  constexpr int NG = (NW + 7) / 4;  // vectors covering NW + 1 words
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (i >= v.M) return;
  const Placement pl = placement_at(s, v, i);
  const int64_t row = pl.row, p = pl.tp, len = pl.len;

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
      gw[x] = x <= W ? pac_word(pac, n_pac, w0 + x) : 0u;
  }

  // the read's words
  uint32_t rw[NW];
  const bool fwd = row < s.B;
  const int64_t b = fwd ? row : row - s.B;
  const int64_t n = fwd ? 0 : rc_bases(s, b);
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

// An oriented row's 16 bytes from aligned loads, for GP and PK. A code
// source is B rows of L bytes at [data, data + B L): a row starts on an
// 8-byte boundary only where L is a multiple of 8, so 16 bytes at any
// offset are read as the (at most three) aligned 8-byte words that
// cover them, shifted into place. A word that lies inside the rows' bytes
// is one load; one that reaches past them (the batch's first bytes where
// data is not 8-aligned, its last ones where B L is not a multiple of 8,
// a reverse complement's bytes before its row) is read a byte at a time
// inside them, 0 outside. So no load reaches past the reads tensor, and
// the wrappers allocate no padding.

// bytes off .. off+7 of the rows' bytes (off a multiple of 8 from an
// 8-byte boundary), byte by byte inside [0, n), 0 outside
__device__ __noinline__ uint2 edge_word(const uint8_t* data, int64_t n,
                                        int64_t off) {
  uint32_t v[2] = {0u, 0u};
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (off + k >= 0 && off + k < n)
      v[k >> 2] |= static_cast<uint32_t>(__ldg(data + off + k))
                   << (8 * (k & 3));
  return make_uint2(v[0], v[1]);
}

// bytes off .. off+15 (off >= -16) of the rows' bytes, little-endian in
// v[0..3]; bytes outside [0, n) are 0
__device__ __forceinline__ void bytes16(const uint8_t* data, int64_t n,
                                        int64_t off, uint32_t v[4]) {
  const int r =
      static_cast<int>((reinterpret_cast<uintptr_t>(data) + off) & 7);
  const int64_t o0 = off - r;  // the first covering word, 8-aligned
  uint2 w[3];
  if (o0 >= 0 && o0 + (r ? 24 : 16) <= n) {
    const uint2* a = reinterpret_cast<const uint2*>(data + o0);
    w[0] = __ldg(a);
    w[1] = __ldg(a + 1);
    w[2] = r ? __ldg(a + 2) : make_uint2(0u, 0u);
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k) w[k] = edge_word(data, n, o0 + 8 * k);
  }
  const uint32_t u[6] = {w[0].x, w[0].y, w[1].x, w[1].y, w[2].x, w[2].y};
  const uint32_t sh = 8 * static_cast<uint32_t>(r & 3);
#pragma unroll
  for (int q = 0; q < 4; ++q)  // a shift of 4-7 bytes starts a word later
    v[q] = __funnelshift_r(r & 4 ? u[q + 1] : u[q],
                           r & 4 ? u[q + 2] : u[q + 1], sh);
}

// 0xFF in each of the first k bytes of a word (k clamped to 0..4)
__device__ __forceinline__ uint32_t byte_mask(int64_t k) {
  return k <= 0 ? 0u : k >= 4 ? 0xFFFFFFFFu : (1u << (8 * k)) - 1u;
}

// bytes i0 .. i0+15 (0 <= i0 < L) of oriented row `row` of code rows, as
// base_at gives them, in v[0..3] (bytes past L are the next row's or 0).
// A reverse complement of n bases (the caller's problem word, not
// Reads.rc_len): forward bytes n-16-i0 .. n-1-i0 reversed (__byte_perm)
// and complemented ((3 - c) & 0xFF, __vsub4), bytes at i >= n zeroed;
// where n > L a source byte past L-1 is byte L-1 (revcomp_reads clamps
// the index). GP and PK read their rows with it alone: their wrappers
// refuse packed rows.
__device__ __forceinline__ void oriented16(const Reads& s, int64_t row,
                                           int64_t n, int i0,
                                           uint32_t v[4]) {
  const uint8_t* data = static_cast<const uint8_t*>(s.data);
  const int64_t total = s.B * s.L;
  if (row < s.B) {
    bytes16(data, total, row * s.L + i0, v);
    return;
  }
  const int64_t b = row - s.B;
  const int64_t z = n - i0;  // bytes of the 16 inside the reverse complement
  if (z <= 0) {
    v[0] = v[1] = v[2] = v[3] = 0u;
    return;
  }
  const int64_t j0 = n - 16 - i0;  // the forward byte of output byte 15
  uint32_t f[4] = {0u, 0u, 0u, 0u};
  if (j0 < s.L) bytes16(data, total, b * s.L + j0, f);
  if (n > s.L) {  // forward bytes t >= L - j0 lie past the row: byte L-1
    const uint32_t c = __ldg(data + b * s.L + s.L - 1) * 0x01010101u;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t in = byte_mask(s.L - j0 - 4 * q);
      f[q] = (f[q] & in) | (c & ~in);
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    v[q] = __vsub4(0x03030303u, __byte_perm(f[3 - q], 0u, 0x0123)) &
           byte_mask(z - 4 * q);
}

// a GP candidate's or PK problem's words, one row of int32 bit patterns of
// u32 words as the host packs them (dp_rescue.rescue_words): its read row
// with the strand in bit 31, its window start's low and high 32 bits
// (positions pass 2^31 on a 3.1 Gbp text), the reverse complement's
// length; GP's rows add the counted bases and the window's length
constexpr int PK_WORDS = 4, GP_WORDS = 6;
constexpr uint32_t STRAND_BIT = 0x80000000u;

// the oriented row of a problem's word 0: rows B..2B-1 the reverse
// complements
__device__ __forceinline__ int64_t word_row(uint32_t w, int64_t B) {
  return static_cast<int64_t>(w & ~STRAND_BIT) + ((w & STRAND_BIT) ? B : 0);
}

// a problem's window start from its words 1 and 2
__device__ __forceinline__ int64_t word_start(const int32_t* w) {
  return static_cast<int64_t>((static_cast<uint64_t>(u32_at(w, 2)) << 32) |
                              u32_at(w, 1));
}

// GP: the gapless prescan. Candidate m's oriented row (its first
// min(L, rlen) bases; a reverse complement of its rc_len) against the
// genome window at its start: mm(o) = the bases l where window base
// o + l differs from read base l, over the valid offsets o <= min(O - 1,
// wlen - rlen); out[m] = (the least mm, its leftmost offset, the count of
// offsets with mm 0), or (NO_VALID, 0, 0) where no offset is valid; all
// three fit int32 (NO_VALID, offsets below O < 2^30).
constexpr int GP_GROUP = 8;  // consecutive offsets a thread counts
constexpr int GP_CHUNK = 8;  // read words a pass over them
constexpr int GP_EARLY = 2;  // rounds of window words loaded with the scalars
constexpr int64_t GP_NO_VALID = 1 << 20;

struct Prescan {
  const int32_t* words;  // (M, GP_WORDS) the candidates' words
  int64_t M;
  int O;                 // offsets a window
  int cap;               // window words a warp holds
  int nrw;               // read words a warp holds (a multiple of GP_CHUNK)
};

// the four bytes' 2-bit fields (byte k's low bits to bits 2k, 2k+1)
__device__ __forceinline__ uint32_t pack4(uint32_t x) {
  x &= 0x03030303u;
  x |= x >> 6;
  return (x & 0xFu) | ((x >> 12) & 0xF0u);
}

// read word j of a candidate from its 16 code bytes v, of which the first
// k count: the bases as 2-bit fields (*w) and the bit 2t of each base t
// that is a code 0-3 (*mk); returns how many counted bytes are not (they
// mismatch every window base: counted apart, for every offset)
__device__ __forceinline__ int read_word_mask(const uint32_t v[4], int64_t k,
                                              uint32_t* w, uint32_t* mk) {
  uint32_t ww = 0u, mm = 0u;
  int other = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t in = byte_mask(k - 4 * q) & 0x01010101u;
    // bit 0 of each byte whose code is above 3 (the bits above its two
    // low ones, summed into bit 6 without a carry between bytes)
    const uint32_t high =
        ((((v[q] >> 2) & 0x3F3F3F3Fu) + 0x3F3F3F3Fu) >> 6) & 0x01010101u;
    other += __popc(high & in);
    ww |= pack4(v[q]) << (8 * q);
    mm |= pack4(in & ~high) << (8 * q);
  }
  *w = ww & (mm | (mm << 1));
  *mk = mm;
  return other;
}

// one warp a candidate: its scalars, its first GP_EARLY rounds of window
// words (pac[w0 + k], the index clamped to pac, so any k may load) and its
// read row (lane j: bytes 16j .. 16j+15, oriented16) are all in flight before
// any is waited on; the window's words and the read's words and
// masks go to the warp's slice of shared memory; lane i counts the
// offsets of groups i, i + 32, ...: GP_GROUP offsets at once, GP_CHUNK
// read words at a time, a window word the funnel of two shared words,
// then XOR, fold, mask and popcount; then (min, leftmost argmin, zero
// count) over the warp by shuffles
__global__ void __launch_bounds__(THREADS)
prescan_kernel(Reads s, Prescan c, const int32_t* __restrict__ pac,
               int64_t n_pac, int32_t* __restrict__ out) {
  extern __shared__ uint32_t gp_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t m =
      blockIdx.x * static_cast<int64_t>(blockDim.x >> 5) + warp;
  if (m >= c.M) return;  // the whole warp
  uint32_t* win = gp_smem + warp * (c.cap + 2 * c.nrw);
  uint32_t* rw = win + c.cap;
  uint32_t* rm = rw + c.nrw;
  const int32_t* words = c.words + GP_WORDS * m;
  const int64_t row = word_row(u32_at(words, 0), s.B);
  const int64_t p = word_start(words);
  const int64_t rlen = __ldg(words + 4);
  const int64_t wlen = __ldg(words + 5);
  const int64_t w0 = p >> 4;
  uint32_t early[GP_EARLY];
#pragma unroll
  for (int e = 0; e < GP_EARLY; ++e)
    early[e] = pac_word(pac, n_pac, w0 + lane + 32 * e);
  const int64_t nb = clamp64(rlen, 0, s.L);
  int other = 0;
  for (int j = lane; 16 * j < s.L; j += 32) {
    uint32_t v[4];
    // the reverse complement's length loaded here, beside the row's
    // bytes: loaded with the other words and held, it made the offset
    // loop 5% slower on an H100 at O = 4,224 (another register
    // allocation, the loop scheduled worse)
    oriented16(s, row, __ldg(words + 3), 16 * j, v);
    other += read_word_mask(v, nb - 16 * j, rw + j, rm + j);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) other += __shfl_xor_sync(FULL, other, d);
  const int64_t room = wlen - rlen;
  const int64_t last = room < c.O - 1 ? room : c.O - 1;
  if (last < 0) {
    if (lane == 0) {
      out[3 * m] = GP_NO_VALID;
      out[3 * m + 1] = 0;
      out[3 * m + 2] = 0;
    }
    return;
  }
  const int nw = static_cast<int>((nb + 15) >> 4);
  const int nwp = (nw + GP_CHUNK - 1) / GP_CHUNK * GP_CHUNK;  // gw's reach
  const int a = static_cast<int>(p & 15);
  // offset o is bit position t = a + o of the words; group g holds t in
  // [GP_GROUP g, GP_GROUP (g + 1))
  const int groups = static_cast<int>((a + last) / GP_GROUP) + 1;
  const int nwin = (a + static_cast<int>(last)) / 16 + nwp + 1;
#pragma unroll
  for (int e = 0; e < GP_EARLY; ++e)
    if (lane + 32 * e < nwin) win[lane + 32 * e] = early[e];
  for (int k = lane + 32 * GP_EARLY; k < nwin; k += 32)
    win[k] = pac_word(pac, n_pac, w0 + k);
  __syncwarp();

  uint32_t best = 0xFFFFFFFFu;
  int best_o = 0, zeros = 0;
  for (int g = lane; g < groups; g += 32) {
    const int k0 = g * GP_GROUP / 16;
    const uint32_t sh0 = 2 * ((g * GP_GROUP) & 15);
    uint32_t cnt[GP_GROUP];
#pragma unroll
    for (int q = 0; q < GP_GROUP; ++q) cnt[q] = 0u;
    for (int j0 = 0; j0 < nw; j0 += GP_CHUNK) {
      uint32_t gw[GP_CHUNK + 1];
#pragma unroll
      for (int j = 0; j <= GP_CHUNK; ++j) gw[j] = win[k0 + j0 + j];
#pragma unroll
      for (int j = 0; j < GP_CHUNK; ++j) {
        if (j0 + j >= nw) break;  // the same for the whole warp
        const uint32_t r = rw[j0 + j], mk = rm[j0 + j];
#pragma unroll
        for (int q = 0; q < GP_GROUP; ++q) {
          const uint32_t x =
              __funnelshift_r(gw[j], gw[j + 1], sh0 + 2 * q) ^ r;
          cnt[q] += __popc((x | (x >> 1)) & mk);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < GP_GROUP; ++q) {
      const int o = g * GP_GROUP + q - a;
      if (o >= 0 && o <= last) {
        const uint32_t v = cnt[q] + other;
        if (v < best) {  // offsets rise: the first is the leftmost
          best = v;
          best_o = o;
        }
        zeros += v == 0u;
      }
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const uint32_t b2 = __shfl_xor_sync(FULL, best, d);
    const int o2 = __shfl_xor_sync(FULL, best_o, d);
    if (b2 < best || (b2 == best && o2 < best_o)) {
      best = b2;
      best_o = o2;
    }
    zeros += __shfl_xor_sync(FULL, zeros, d);
  }
  if (lane == 0) {
    out[3 * m] = static_cast<int32_t>(best);
    out[3 * m + 1] = best_o;
    out[3 * m + 2] = zeros;
  }
}

// PK: the DP rescue's problem pack. Problem p's read row, oriented by
// its strand (its row, or that read's reverse complement of its rc_len
// bases where the strand bit is set: rows B..2B-1 of Reads), to
// oriented[p] (L bytes), and its genome window's max_win 2-bit codes from
// its window start to wins[p].
struct Pack {
  const int32_t* words;      // (P, PK_WORDS) the problems' words
  uint32_t P;
  int max_win;               // window bases a problem
  uint32_t nw;               // window units a problem: ceil(max_win / 16)
  uint32_t nr;               // read units a problem: ceil(L / 16)
  uint32_t rblocks;          // the blocks of read units, before the others
};

// the 16 bases of a word as 16 code bytes (byte k = base k): each byte
// of the word (4 bases) spread to 4 bytes
__device__ __forceinline__ uint4 word_codes(uint32_t w) {
  uint32_t v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t b = (w >> (8 * q)) & 0xFFu;
    v[q] = (b | (b << 6) | (b << 12) | (b << 18)) & 0x03030303u;
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// bytes 0 .. n-1 (n <= 16) of v to dst: one 16-byte store where dst is
// 16-byte aligned, two 8-byte ones where it is 8-byte aligned (a row of
// L = 120), else whole 4-byte words and single bytes as the alignment
// and n allow
__device__ __forceinline__ void store_bytes(uint8_t* dst, const uint4& v,
                                            int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  if (n == 16 && (a & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) = v;
    return;
  }
  if (n == 16 && (a & 7) == 0) {
    reinterpret_cast<uint2*>(dst)[0] = make_uint2(v.x, v.y);
    reinterpret_cast<uint2*>(dst)[1] = make_uint2(v.z, v.w);
    return;
  }
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  const bool words = (a & 3) == 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (words && 4 * q + 4 <= n) {
      *reinterpret_cast<uint32_t*>(dst + 4 * q) = w[q];
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * q + k < n)
          dst[4 * q + k] = static_cast<uint8_t>(w[q] >> (8 * k));
    }
  }
}

// one thread a unit of 16 output bytes, the read units and the window
// units in blocks of their own (the first rblocks blocks: read units), so
// no warp mixes the two; P times either count of units is below 2^31
// (the wrapper checks it), so a unit's index is 32-bit. Read unit i of
// problem p: bytes 16i .. 16i+15 of its oriented row (oriented16), one store.
// Window unit u: pac words w0 + u and w0 + u + 1, funnel-shifted to the
// 2-bit grid, spread to codes. A warp's units are consecutive, so its
// stores are contiguous.
__global__ void __launch_bounds__(THREADS)
pack_kernel(Reads s, Pack c, const int32_t* __restrict__ pac, int64_t n_pac,
            uint8_t* __restrict__ oriented, uint8_t* __restrict__ wins) {
  if (blockIdx.x < c.rblocks) {
    const uint32_t t = blockIdx.x * THREADS + threadIdx.x;
    const uint32_t p = t / c.nr;
    if (p >= c.P) return;
    const int i0 = 16 * static_cast<int>(t - p * c.nr);
    const int32_t* words = c.words + PK_WORDS * static_cast<int64_t>(p);
    const int64_t row = word_row(u32_at(words, 0), s.B);
    uint32_t v[4];
    oriented16(s, row, __ldg(words + 3), i0, v);
    const int n = s.L - i0;
    store_bytes(oriented + static_cast<int64_t>(p) * s.L + i0,
                make_uint4(v[0], v[1], v[2], v[3]), n < 16 ? n : 16);
    return;
  }
  const uint32_t t = (blockIdx.x - c.rblocks) * THREADS + threadIdx.x;
  const uint32_t p = t / c.nw;
  if (p >= c.P) return;
  const uint32_t u = t - p * c.nw;
  const int64_t ws = word_start(c.words + PK_WORDS * static_cast<int64_t>(p));
  const int64_t k = (ws >> 4) + u;
  const uint32_t sh = 2 * static_cast<uint32_t>(ws & 15);
  const uint32_t w = __funnelshift_r(pac_word(pac, n_pac, k),
                                     pac_word(pac, n_pac, k + 1), sh);
  const int n = c.max_win - 16 * static_cast<int>(u);
  store_bytes(wins + static_cast<int64_t>(p) * c.max_win + 16 * u,
              word_codes(w), n < 16 ? n : 16);
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + THREADS - 1) / THREADS);
}

}  // namespace

extern "C" {

// the seed arguments of FS1, FS2x and FS2s (Seeds): start, length, lens,
// pos, slen, nl, segments, lo, q
int soap3dp_fm_search(const void* reads, int kind, long long B, int L, int W,
                      const int32_t* rc_len, long long rc_all, int S,
                      const int64_t* start, const int64_t* length,
                      const int32_t* lens, const int32_t* pos,
                      const int32_t* slen, long long nl, int segments, int lo,
                      int q,
                      long long N, int mode, int max_steps, int k,
                      const int32_t* blocks, const int64_t* counts,
                      const int32_t* lut_lo, const int32_t* lut_hi,
                      long long primary, long long n1,
                      int64_t* l_out, int64_t* r_out, void* stream) {
  const Reads s{reads, rc_len, rc_all, B, kind, L, W};
  const Tables t{reinterpret_cast<const uint4*>(blocks), counts, primary};
  const Seeds sd{start, length, lens, pos, slen, nl, segments, lo, q};
  with_seed_form(sd, [&](auto form) {
    fm_search_kernel<decltype(form)::value>
        <<<blocks_for(N), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
            s, S, sd, N, mode, max_steps, k, t, lut_lo, lut_hi, n1, l_out,
            r_out);
  });
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
                          long long RS, const int64_t* start,
                          const int32_t* lens, const int32_t* pos,
                          const int32_t* slen, long long nl, int segments,
                          int seg_lo, int q, int S, long long n,
                          long long K, int sa_rate, const int32_t* mark_words,
                          const int32_t* mark_rank, const int32_t* blocks,
                          const int64_t* counts, long long primary,
                          const int32_t* sa, long long n_sa, int64_t* krow,
                          int64_t* ktp, uint8_t* pos_ok, int64_t* lane_out,
                          int64_t* rank_out, int64_t* step_out,
                          void* stream) {
  const Marks mk{mark_words, mark_rank, sa, n_sa, sa_rate};
  const Tables t{reinterpret_cast<const uint4*>(blocks), counts, primary};
  const Seeds sd{start, nullptr, lens, pos, slen, nl, segments, seg_lo, q};
  const Lanes e{lo, incl, sd, RS, n, S};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rank_out)  // the ranks form reads no seed
    expand_decode_kernel<OUT_RANKS, SEED_GIVEN>
        <<<blocks_for(K), THREADS, 0, st>>>(
            e, K, mk, t,
            Slots{lane_out, rank_out, nullptr, step_out, nullptr, K});
  else
    with_seed_form(sd, [&](auto form) {
      expand_decode_kernel<OUT_KEYS, decltype(form)::value>
          <<<blocks_for(K), THREADS, 0, st>>>(
              e, K, mk, t, Slots{krow, ktp, pos_ok, nullptr, nullptr, K});
    });
  return static_cast<int>(cudaGetLastError());
}

int soap3dp_seed_expand_decode(const int64_t* lo, const int64_t* incl,
                               long long RS, const int64_t* start,
                               const int32_t* lens, const int32_t* pos,
                               const int32_t* slen, long long nl,
                               int segments, int seg_lo, int q, int S,
                               long long K, int sa_rate,
                               const int32_t* mark_words,
                               const int32_t* mark_rank,
                               const int32_t* blocks, const int64_t* counts,
                               long long primary, const int32_t* sa,
                               long long n_sa, uint32_t* words,
                               int64_t* lane_out, int64_t* rank_out,
                               int64_t* step_out, void* stream) {
  const Marks mk{mark_words, mark_rank, sa, n_sa, sa_rate};
  const Tables t{reinterpret_cast<const uint4*>(blocks), counts, primary};
  const Seeds sd{start, nullptr, lens, pos, slen, nl, segments, seg_lo, q};
  const Lanes e{lo, incl, sd, RS, 0, S};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rank_out)  // the ranks form reads no seed
    seed_expand_kernel<OUT_RANKS, SEED_GIVEN>
        <<<blocks_for(K), THREADS, 0, st>>>(
            e, K, mk, t,
            Slots{lane_out, rank_out, nullptr, step_out, nullptr, K});
  else
    with_seed_form(sd, [&](auto form) {
      seed_expand_kernel<OUT_SEED, decltype(form)::value>
          <<<blocks_for(K), THREADS, 0, st>>>(
              e, K, mk, t,
              Slots{nullptr, nullptr, nullptr, nullptr, words, K});
    });
  return static_cast<int>(cudaGetLastError());
}

// table: the caller's 64-bit table of at least 2^hb slots, kept across
// calls on this stream (zeroed once), gen above every earlier call's on
// it; scan, base, tag: the scan state, as soap3dp_lane_counts's, for
// ceil(K / TILE) tiles. The first launch has a thread for each of
// max(K, K2) slots.
int soap3dp_dedupe(const int64_t* krow, const int64_t* ktp,
                   const uint8_t* pos_ok, long long K, long long K2, int hb,
                   unsigned gen, unsigned long long* table,
                   unsigned long long* scan, unsigned base, unsigned tag,
                   int64_t* urow, int64_t* utp, uint8_t* uvalid,
                   int64_t* uniq, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t tiles = (K + TILE - 1) / TILE;
  dedupe_scatter_kernel<<<blocks_for(K > K2 ? K : K2), THREADS, 0, st>>>(
      krow, ktp, pos_ok, K, K2, hb, gen, table, urow, utp, uvalid);
  dedupe_scan_kernel<<<static_cast<unsigned>(tiles), THREADS, 0, st>>>(
      krow, ktp, pos_ok, K, K2, hb, table, scan + 1, tiles,
      reinterpret_cast<unsigned*>(scan), base, tag, urow, utp, uvalid, uniq);
  return static_cast<int>(cudaGetLastError());
}

// scratch: the scan state, the caller's int64 words kept across calls on
// this stream (zeroed once), shared with soap3dp_dedupe: the ticket
// counter, then at least ceil(RS / COUNT_TILE) tile statuses;
// base: the tickets earlier calls took there; tag: this call's
// generation << 2, above every earlier call's there. flags (search mode;
// null for the seeding's): ceil(B / 32) words. l, r and incl lie on
// 16-byte boundaries.
int soap3dp_lane_counts(const int64_t* l, const int64_t* r, long long RS,
                        long long cap, int S, unsigned long long* scratch,
                        unsigned base, unsigned tag, int64_t* incl,
                        int64_t* total, uint32_t* flags, long long nf,
                        void* stream) {
  const int64_t tiles = (RS + COUNT_TILE - 1) / COUNT_TILE;
  lane_counts_kernel<<<static_cast<unsigned>(tiles), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      l, r, RS, cap, S, tiles, scratch + 1,
      reinterpret_cast<unsigned*>(scratch), base, tag, incl, total, flags,
      nf);
  return static_cast<int>(cudaGetLastError());
}

// the first n words of each of `rows` rows of `pitch` words at src (on
// the card) to dst (pinned host memory, rows of n words): one 2-D copy
// on the stream (the DP seeding's prefix of its packed words), no kernel
int soap3dp_copy_prefix(const int32_t* src, long long pitch, long long n,
                        int rows, int32_t* dst, void* stream) {
  if (n == 0) return 0;
  const size_t w = static_cast<size_t>(n) * sizeof(int32_t);
  return static_cast<int>(cudaMemcpy2DAsync(
      dst, w, src, static_cast<size_t>(pitch) * sizeof(int32_t), w, rows,
      cudaMemcpyDeviceToHost, static_cast<cudaStream_t>(stream)));
}

// wire: 2 + nf + 2 K2 words; one thread a slot (one at least, for the
// totals)
int soap3dp_search_wire(const int64_t* urow, const int64_t* utp,
                        const uint8_t* uvalid, const int64_t* nmis,
                        long long K2, int k, const int64_t* total,
                        const int64_t* uniq, uint32_t* wire, long long nf,
                        void* stream) {
  search_wire_kernel<<<blocks_for(K2 > 0 ? K2 : 1), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      urow, utp, uvalid, nmis, K2, k, total, uniq, wire, nf);
  return static_cast<int>(cudaGetLastError());
}

// rows clamped to the 2B oriented rows, tp 0 where valid (null: every
// placement) is 0, row r's read length lens[r mod nl]
int soap3dp_verify(const void* reads, int kind, long long B, int L, int Ws,
                   const int32_t* rc_len, long long rc_all,
                   const int64_t* rows, const int64_t* tp,
                   const uint8_t* valid, const int32_t* lens, long long nl,
                   long long M, int W, const int32_t* pac, long long n_pac,
                   int64_t* out, void* stream) {
  const Reads s{reads, rc_len, rc_all, B, kind, L, Ws};
  const Placements v{rows, tp, valid, lens, nl, M};
  const int need = W > (L + 15) / 16 ? W : (L + 15) / 16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (need <= 8)
    verify_kernel<8><<<blocks_for(M), THREADS, 0, st>>>(s, v, W, pac, n_pac,
                                                         out);
  else if (need <= 16)
    verify_kernel<16><<<blocks_for(M), THREADS, 0, st>>>(s, v, W, pac,
                                                          n_pac, out);
  else
    verify_kernel_any<<<blocks_for(M), THREADS, 0, st>>>(s, v, W, pac, n_pac,
                                                         out);
  return static_cast<int>(cudaGetLastError());
}

// shared memory: a warp's window words (cap) and read words and masks
// (nrw each), as many warps a block as 48 KB hold (at most THREADS / 32;
// one warp up to the 227 KB a block may have)
int soap3dp_prescan(const void* reads, int kind, long long B, int L, int Ws,
                    const int32_t* rc_len, long long rc_all,
                    const int32_t* words, long long M, int O,
                    const int32_t* pac, long long n_pac, int32_t* out,
                    void* stream) {
  const Reads s{reads, rc_len, rc_all, B, kind, L, Ws};
  const int nrw = ((L + 15) / 16 + GP_CHUNK - 1) / GP_CHUNK * GP_CHUNK;
  const int cap = (O + 14) / 16 + nrw + 1;
  const long long warp_bytes = 4ll * (cap + 2 * nrw);
  long long warps = 48 * 1024 / warp_bytes;
  warps = warps < 1 ? 1 : (warps > THREADS / 32 ? THREADS / 32 : warps);
  const long long smem = warps * warp_bytes;
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        prescan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const Prescan c{words, M, O, cap, nrw};
  prescan_kernel<<<static_cast<unsigned>((M + warps - 1) / warps),
                   static_cast<unsigned>(32 * warps),
                   static_cast<size_t>(smem),
                   static_cast<cudaStream_t>(stream)>>>(s, c, pac, n_pac,
                                                        out);
  return static_cast<int>(cudaGetLastError());
}

int soap3dp_pack_problems(const void* reads, int kind, long long B, int L,
                          int Ws, const int32_t* rc_len, long long rc_all,
                          const int32_t* words, long long P, int max_win,
                          const int32_t* pac, long long n_pac,
                          uint8_t* oriented, uint8_t* wins, void* stream) {
  const Reads s{reads, rc_len, rc_all, B, kind, L, Ws};
  const uint32_t nw = (max_win + 15) / 16, nr = (L + 15) / 16;
  const unsigned rblocks = blocks_for(P * nr);
  const Pack c{words, static_cast<uint32_t>(P), max_win, nw, nr, rblocks};
  pack_kernel<<<rblocks + blocks_for(P * nw), THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(s, c, pac, n_pac,
                                                     oriented, wins);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
