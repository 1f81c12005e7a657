// DW, the DP rescue's result wire, for Hopper (sm_90a).
//
// Replaces what `dp_align` (soap3dp_tpu/kernels/banded_dp.py:1000-1015)
// does on the device after the fused kernel: the lanes that pass the
// cutoff are gathered as 16-bit rows (`_gather_runs_u16`, :932) and
// downloaded in one transfer; and, on the wide route, the per-problem
// op streams gathered for the host's run-length encoding
// (`_gather_opseq_rows`, :479) and the stats stacked for their download
// (`_stack4`, :486). Here every DP call ends in one device buffer, the
// wire, which the host downloads in two copies (header and stats, then
// the runs at their exact length):
//
//   int32 [0, 4)          header: passing lanes, overflowed lanes, run
//                         words, the wire's length in int32 words
//   int32 [4, 4 + 8n)     each lane's stats row (score, hit_i, hit_j,
//                         n_best, startj, nrun, overflow, 0), written
//                         there by K1, or by K2 and TB, not by DW
//   [4 + 8n, length)      the runs of the passing lanes (score >= cutoff,
//                         nrun > 0, no overflow) in lane order, each
//                         lane's nrun words: 16-bit (op << 12) | count
//                         (K1's windows and reads below 4096) or 32-bit
//                         (op << 28) | count; an odd count of 16-bit
//                         words ends in one zero half word.
//
// DW reads the stats and the cutoffs (the params rows' column 6), and
// copies each passing lane's nrun words from its row of the runs
// (n, MR) to the lane's offset: the prefix sum of the passing lanes'
// nrun before it.
//
// What bounds it: bytes, and nearly nothing of them (16 bytes a lane,
// the passing lanes' words read and written once: ~0.25 us at phase 4's
// 16,384 lanes), so a launch (~1 us of device time for an empty one)
// and the latency of its dependent steps cost more than its traffic.
// Design: one launch a call, a single-pass scan, no fence. A block of
// THREADS takes a ticket and the tile of TILE lanes it names (64: 256
// blocks at 16,384 lanes, two an SM), reads each lane's stats row and
// cutoff as three 16-byte vectors, scans the tile's words (warp
// shuffles) into word offsets in shared memory, and finds the words
// before the tile by the decoupled look-back FS4 and FS5 use
// (tile_lookback.cuh), in one warp. The copy needs the tile's own
// offsets for its loads and the words before it only for its stores,
// so while that warp looks back the other threads load the tile's
// first PRE x K words (K consecutive words a thread, found by a binary
// search in the offsets, then a walk), every load in flight before any
// store; once the look-back ends they store them (16-byte vectors
// where the tile's place in the wire aligns them, else word by word),
// and every thread copies what is left of the tile in 16-byte units of
// the output (a unit's loads in flight before its store; units shared
// with a neighbouring tile word by word). The header: each tile
// publishes its passing and overflowed lanes as one 64-bit word tagged
// like its status, before its look-back; the last tile writes the words
// and the length from its look-back, and one of its warps sums every
// tile's lanes word once it holds this call's tag. So no second launch
// re-reads the stats, no launch zeroes anything, and no tile waits on a
// fence. Measured on an H100 against two launches (a tile's totals,
// then each tile's sum of the totals before it, its scan and a copy of
// one output word a thread): see PERF.md.
//
// Concurrent callers: the statuses and the ticket counter are the scan
// state FS4 and FS5 keep for each card and stream (the wrapper's
// `fm_search.gen_state("scan", ...)`), each call's statuses tagged with
// its generation and its tickets counted from the ones earlier calls
// took, so nothing clears them. Calls on one stream run one after the
// other; the wrapper queues a call's launch under the state's lock, so
// two host threads on one stream (the rescue flush's worker and the
// main thread, both on the card's default stream) take generations in
// the order their launches run, and host threads on other streams or
// cards (one a card on a mesh) have states of their own.
//
// Plain C interface for ctypes; the launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_lookback.cuh"

namespace {

using soap3dp_lookback::FULL;
using soap3dp_lookback::ld_status;
using soap3dp_lookback::LOOKBACK;
using soap3dp_lookback::st_status;
using soap3dp_lookback::status_word;
using soap3dp_lookback::tile_lookback;
using soap3dp_lookback::warp_scan;

constexpr int TILE = 64;                // lanes a tile, one a thread of
constexpr int COUNT_WARPS = TILE / 32;  // the first warps; then a warp's
constexpr int THREADS = 128;            // look-back, the header's warp
constexpr int UNIT = 16;                // bytes of an output unit
constexpr int K = 8;                    // words a thread loads early,
constexpr int PRE = THREADS - 32;       // the threads that do
constexpr uint32_t ST_LANES = 3u;       // a tile's passing, overflowed
static_assert(THREADS >= 32 * (COUNT_WARPS + 2), "a warp each");
static_assert(K % (UNIT / 2) == 0, "a thread's early words whole units");
static_assert(TILE < (1 << 16), "a tile's lanes in 16 bits");

struct Count {
  int words, pass, over;
};

// lane t: its run words in the wire (0 unless it passes), whether it
// passes and whether it overflowed its run budget; its stats row and
// its params row's words 4-7 as 16-byte vectors
__device__ __forceinline__ Count lane_count(const int32_t* st,
                                            const int32_t* __restrict__ prm,
                                            int64_t t) {
  const int4 a = __ldg(reinterpret_cast<const int4*>(st + 8 * t));
  const int4 b = __ldg(reinterpret_cast<const int4*>(st + 8 * t + 4));
  const int4 p = __ldg(reinterpret_cast<const int4*>(prm + 8 * t + 4));
  const int score = a.x, nrun = b.y, of = b.z, cutoff = p.z;
  const bool traced = score >= cutoff;
  const bool pass = traced && nrun > 0 && of == 0;
  return Count{pass ? nrun : 0, pass, traced && of != 0};
}

// where the tile-local words w0 .. w0 + N - 1 lie in the tile's runs
// (lane x MR + index; -1 for a word outside [from, W)): the lane of the
// first by a binary search in the tile's offsets (the last lane whose
// first word is at or before it: lanes of no words share the next
// lane's offset), then a walk
template <int N>
__device__ __forceinline__ void locate(const int* off, int MR, int w0,
                                       int from, int W, int* at) {
  const int f = w0 > from ? w0 : from;
  int lo = 0, hi = TILE;  // off[lo] <= f < off[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (off[mid] <= f) lo = mid; else hi = mid;
  }
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const int w = w0 + e;
    at[e] = -1;
    if (w >= from && w < W) {
      while (off[lo + 1] <= w) ++lo;
      at[e] = lo * MR + (w - off[lo]);
    }
  }
}

// the N words `at` names, every load issued before any is used
template <int N, typename Word>
__device__ __forceinline__ void load_words(const Word* src, const int* at,
                                           Word* v) {
#pragma unroll
  for (int e = 0; e < N; ++e) v[e] = at[e] >= 0 ? __ldg(src + at[e]) : 0;
}

// E words (all of one unit) as one 16-byte store
__device__ __forceinline__ void store_unit(uint16_t* out, const uint16_t* v) {
  uint4 u;
  u.x = v[0] | (uint32_t(v[1]) << 16);
  u.y = v[2] | (uint32_t(v[3]) << 16);
  u.z = v[4] | (uint32_t(v[5]) << 16);
  u.w = v[6] | (uint32_t(v[7]) << 16);
  *reinterpret_cast<uint4*>(out) = u;
}

__device__ __forceinline__ void store_unit(uint32_t* out, const uint32_t* v) {
  *reinterpret_cast<uint4*>(out) = make_uint4(v[0], v[1], v[2], v[3]);
}

// words v to output words g .. g + N - 1 where `at` names them (the
// others are another tile's): 16-byte units where all N are named and g
// is a unit's first word, else word by word
template <int N, typename Word>
__device__ __forceinline__ void store_words(Word* out, int64_t g,
                                            const int* at, const Word* v) {
  constexpr int E = UNIT / sizeof(Word);
  bool whole = g % E == 0;
#pragma unroll
  for (int e = 0; e < N; ++e) whole &= at[e] >= 0;
  if (whole) {
#pragma unroll
    for (int e = 0; e < N; e += E) store_unit(out + g + e, v + e);
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e)
      if (at[e] >= 0) out[g + e] = v[e];
  }
}

// the header's passing and overflowed lanes, by one warp of the last
// tile: the sum of every tile's lanes word, each read once it holds
// this call's tag
__device__ void header_lanes(const unsigned long long* lanes, int tiles,
                             int lane, uint32_t tag, int32_t* wire) {
  const uint32_t want = tag | ST_LANES;
  uint32_t pass = 0, over = 0;
  for (int j = 0; j < tiles; j += 32 * LOOKBACK) {
    uint64_t s[LOOKBACK];
#pragma unroll
    for (int q = 0; q < LOOKBACK; ++q) {
      const int i = j + 32 * q + lane;
      s[q] = i < tiles ? ld_status(lanes + i) : status_word(tag, ST_LANES, 0);
    }
    for (;;) {  // until every word holds this call's
      bool wait = false;
#pragma unroll
      for (int q = 0; q < LOOKBACK; ++q)
        wait |= static_cast<uint32_t>(s[q] >> 32) != want;
      if (!__any_sync(FULL, wait)) break;
      __nanosleep(32);
#pragma unroll
      for (int q = 0; q < LOOKBACK; ++q)
        if (static_cast<uint32_t>(s[q] >> 32) != want)
          s[q] = ld_status(lanes + j + 32 * q + lane);
    }
#pragma unroll
    for (int q = 0; q < LOOKBACK; ++q) {
      pass += static_cast<uint32_t>(s[q]) >> 16;
      over += static_cast<uint32_t>(s[q]) & 0xffffu;
    }
  }
  pass = __reduce_add_sync(FULL, pass);
  over = __reduce_add_sync(FULL, over);
  if (lane == 0) {
    wire[0] = static_cast<int32_t>(pass);
    wire[1] = static_cast<int32_t>(over);
  }
}

template <typename Word>
__global__ void __launch_bounds__(THREADS)
dp_wire_kernel(const int32_t* __restrict__ params, int n,
               const Word* __restrict__ runs, int MR, int tiles,
               unsigned long long* status, unsigned* __restrict__ ticket,
               uint32_t base, uint32_t tag, int32_t* wire) {
  __shared__ unsigned my_ticket;
  __shared__ int off[TILE + 1];  // its lanes' first words, then its end
  __shared__ int3 warp_sum[COUNT_WARPS];  // words, passing, overflowed
  __shared__ int tile_before;
  if (threadIdx.x == 0) my_ticket = atomicAdd(ticket, 1u) - base;
  __syncthreads();
  const int t = static_cast<int>(my_ticket);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t t0 = static_cast<int64_t>(t) * TILE;
  unsigned long long* lanes = status + tiles;  // the tiles' lanes words

  // the tile's counts and word offsets: a scan a warp, then the warps'
  Count c{0, 0, 0};
  int incl = 0;
  if (warp < COUNT_WARPS) {
    if (t0 + threadIdx.x < n) c = lane_count(wire + 4, params, t0 + threadIdx.x);
    incl = warp_scan(c.words, lane);
    const int pass = __reduce_add_sync(FULL, c.pass);
    const int over = __reduce_add_sync(FULL, c.over);
    if (lane == 31) warp_sum[warp] = make_int3(incl, pass, over);
  }
  __syncthreads();
  int3 s = make_int3(0, 0, 0);
#pragma unroll
  for (int w = 0; w < COUNT_WARPS; ++w) {
    s.x += warp_sum[w].x;
    s.y += warp_sum[w].y;
    s.z += warp_sum[w].z;
  }
  if (warp < COUNT_WARPS) {
    int before = incl - c.words;
    for (int w = 0; w < warp; ++w) before += warp_sum[w].x;
    off[threadIdx.x] = before;
  } else if (warp == COUNT_WARPS && lane == 0) {
    off[TILE] = s.x;
    st_status(lanes + t, status_word(tag, ST_LANES,
                                     (static_cast<uint32_t>(s.y) << 16) |
                                         static_cast<uint32_t>(s.z)));
  }
  __syncthreads();
  const int W = s.x;
  const Word* src = runs + t0 * MR;
  // the tile's first PRE x K words, loaded while the look-back runs
  // (thread p: words pK .. pK + K - 1, p counting the threads of every
  // warp but the look-back's)
  const int p = warp < COUNT_WARPS ? threadIdx.x : threadIdx.x - 32;
  int at[K];
  Word v[K];
  if (warp == COUNT_WARPS) {
    const int before = tile_lookback<false>(status, t, W, lane, tag);
    if (lane == 0) {
      tile_before = before;
      if (t == tiles - 1) {
        const int words = before + W;
        const int64_t bytes = static_cast<int64_t>(words) * sizeof(Word);
        if (sizeof(Word) == 2 && (words & 1))
          reinterpret_cast<Word*>(wire + 4 + 8LL * n)[words] = 0;
        wire[2] = words;
        wire[3] = static_cast<int>(4 + 8LL * n + (bytes + 3) / 4);
      }
    }
  } else if (p * K < W) {
    locate<K>(off, MR, p * K, 0, W, at);
    load_words<K>(src, at, v);
  }
  __syncthreads();
  const int64_t B = tile_before;
  Word* out = reinterpret_cast<Word*>(wire + 4 + 8LL * n);
  if (warp != COUNT_WARPS && p * K < W) store_words<K>(out, B + p * K, at, v);
  // the rest, [L0, W): 16-byte units of the output, each thread's loads
  // in flight before its store
  constexpr int E = UNIT / sizeof(Word);
  const int L0 = PRE * K < W ? PRE * K : W;
  const int64_t u1 = (B + W + E - 1) / E;
  for (int64_t u = (B + L0) / E + threadIdx.x; u < u1; u += THREADS) {
    int ua[E];
    Word uv[E];
    locate<E>(off, MR, static_cast<int>(u * E - B), L0, W, ua);
    load_words<E>(src, ua, uv);
    store_words<E>(out, u * E, ua, uv);
  }
  if (warp == COUNT_WARPS + 1 && t == tiles - 1)
    header_lanes(lanes, tiles, lane, tag, wire);
}

}  // namespace

// wire: int32 on a 16-byte boundary, at least 4 + 8n words and the
// runs' room after them, its stats rows written; params: (n, 8) int32
// rows on a 16-byte boundary; runs: (n, MR) words of word_bits (16 or
// 32) bits; scan: the scan state, the caller's int64 words kept across
// calls on this stream (zeroed once), shared with soap3dp_dedupe and
// soap3dp_lane_counts: the ticket counter, then at least 2 `tiles`
// words (the tiles' statuses, then their lanes words); base: the
// tickets earlier calls took there; tag: this call's generation << 2,
// above every earlier call's there; tiles:
// max(1, ceil(n / TILE)) (n of 0: one tile writes the header)
extern "C" int soap3dp_dp_wire(const void* params, int n, const void* runs,
                               int MR, int word_bits, void* wire,
                               unsigned long long* scan, unsigned base,
                               unsigned tag, int tiles, void* stream) {
  const int want = n > 0 ? (n + TILE - 1) / TILE : 1;
  if (n < 0 || tiles != want || (word_bits != 16 && word_bits != 32) ||
      reinterpret_cast<uintptr_t>(wire) % UNIT ||
      reinterpret_cast<uintptr_t>(params) % UNIT)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* prm = static_cast<const int32_t*>(params);
  auto* w = static_cast<int32_t*>(wire);
  auto* ticket = reinterpret_cast<unsigned*>(scan);
  if (word_bits == 16)
    dp_wire_kernel<uint16_t><<<tiles, THREADS, 0, s>>>(
        prm, n, static_cast<const uint16_t*>(runs), MR, tiles, scan + 1,
        ticket, base, tag, w);
  else
    dp_wire_kernel<uint32_t><<<tiles, THREADS, 0, s>>>(
        prm, n, static_cast<const uint32_t*>(runs), MR, tiles, scan + 1,
        ticket, base, tag, w);
  return static_cast<int>(cudaGetLastError());
}
