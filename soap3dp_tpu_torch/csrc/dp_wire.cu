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
// nrun before it. What bounds it: bytes, and nearly nothing of them
// (16 bytes a lane, the passing lanes' words read and written once): a
// launch costs more than its traffic, so the design is for few launches
// and many blocks. Two launches on the stream, no state across calls
// (concurrent calls, the rescue flush's worker thread and one host
// thread a card on a mesh, share nothing and take no lock): the first,
// a tile of TILE lanes a block, one a thread, writes each tile's totals
// (words, passing and overflowed lanes) to the call's scratch; the
// second sums the totals of the tiles before its own (a few hundred
// bytes), scans its tile (warp shuffles) into word offsets in shared
// memory, and copies its tile's words one output word a thread, each
// finding its lane by a binary search over those offsets, so the stores
// are contiguous and every load is in flight at once, however the runs
// spread over the lanes; its last block writes the header.
//
// Plain C interface for ctypes; the launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 256;  // lanes a block, one a thread
constexpr unsigned FULL = 0xffffffffu;

struct Count {
  int words, pass, over;
};

// lane t: its run words in the wire (0 unless it passes), whether it
// passes and whether it overflowed its run budget
__device__ __forceinline__ Count lane_count(const int32_t* __restrict__ st,
                                            const int32_t* __restrict__ prm,
                                            long long t) {
  const int score = st[t * 8], nrun = st[t * 8 + 5], of = st[t * 8 + 6];
  const bool traced = score >= prm[t * 8 + 6];
  const bool pass = traced && nrun > 0 && of == 0;
  return Count{pass ? nrun : 0, pass, traced && of != 0};
}

__device__ __forceinline__ Count add(Count a, Count b) {
  return Count{a.words + b.words, a.pass + b.pass, a.over + b.over};
}

// the block's sum of c (every thread gets it)
__device__ Count block_sum(Count c, Count* part) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    c.words += __shfl_xor_sync(FULL, c.words, o);
    c.pass += __shfl_xor_sync(FULL, c.pass, o);
    c.over += __shfl_xor_sync(FULL, c.over, o);
  }
  if (lane == 0) part[wid] = c;
  __syncthreads();
  Count s{0, 0, 0};
#pragma unroll
  for (int w = 0; w < TILE / 32; ++w) s = add(s, part[w]);
  __syncthreads();  // part is reused
  return s;
}

// tile b's totals (words, passing lanes, overflowed lanes) to totals[3b]
__global__ void __launch_bounds__(TILE)
dp_wire_count_kernel(const int32_t* __restrict__ params, int n,
                     const int32_t* __restrict__ wire,
                     int32_t* __restrict__ totals) {
  __shared__ Count part[TILE / 32];
  const long long t = (long long)blockIdx.x * TILE + threadIdx.x;
  const Count c = block_sum(
      t < n ? lane_count(wire + 4, params, t) : Count{0, 0, 0}, part);
  if (threadIdx.x == 0) {
    totals[3 * blockIdx.x] = c.words;
    totals[3 * blockIdx.x + 1] = c.pass;
    totals[3 * blockIdx.x + 2] = c.over;
  }
}

template <typename Word>
__global__ void __launch_bounds__(TILE)
dp_wire_copy_kernel(const int32_t* __restrict__ params, int n,
                    const Word* __restrict__ runs, int MR,
                    const int32_t* __restrict__ totals,
                    int32_t* __restrict__ wire) {
  __shared__ Count part[TILE / 32];
  __shared__ int warp_words[TILE / 32];
  __shared__ int off[TILE + 1];  // its lanes' first words, then its end
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const long long t0 = (long long)blockIdx.x * TILE;

  // the tiles before this one
  Count before{0, 0, 0};
  for (int k = threadIdx.x; k < (int)blockIdx.x; k += TILE)
    before = add(before, Count{totals[3 * k], totals[3 * k + 1],
                               totals[3 * k + 2]});
  before = block_sum(before, part);

  // this tile's word offsets: an exclusive scan, warp then block
  const Count mine = t0 + threadIdx.x < n
                         ? lane_count(wire + 4, params, t0 + threadIdx.x)
                         : Count{0, 0, 0};
  int incl = mine.words;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_words[wid] = incl;
  const Count tile = block_sum(mine, part);  // syncs: warp_words is set
  int excl = incl - mine.words;
  for (int w = 0; w < wid; ++w) excl += warp_words[w];
  off[threadIdx.x] = excl;
  if (threadIdx.x == 0) off[TILE] = tile.words;
  __syncthreads();

  Word* out = reinterpret_cast<Word*>(wire + 4 + 8LL * n) + before.words;
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) {
    const Count all = add(before, tile);
    const long long bytes = (long long)all.words * sizeof(Word);
    if (sizeof(Word) == 2 && (all.words & 1)) out[tile.words] = 0;
    wire[0] = all.pass;
    wire[1] = all.over;
    wire[2] = all.words;
    wire[3] = (int)(4 + 8LL * n + (bytes + 3) / 4);
  }
  // one output word a thread: its lane is the last whose first word is
  // at or before it (lanes of no words share the next lane's offset)
  for (int w = threadIdx.x; w < tile.words; w += TILE) {
    int lo = 0, hi = TILE;  // off[lo] <= w < off[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (off[mid] <= w) lo = mid; else hi = mid;
    }
    out[w] = runs[(t0 + lo) * MR + (w - off[lo])];
  }
}

}  // namespace

// wire: int32, at least 4 + 8n words and the runs' room after them, its
// stats rows written; params: (n, 8) int32 rows; runs: (n, MR) words of
// word_bits (16 or 32) bits; totals: int32 scratch of 3 words a tile of
// soap3dp_dp_wire_tile() lanes, tiles of them
extern "C" int soap3dp_dp_wire(const void* params, int n, const void* runs,
                               int MR, int word_bits, void* wire,
                               void* totals, int tiles, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + TILE - 1) / TILE;
  if (tiles != blocks || (word_bits != 16 && word_bits != 32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* prm = static_cast<const int32_t*>(params);
  auto* w = static_cast<int32_t*>(wire);
  auto* tot = static_cast<int32_t*>(totals);
  dp_wire_count_kernel<<<blocks, TILE, 0, s>>>(prm, n, w, tot);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (word_bits == 16)
    dp_wire_copy_kernel<uint16_t><<<blocks, TILE, 0, s>>>(
        prm, n, static_cast<const uint16_t*>(runs), MR, tot, w);
  else
    dp_wire_copy_kernel<uint32_t><<<blocks, TILE, 0, s>>>(
        prm, n, static_cast<const uint32_t*>(runs), MR, tot, w);
  return (int)cudaGetLastError();
}

extern "C" int soap3dp_dp_wire_tile() { return TILE; }
