// Forward-only banded DP (direction bytes to device memory) and the
// traceback walk that consumes them, for Hopper (sm_90a). The wide-window
// route of `dp_align` (windows of 4096 and more, reads of at most 127):
// the forward kernel, then the traceback kernel.
//
// soap3dp_dp_forward replaces the TPU kernel
// soap3dp_tpu/kernels/banded_dp.py:238 `_dp_forward_pallas_kernel`: the
// same cells, tie-breaks and direction bytes as `_dp_forward_scan`, and
// the best cell (score, hit_i, hit_j, tie count) of each problem, the
// first four words of its stats row (P, 8) (the result wire's,
// dp_wire.cu).
//   Bound by integer operations (17 per cell: the 0.87 G cells of
//   100-base reads at the mate-pair window, P = 2048 x 120 x 4224, are
//   ~0.44 ms at twice the int32 rate, the 16-bit form's) ahead of
//   writing ND x P x (Lr+1) direction bytes to device memory (1.08 GB
//   there, ~0.32 ms at 3.35 TB/s). Design: the forward
//   is dp_wavefront.cuh (one warp per problem, the anti-diagonal in
//   registers, DPX max chains, the fold's reductions only where it can
//   change, no scratch), with the anchor kept in the recurrences since
//   every cell is an output; each diagonal's Lr+1 bytes go straight to
//   dirs[d-1, p, :], which is contiguous per (d, p), through a row
//   pointer that advances one diagonal per call, so a warp's stores of
//   one diagonal land in one or two 128-byte lines, written once and
//   never read back by this kernel. dirs is (Lr+Lw, P, Lr+1) uint8,
//   diagonal-major, like the reference's; every cell of it is written,
//   cells outside the table (j < 0) with the same bytes as the plain
//   version's.
//
// soap3dp_dp_traceback replaces the XLA program `_traceback_scan`
// (soap3dp_tpu/kernels/banded_dp.py:409-475) and the host run-length
// encoding `_rle_runs` (:553) that follows it in `dp_traceback` (:490).
//   What bounds it: latency, not bytes. Each move reads one direction
//   byte of another diagonal, P x (Lr+1) bytes from the last (247 KB at
//   the mate-pair shape; the 1.08 GB of dirs is far larger than the 50
//   MB L2), and the next move depends on it; the bytes the paths need
//   (~100 a problem) are nothing to the memory rate. Design: one warp
//   per problem walks from (hit_i, hit_j) directly instead of sweeping
//   all ND diagonals (the reference's sweep reads every byte), from
//   windows in shared memory, as K1 does: each move lowers i + j by 1 or
//   2 and i by at most 1, so the cells of the next 32 diagonals lie at
//   and below the current i; lane k fetches diagonal dtop - k, only the
//   cells i - k .. i it can hold on the path (one to nine aligned words,
//   all in flight: the rows of this layout start at any byte), funnel-
//   shifted so the row's first cell is the tile row's byte 0, and lane 0
//   walks them with the state machine K1 shares (dp_wavefront.cuh
//   tb_move, tb_close), one shared load a move: one device round trip
//   per 32 diagonals instead of one per move. The grid is the warps
//   resident at once, so every problem of the mate-pair shape (2048)
//   starts at once on every SM. What is left is lane 0's serial walk of
//   ~100 moves: windows of 64 diagonals (half the round trips, twice the
//   loads a lane) measured slower. It emits the runs right to left with
//   the reference's bracketing (right clip, ops, insert tail merged into
//   a trailing insert run, left clip), one 32-bit word a run, (op << 28)
//   | count: a count can pass 4095 here (windows of 4096 and more). A
//   problem is traced where its score (K2's stats row) reaches its
//   cutoff (its params row), decided here, so the wide route's chunks
//   queue one after another with no host round trip; the run budget the
//   caller gives is a hard bound on any alignment's runs (banded_dp.py
//   run_budget), so no problem is traced twice. Its startj, nrun and
//   overflow flag go to words 4-6 of the problem's stats row, which DW
//   completes into the call's result wire; nothing is zeroed: a row past
//   its nrun is never read.
//
// Plain C interface for ctypes; each launcher returns cudaGetLastError().

#include <algorithm>
#include <atomic>

#include "dp_wavefront.cuh"

namespace {

using namespace soap3dp;

constexpr int TB_WARPS = 4;   // warps a block of the traceback
constexpr int TB_STRIDE = 9;  // words a tile row: 32 cells, odd for the banks

template <int C>
__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK)
dp_forward_kernel(const uint8_t* __restrict__ reads,
                  const uint8_t* __restrict__ wins,
                  const int32_t* __restrict__ params, int P, int Lr, int Lw,
                  Scores sc, int32_t* __restrict__ stats,
                  uint8_t* __restrict__ dirs) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long nwarps = ((long long)gridDim.x * blockDim.x) >> 5;
  const long long Lr1 = Lr + 1;
  const long long diag_stride = (long long)P * Lr1;

  for (long long p = warp; p < P; p += nwarps) {
    const Problem pb = load_problem(params + p * 8);
    // this lane's cells of diagonal d-1, advanced one diagonal per call
    uint8_t* row = dirs + p * Lr1 + lane * C;
    const int ncell = min(C, max(0, Lr + 1 - lane * C));
    auto sink = [&](int, const uint32_t* word) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (c < ncell) row[c] = (uint8_t)(word[c >> 2] >> (8 * (c & 3)));
      row += diag_stride;
    };
    const uint8_t* rd = reads + p * (long long)Lr;
    const uint8_t* wn = wins + p * (long long)Lw;
    Best b;
    if constexpr (C <= 8) {
      b = fits16(Lr, sc)
              ? wavefront16<C, true>(rd, wn, Lr, Lw, pb, sc, lane, sink)
              : wavefront<C>(rd, wn, Lr, Lw, pb, sc, lane, sink);
    } else {
      b = wavefront<C>(rd, wn, Lr, Lw, pb, sc, lane, sink);
    }
    if (lane == 0) {
      int32_t* st = stats + p * 8;
      st[0] = b.bS;
      st[1] = b.bI;
      st[2] = b.bJ;
      st[3] = b.bC;
    }
  }
}

// params: (P, 8) int32 problem rows (rlen, wlen, clip_l, clip_r,
// anchor_l, anchor_r, cutoff, 0); stats: (P, 8) int32 rows, words 0-2
// (score, hit_i, hit_j) read, 4-7 (startj, nrun, overflow, 0) written.
// Warp p walks problem p, grid-stride, and writes row p of runs (MR
// words).
__global__ void __launch_bounds__(32 * TB_WARPS)
dp_traceback_kernel(const uint8_t* __restrict__ dirs, int P, int Lr1, int ND,
                    const int32_t* __restrict__ params,
                    int32_t* __restrict__ stats, int MR,
                    uint32_t* __restrict__ runs) {
  // the warp's window: tile row k holds diagonal dtop - 1 - k from its
  // cell max(0, itop - k) on, in byte 0 of word 0 (dtop, itop: the walk's
  // i + j and i where the window opened)
  __shared__ uint32_t tile[TB_WARPS][32][TB_STRIDE];
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long nwarps = ((long long)gridDim.x * blockDim.x) >> 5;
  const long long diag_stride = (long long)P * Lr1;
  const uint8_t* tb = reinterpret_cast<const uint8_t*>(&tile[wib][0][0]);

  for (long long p = warp; p < P; p += nwarps) {
    const int32_t* prm = params + p * 8;
    int32_t* st = stats + p * 8;
    uint32_t* out = runs + p * MR;
    int ridx = 0, of = 0;
    auto put = [&](int op, int cnt) {  // lane 0 only
      if (ridx < MR)
        out[ridx] = ((uint32_t)op << 28) | (uint32_t)cnt;
      else
        of = 1;
      ++ridx;
    };
    TbWalk w{st[1], st[2], 0, 0, 0, 0, -1, 0};
    if (st[0] >= prm[6]) {  // the same on every lane
      const int rclip = prm[0] - w.i;
      if (lane == 0 && rclip > 0) put(OP_CLIP, rclip);
      // a cell off the table (i + j > ND or i > Lr) is never on a path;
      // i + j and i only fall, so the window loop checks it
      while (!w.done && w.i > 0 && w.j > 0 && w.i + w.j <= ND &&
             w.i < Lr1) {
        // after k diagonals the walk's i is in [itop - k, itop]: lane k
        // fetches diagonal dtop - k, bytes lo .. itop of its row
        const int dtop = w.i + w.j, itop = w.i;
        const int row = dtop - 1 - lane;
        if (row >= 0) {
          const int lo = max(0, itop - lane);
          const uintptr_t a = reinterpret_cast<uintptr_t>(
              dirs + row * diag_stride + p * Lr1 + lo);
          // the aligned words from the one holding cell lo to the one
          // holding cell itop (the last begins inside the row), all loads
          // in flight, then funnel-shifted to start at cell lo
          const uint32_t* src =
              reinterpret_cast<const uint32_t*>(a & ~(uintptr_t)3);
          const int nw = (int)(((a + (itop - lo)) >> 2) - (a >> 2)) + 1;
          const uint32_t sh = 8 * static_cast<uint32_t>(a & 3);
          uint32_t x[TB_STRIDE];
#pragma unroll
          for (int q = 0; q < TB_STRIDE; ++q)
            x[q] = q < nw ? __ldg(src + q) : 0u;
#pragma unroll
          for (int q = 0; q + 1 < TB_STRIDE; ++q)
            if (4 * q <= itop - lo)
              tile[wib][lane][q] = __funnelshift_r(x[q], x[q + 1], sh);
        }
        __syncwarp();
        if (lane == 0) {
          while (!w.done && w.i > 0 && w.j > 0 && w.i + w.j > dtop - 32) {
            const int k = dtop - w.i - w.j;
            tb_move(tb[k * 4 * TB_STRIDE + w.i - max(0, itop - k)], w, put);
          }
        }
        __syncwarp();  // lane 0 is done with the tile before its refill
        w.i = __shfl_sync(FULL, w.i, 0);
        w.j = __shfl_sync(FULL, w.j, 0);
        w.done = __shfl_sync(FULL, w.done, 0);
      }
      if (lane == 0) tb_close(w, prm[2], put);
    }
    if (lane == 0) {
      st[4] = w.startj;
      st[5] = min(ridx, MR);
      st[6] = of;
      st[7] = 0;
    }
  }
}

// blocks of the traceback's grid: the blocks resident on the current card
// at once (the occupancy API, asked once per card), at most one warp a
// problem
int traceback_blocks(int P) {
  static std::atomic<int> resident[64];  // per card; 0: not asked yet
  int dev = 0;
  cudaGetDevice(&dev);
  std::atomic<int>& blocks = resident[dev % 64];
  if (blocks.load() == 0) {
    int per_sm = 0, sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dp_traceback_kernel, 32 * TB_WARPS, 0);
    blocks.store(std::max(1, per_sm * sms));
  }
  return std::min(blocks.load(), (P + TB_WARPS - 1) / TB_WARPS);
}

}  // namespace

extern "C" int soap3dp_dp_forward(const void* reads, const void* wins,
                                  const void* params, int P, int Lr, int Lw,
                                  int match, int mismatch, int gap_open,
                                  int gap_ext, void* stats, void* dirs,
                                  int cells_per_lane, int blocks,
                                  void* stream) {
  if (P <= 0) return 0;
  const Scores sc{match, mismatch, gap_open, gap_ext, gap_open - gap_ext};
  const dim3 grid(blocks), block(32 * WARPS_PER_BLOCK);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const uint8_t*>(reads);
  const auto* w = static_cast<const uint8_t*>(wins);
  const auto* pr = static_cast<const int32_t*>(params);
  auto* st = static_cast<int32_t*>(stats);
  auto* dr = static_cast<uint8_t*>(dirs);
  switch (cells_per_lane) {
    case 4:
      dp_forward_kernel<4><<<grid, block, 0, s>>>(r, w, pr, P, Lr, Lw, sc,
                                                  st, dr);
      break;
    case 8:
      dp_forward_kernel<8><<<grid, block, 0, s>>>(r, w, pr, P, Lr, Lw, sc,
                                                  st, dr);
      break;
    case 16:
      dp_forward_kernel<16><<<grid, block, 0, s>>>(r, w, pr, P, Lr, Lw, sc,
                                                   st, dr);
      break;
    case 32:
      dp_forward_kernel<32><<<grid, block, 0, s>>>(r, w, pr, P, Lr, Lw, sc,
                                                   st, dr);
      break;
    case 64:
      dp_forward_kernel<64><<<grid, block, 0, s>>>(r, w, pr, P, Lr, Lw, sc,
                                                   st, dr);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int soap3dp_dp_traceback(const void* dirs, int P, int Lr1, int ND,
                                    const void* params, void* stats, int MR,
                                    void* runs, void* stream) {
  if (P <= 0) return 0;
  dp_traceback_kernel<<<traceback_blocks(P), 32 * TB_WARPS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(dirs), P, Lr1, ND,
      static_cast<const int32_t*>(params), static_cast<int32_t*>(stats), MR,
      static_cast<uint32_t*>(runs));
  return (int)cudaGetLastError();
}
