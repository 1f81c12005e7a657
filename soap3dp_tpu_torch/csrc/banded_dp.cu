// Fused semi-global affine-gap DP + traceback + CIGAR run-length
// encoding, one warp per problem, for Hopper (sm_90a).
//
// Replaces the TPU kernel soap3dp_tpu/kernels/banded_dp.py
// `_dp_align_pallas_kernel` and returns exactly what its caller
// `dp_align` returns, integer for integer: best score, best cell
// (hit_i, hit_j), tie count, window start, and the right-to-left runs.
//
// What bounds it on this card: integer operations. The recurrence
// costs 17 add/max/select operations per cell, against one direction
// byte per cell written to a scratch that only the traceback reads
// (internal traffic) and a few bytes of inputs and outputs per problem,
// so the work is compute-bound: at twice the int32 rate in the 16-bit
// form (each 16x2 instruction does two cells' operations), at the int32
// rate in the 32-bit form; each problem is also a chain of Lr+Lw
// dependent diagonals. Design:
//   * the forward is dp_wavefront.cuh: one warp per problem, the
//     anti-diagonal in registers, two cells per register on the 16x2
//     DPX / SIMD instructions where the scores allow it, the best-cell
//     fold as warp reductions only on the diagonals that can change it;
//     a problem without an anchor inside its window takes the forward
//     without the anchor terms (exact on every cell with j <= wlen, the
//     only ones the traceback and the fold read);
//   * at most 64 registers a thread for C = 4 (reads up to 127), so 32
//     warps fit an SM and the wrapper sizes the grid from the resident
//     warps (soap3dp_dp_align_resident_warps): at P = 4096 every
//     problem starts in the first wave;
//   * direction bytes go to a global scratch region per warp
//     (ND x 32C bytes), written as 32-bit words by all lanes; the
//     scratch is sized by the warps in flight, which loop over the
//     problems grid-stride, not by the problem count;
//   * the traceback walks from (hit_i, hit_j) and visits the same cells
//     as the reference's reverse diagonal sweep (every move lowers
//     i + j). Each move lowers i + j by 1 or 2 and i by at most 1, so
//     the next 32 diagonals' cells lie in the 32 bytes at and below the
//     current i: the warp fetches that window in one step (lane k, row
//     d-1-k, nine coalesced words) into shared memory, and lane 0 walks
//     it from there, one scratch round trip per 32 diagonals instead of
//     one per move. It emits the same runs as the reference (right clip,
//     ops, insert tail merged into a trailing insert, left clip), each
//     run one word as the TPU kernel packs it (banded_dp.py:884): 16-bit
//     (op << 12) | min(count, 4095) where no count can pass 4095 (reads
//     and windows below 4096), else 32-bit (op << 28) | count. Its stats
//     row goes straight into the call's result wire (dp_wire.cu), which
//     DW completes; nothing it writes needs zeroing first: a row past
//     its nrun is never read.
//
// Plain C interface for ctypes; the launcher returns cudaGetLastError().

#include "dp_wavefront.cuh"

namespace {

using namespace soap3dp;

constexpr int TB_WORDS = 9;  // 36 bytes: 32 cells and the word alignment

template <int C>
__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK, C <= 4 ? 8 : 1)
dp_align_kernel(const uint8_t* __restrict__ reads,
                const uint8_t* __restrict__ wins,
                const int32_t* __restrict__ params, int P, int Lr, int Lw,
                int MR, int wide_words, Scores sc,
                int32_t* __restrict__ stats, void* __restrict__ runs,
                uint8_t* __restrict__ scratch) {
  __shared__ uint32_t tile[WARPS_PER_BLOCK][32][TB_WORDS];
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long nwarps = ((long long)gridDim.x * blockDim.x) >> 5;
  const int ND = Lr + Lw;
  const int ROW = 32 * C;  // scratch bytes per diagonal
  uint8_t* scr = scratch + warp * (long long)ND * ROW;
  const uint32_t* scr_w = reinterpret_cast<const uint32_t*>(scr);
  uint32_t(&my_tile)[32][TB_WORDS] = tile[threadIdx.x >> 5];
  const uint8_t* tb = reinterpret_cast<const uint8_t*>(&my_tile[0][0]);

  for (long long p = warp; p < P; p += nwarps) {
    const Problem pb = load_problem(params + p * 8);
    auto sink = [&](int d, const uint32_t* word) {
      uint32_t* row =
          reinterpret_cast<uint32_t*>(scr + (long long)(d - 1) * ROW) +
          lane * (C / 4);
#pragma unroll
      for (int q = 0; q < C / 4; ++q) row[q] = word[q];
    };
    const uint8_t* rd = reads + p * (long long)Lr;
    const uint8_t* wn = wins + p * (long long)Lw;
    // the traceback and the fold read only cells with j <= wlen: without
    // an anchor inside the window the anchor-free packed forward is exact
    Best b;
    if constexpr (C <= 8) {
      if (!fits16(Lr, sc))
        b = wavefront<C>(rd, wn, Lr, Lw, pb, sc, lane, sink);
      else if (pb.anchor_l > pb.wlen)
        b = wavefront16<C, false>(rd, wn, Lr, Lw, pb, sc, lane, sink);
      else
        b = wavefront16<C, true>(rd, wn, Lr, Lw, pb, sc, lane, sink);
    } else {
      b = wavefront<C>(rd, wn, Lr, Lw, pb, sc, lane, sink);
    }
    __threadfence_block();
    __syncwarp();

    uint16_t* o16 = static_cast<uint16_t*>(runs) + p * (long long)MR;
    uint32_t* o32 = static_cast<uint32_t*>(runs) + p * (long long)MR;
    int ridx = 0, of = 0;
    auto put = [&](int op, int cnt) {  // lane 0 only
      if (ridx >= MR) {
        of = 1;
      } else if (wide_words) {
        o32[ridx] = ((uint32_t)op << 28) | (uint32_t)cnt;
      } else {
        // the reference's clamp and flag (banded_dp.py:881-890)
        of |= cnt > 4095;
        o16[ridx] = (uint16_t)((op << 12) | min(cnt, 4095));
      }
      ++ridx;
    };
    TbWalk w{b.bI, b.bJ, 0, 0, 0, 0, -1, 0};
    if (b.bS >= pb.cutoff) {  // the same on every lane
      const int rclip = max(pb.rlen - b.bI, 0);
      if (lane == 0 && rclip > 0) put(OP_CLIP, rclip);
      while (!w.done && w.i > 0 && w.j > 0) {  // uniform: lane 0's walk
        // rows dtop-1 .. dtop-32, bytes a0 .. a0+35 of each
        const int dtop = w.i + w.j;
        const int a0 = max(0, w.i - 31) & ~3;
        const int row = dtop - 1 - lane;
        if (row >= 0) {
#pragma unroll
          for (int q = 0; q < TB_WORDS; ++q)
            if (a0 + 4 * q < ROW)
              my_tile[lane][q] = scr_w[((long long)row * ROW + a0) / 4 + q];
        }
        __syncwarp();
        if (lane == 0) {
          while (!w.done && w.i > 0 && w.j > 0 && w.i + w.j > dtop - 32)
            tb_move(tb[((dtop - w.i - w.j) * TB_WORDS) * 4 + (w.i - a0)], w,
                    put);
        }
        __syncwarp();  // lane 0 is done with the tile before its refill
        w.i = __shfl_sync(FULL, w.i, 0);
        w.j = __shfl_sync(FULL, w.j, 0);
        w.done = __shfl_sync(FULL, w.done, 0);
      }
      if (lane == 0) tb_close(w, pb.clip_l, put);
    }
    if (lane == 0) {
      int32_t* st = stats + p * 8;
      st[0] = b.bS;
      st[1] = b.bI;
      st[2] = b.bJ;
      st[3] = b.bC;
      st[4] = w.startj;
      st[5] = min(ridx, MR);
      st[6] = of;
      st[7] = 0;
    }
    __syncwarp();  // every lane is done reading before the scratch is reused
  }
}

template <int C>
int resident_warps() {
  int per_sm = 0, dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, dp_align_kernel<C>, 32 * WARPS_PER_BLOCK, 0);
  return per_sm * sms * WARPS_PER_BLOCK;
}

}  // namespace

// stats: (P, 8) int32 rows (the result wire's); runs: (P, MR) words of
// word_bits (16 or 32) bits
extern "C" int soap3dp_dp_align(const void* reads, const void* wins,
                                const void* params, int P, int Lr, int Lw,
                                int MR, int word_bits, int match,
                                int mismatch, int gap_open, int gap_ext,
                                void* stats, void* runs, void* scratch,
                                int cells_per_lane, int blocks,
                                void* stream) {
  if (word_bits != 16 && word_bits != 32) return (int)cudaErrorInvalidValue;
  if (P <= 0) return 0;
  const Scores sc{match, mismatch, gap_open, gap_ext, gap_open - gap_ext};
  const dim3 grid(blocks), block(32 * WARPS_PER_BLOCK);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const uint8_t*>(reads);
  const auto* w = static_cast<const uint8_t*>(wins);
  const auto* pr = static_cast<const int32_t*>(params);
  auto* st = static_cast<int32_t*>(stats);
  const int ww = word_bits == 32;
  auto* scr = static_cast<uint8_t*>(scratch);
  switch (cells_per_lane) {
    case 4:
      dp_align_kernel<4><<<grid, block, 0, s>>>(r, w, pr, P, Lr, Lw, MR, ww,
                                                sc, st, runs, scr);
      break;
    case 8:
      dp_align_kernel<8><<<grid, block, 0, s>>>(r, w, pr, P, Lr, Lw, MR, ww,
                                                sc, st, runs, scr);
      break;
    case 16:
      dp_align_kernel<16><<<grid, block, 0, s>>>(r, w, pr, P, Lr, Lw, MR, ww,
                                                 sc, st, runs, scr);
      break;
    case 32:
      dp_align_kernel<32><<<grid, block, 0, s>>>(r, w, pr, P, Lr, Lw, MR, ww,
                                                 sc, st, runs, scr);
      break;
    case 64:
      dp_align_kernel<64><<<grid, block, 0, s>>>(r, w, pr, P, Lr, Lw, MR, ww,
                                                 sc, st, runs, scr);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int soap3dp_warps_per_block() { return WARPS_PER_BLOCK; }

// warps of dp_align_kernel<cells_per_lane> resident on the current card
// at once (the grid that runs every problem in one wave), 0 if unknown
extern "C" int soap3dp_dp_align_resident_warps(int cells_per_lane) {
  switch (cells_per_lane) {
    case 4: return resident_warps<4>();
    case 8: return resident_warps<8>();
    case 16: return resident_warps<16>();
    case 32: return resident_warps<32>();
    case 64: return resident_warps<64>();
    default: return 0;
  }
}
