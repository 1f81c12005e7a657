// Forward-only banded DP (direction bytes to device memory) and the
// traceback walk that consumes them, for Hopper (sm_90a). The wide-window
// route of `dp_align` (windows of 4096 and more, reads of at most 127):
// the forward kernel, then the traceback kernel.
//
// soap3dp_dp_forward replaces the TPU kernel
// soap3dp_tpu/kernels/banded_dp.py:238 `_dp_forward_pallas_kernel`: the
// same cells, tie-breaks and direction bytes as `_dp_forward_scan`, and
// the best cell (score, hit_i, hit_j, tie count) of each problem.
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
//   Bound by scattered one-byte reads: each move reads one direction
//   byte from a different diagonal, ND x P x (Lr+1) bytes apart from
//   nothing else it needs. Design: one thread per problem walks from
//   (hit_i, hit_j) directly instead of sweeping all ND diagonals, so it
//   reads only the ~Lr cells of its path (the reference's sweep reads
//   ND x P x (Lr+1) bytes whatever the path); the 32 walks of a warp
//   overlap their load latencies. It applies the state machine of the
//   reference's sweep (N / D-chain / I-chain, the fresh-I and soft-clip
//   exits), the boundary exits (the j == 0 insert tail, the i == 0
//   start), and emits the runs right to left with the same bracketing:
//   right clip, ops, insert tail (merged into a trailing insert run),
//   left clip. Counts come out unpacked.
//
// Plain C interface for ctypes; each launcher returns cudaGetLastError().

#include "dp_wavefront.cuh"

namespace {

using namespace soap3dp;

constexpr int TB_THREADS = 128;

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
      int32_t* st = stats + p * 4;
      st[0] = b.bS;
      st[1] = b.bI;
      st[2] = b.bJ;
      st[3] = b.bC;
    }
  }
}

// tbp: (P, 4) int32 rows (rlen, hit_i, hit_j, clip_l); active: (P,)
// uint8. Thread t walks problem lanes[t] (t itself when lanes is null)
// and writes row t of ops / cnts (MR wide, zero-filled by the caller)
// and meta (nrun, startj, overflow, 0).
__global__ void __launch_bounds__(TB_THREADS)
dp_traceback_kernel(const uint8_t* __restrict__ dirs, int P, int Lr1, int ND,
                    const int32_t* __restrict__ tbp,
                    const uint8_t* __restrict__ active,
                    const int32_t* __restrict__ lanes, int n, int MR,
                    int32_t* __restrict__ ops, int32_t* __restrict__ cnts,
                    int32_t* __restrict__ meta) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const long long p = lanes != nullptr ? lanes[t] : t;
  const long long diag_stride = (long long)P * Lr1;
  const uint8_t* dp = dirs + p * Lr1;
  int32_t* o_ops = ops + t * MR;
  int32_t* o_cnt = cnts + t * MR;
  int ridx = 0, of = 0, startj = 0, clipv = 0, ins_tail = 0;
  auto put = [&](int op, int cnt) {
    if (ridx < MR) {
      o_ops[ridx] = op;
      o_cnt[ridx] = cnt;
    } else {
      of = 1;
    }
    ++ridx;
  };
  if (active[p]) {
    const int rlen = tbp[p * 4 + 0], clip_l = tbp[p * 4 + 3];
    int i = tbp[p * 4 + 1], j = tbp[p * 4 + 2];
    const int rclip = rlen - i;
    if (rclip > 0) put(OP_CLIP, rclip);
    int state = 0, done = 0, cur_op = -1, cur_cnt = 0;
    // a cell off the table (i + j > ND or i > Lr) is never on a path
    while (!done && i > 0 && j > 0 && i + j <= ND && i < Lr1) {
      const int byte = dp[(long long)(i + j - 1) * diag_stride + i];
      const int dH = byte & 3, dD = (byte >> 2) & 1, dI = (byte >> 3) & 3;
      const int mop = ((byte >> 5) & 1) ? OP_MATCH : OP_MISMATCH;
      const bool do_diag = state == 0 && dH == DH_DIAG;
      const bool do_sm = state == 0 && dH == DH_SM;
      const bool do_d = state == 1 || (state == 0 && dH == DH_D);
      const bool do_i = state == 2 || (state == 0 && dH == DH_I);
      const bool i_fresh = do_i && dI == DI_FRESH;
      const int op = (do_diag || do_sm) ? mop : (do_d ? OP_DEL : OP_INS);
      const int ni = (do_diag || (do_i && !i_fresh)) ? i - 1 : i;
      const int nj = (do_diag || do_sm || do_d) ? j - 1 : j;
      const int nstate =
          do_d ? (dD == DD_OPEN ? 0 : 1)
               : ((do_i && !i_fresh) ? (dI == DI_OPEN ? 0 : 2) : 0);
      if (do_sm || i_fresh) {
        clipv = i - 1;
        startj = do_sm ? j - 1 : j;
        done = 1;
      }
      if (op == cur_op) {
        ++cur_cnt;
      } else {
        if (cur_cnt > 0) put(cur_op, cur_cnt);
        cur_op = op;
        cur_cnt = 1;
      }
      i = ni;
      j = nj;
      state = nstate;
    }
    if (!done && j == 0 && i > 0) {  // walked off the window start
      const int scl = min(clip_l, i);
      ins_tail = i - scl;
      clipv = scl;
      startj = 0;
    } else if (!done && i == 0) {    // walked off the read start
      startj = j;
    }
    if (cur_cnt > 0 && ins_tail > 0 && cur_op == OP_INS) {
      cur_cnt += ins_tail;
      ins_tail = 0;
    }
    if (cur_cnt > 0) put(cur_op, cur_cnt);
    if (ins_tail > 0) put(OP_INS, ins_tail);
    if (clipv > 0) put(OP_CLIP, clipv);
  }
  int32_t* m = meta + t * 4;
  m[0] = min(ridx, MR);
  m[1] = startj;
  m[2] = of;
  m[3] = 0;
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
                                    const void* tbp, const void* active,
                                    const void* lanes, int n, int MR,
                                    void* ops, void* cnts, void* meta,
                                    void* stream) {
  if (n <= 0) return 0;
  const dim3 grid((n + TB_THREADS - 1) / TB_THREADS), block(TB_THREADS);
  dp_traceback_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(dirs), P, Lr1, ND,
      static_cast<const int32_t*>(tbp), static_cast<const uint8_t*>(active),
      static_cast<const int32_t*>(lanes), n, MR, static_cast<int32_t*>(ops),
      static_cast<int32_t*>(cnts), static_cast<int32_t*>(meta));
  return (int)cudaGetLastError();
}
