// Fused semi-global affine-gap DP + traceback + CIGAR run-length
// encoding, one warp per problem, for Hopper (sm_90a).
//
// Replaces the TPU kernel soap3dp_tpu/kernels/banded_dp.py
// `_dp_align_pallas_kernel` and returns exactly what its caller
// `dp_align` returns, integer for integer: best score, best cell
// (hit_i, hit_j), tie count, window start, and the right-to-left runs.
//
// What bounds it on this card: the per-diagonal dependency chain (every
// anti-diagonal needs the two before it, so a problem advances one
// diagonal per step) and the direction bytes' traffic (one byte per
// cell, Lr+1 cells per diagonal, written once and read back by the
// traceback). Design:
//   * one warp per problem; lane l holds C consecutive cells
//     i = l*C .. l*C+C-1 of the anti-diagonal in registers, so the only
//     cross-lane traffic per diagonal is one __shfl_up_sync per state
//     vector (the i-1 neighbour of the lane's first cell);
//   * the per-diagonal best (max score, then largest i, then the count
//     of ties) is a warp reduction, folded across diagonals in order,
//     as the reference does (an equal score on a smaller j resets the
//     count);
//   * direction bytes go to a global scratch region per warp
//     (ND x 32C bytes), written as 32-bit words by all lanes; the
//     scratch is sized by the warps in flight, which loop over the
//     problems grid-stride, not by the problem count;
//   * lane 0 then walks the traceback from (hit_i, hit_j) directly: it
//     visits the same cells as the reference's reverse diagonal sweep,
//     since every move lowers i + j, and emits the same runs (right
//     clip, ops, insert tail merged into a trailing insert, left clip).
//
// Plain C interface for ctypes; the launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -32000;          // DP_SCORE_NEG_INFINITY
constexpr int NEG_BIG = -(1 << 20);  // masking value
constexpr int DH_DIAG = 0, DH_D = 1, DH_SM = 2, DH_I = 3;
constexpr int DD_OPEN = 0;
constexpr int DI_FRESH = 0, DI_OPEN = 1, DI_EXT = 2;
constexpr int OP_MATCH = 1, OP_MISMATCH = 2, OP_INS = 3, OP_DEL = 4,
              OP_CLIP = 5;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS_PER_BLOCK = 4;

struct Scores {
  int m, mm, go, ge, gi;
};

__device__ __forceinline__ int clampneg(int x) { return max(x, NEG); }

template <int C>
__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK)
dp_align_kernel(const uint8_t* __restrict__ reads,
                const uint8_t* __restrict__ wins,
                const int32_t* __restrict__ params, int P, int Lr, int Lw,
                int MR, Scores sc, int32_t* __restrict__ stats,
                int32_t* __restrict__ ops, int32_t* __restrict__ cnts,
                uint8_t* __restrict__ scratch) {
  static_assert(C % 4 == 0, "cells per lane must pack into 32-bit words");
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long nwarps = ((long long)gridDim.x * blockDim.x) >> 5;
  const int ND = Lr + Lw;
  const int ROW = 32 * C;  // scratch bytes per diagonal
  uint8_t* scr = scratch + warp * (long long)ND * ROW;

  for (long long p = warp; p < P; p += nwarps) {
    const int32_t* prm = params + p * 8;
    const int rlen = prm[0], wlen = prm[1], clip_l = prm[2];
    const int clip_r = prm[3], anchor_l = prm[4], anchor_r = prm[5];
    const int cutoff = prm[6];
    const uint8_t* rd = reads + p * (long long)Lr;
    const uint8_t* wn = wins + p * (long long)Lw;

    // diagonal d-1 (H1, D1, I1), diagonal d-2 (H2), chars on d-1
    int rdc[C], H1[C], H2[C], D1[C], I1[C], ch[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int i = lane * C + c;
      rdc[c] = (i >= 1 && i <= Lr) ? (int)rd[i - 1] : 0;
      H1[c] = (i == 0) ? 0 : NEG_BIG;
      H2[c] = NEG_BIG;
      D1[c] = (i == 0) ? clampneg(sc.gi) : NEG_BIG;
      I1[c] = NEG_BIG;
      ch[c] = -1;
    }
    int bS = NEG, bJ = 0, bI = 0, bC = 0;
    const int rmin = rlen - clip_r;

    for (int d = 1; d <= ND; ++d) {
      // i-1 neighbours of this lane's first cell (old values)
      int pH1 = __shfl_up_sync(FULL, H1[C - 1], 1);
      int pH2 = __shfl_up_sync(FULL, H2[C - 1], 1);
      int pI1 = __shfl_up_sync(FULL, I1[C - 1], 1);
      int pch = __shfl_up_sync(FULL, ch[C - 1], 1);
      if (lane == 0) {
        pH1 = NEG_BIG;
        pH2 = NEG_BIG;
        pI1 = NEG_BIG;
        pch = (int)wn[min(d - 1, Lw - 1)];  // window char entering at i=0
      }
      uint32_t word[C / 4];
#pragma unroll
      for (int q = 0; q < C / 4; ++q) word[q] = 0u;
      int lmax = NEG_BIG - 1, limax = -1, lcnt = 0;
      // descending c: cell c-1 still holds diagonal d-1 values
#pragma unroll
      for (int c = C - 1; c >= 0; --c) {
        const int i = lane * C + c;
        const int j = d - i;
        const int h1s = c > 0 ? H1[c - 1] : pH1;
        const int h2s = c > 0 ? H2[c - 1] : pH2;
        const int i1s = c > 0 ? I1[c - 1] : pI1;
        const int chr = c > 0 ? ch[c - 1] : pch;
        ch[c] = chr;
        const int init_j = (j < anchor_l) ? 0 : NEG;
        const int init_jm1 = (j - 1 < anchor_l) ? 0 : NEG;
        const bool fresh_ok = (i - 1) <= clip_l;
        const bool eq = chr == rdc[c];
        const int dist = eq ? sc.m : sc.mm;
        // D: gap in the read, from (i, j-1)
        const int d_open = sc.go + H1[c];
        const int d_ext = sc.ge + D1[c];
        int Dn = clampneg(max(d_open, d_ext));
        const int dD = d_ext > d_open ? 1 : 0;
        // I: gap in the window, from (i-1, j)
        const int i_fresh = fresh_ok ? init_j + sc.go : NEG_BIG;
        const int i_open = sc.go + h1s;
        const int i_ext = sc.ge + i1s;
        int In = clampneg(max(i_fresh, max(i_open, i_ext)));
        const int dI =
            In == i_fresh ? DI_FRESH : (In == i_open ? DI_OPEN : DI_EXT);
        // H
        const int diag_true = dist + h2s;
        const int diag_fresh = fresh_ok ? init_jm1 + dist : NEG_BIG;
        int Hn = clampneg(max(max(diag_true, diag_fresh), max(Dn, In)));
        const int dH =
            Hn == diag_true
                ? DH_DIAG
                : ((Hn == d_open || Hn == d_ext)
                       ? DH_D
                       : (Hn == diag_fresh ? DH_SM : DH_I));
        if (i == d) {  // column j = 0: clipped-prefix inits
          const int raw =
              i <= clip_l ? sc.go : sc.gi + sc.ge * (i - min(clip_l, i));
          Hn = clampneg(raw);
          Dn = clampneg(raw + sc.gi);
          In = NEG_BIG;
        }
        if (i == 0) {  // row i = 0: free start inside the anchor
          Hn = clampneg(init_j);
          Dn = NEG_BIG;
          In = clampneg(init_j + sc.gi);
        }
        const uint32_t byte = (uint32_t)(dH | (dD << 2) | (dI << 3) |
                                         ((eq ? 1 : 0) << 5));
        word[c >> 2] |= byte << (8 * (c & 3));
        const bool elig = i >= 1 && i <= rlen && j >= 1 && j <= wlen &&
                          i >= rmin && j >= anchor_r;
        const int es = elig ? Hn : NEG_BIG;
        if (es > lmax) {  // first seen at descending c = largest i
          lmax = es;
          limax = i;
          lcnt = 1;
        } else if (es == lmax) {
          ++lcnt;
        }
        H2[c] = H1[c];
        H1[c] = Hn;
        D1[c] = Dn;
        I1[c] = In;
      }
      uint32_t* row =
          reinterpret_cast<uint32_t*>(scr + (long long)(d - 1) * ROW) +
          lane * (C / 4);
#pragma unroll
      for (int q = 0; q < C / 4; ++q) row[q] = word[q];

      // diagonal best: max score, then largest i, then the tie count
      const int s = __reduce_max_sync(FULL, lmax);
      const int istar = __reduce_max_sync(FULL, lmax == s ? limax : -1);
      const int cstar = __reduce_add_sync(FULL, lmax == s ? lcnt : 0);
      const int jstar = d - istar;
      const bool better =
          s > bS || (s == bS && (jstar < bJ || (jstar == bJ && istar < bI)));
      const bool equal = s == bS;
      bC = better ? cstar : (equal ? bC + cstar : bC);
      if (better) {
        bS = s;
        bJ = jstar;
        bI = istar;
      }
    }
    __threadfence_block();
    __syncwarp();

    if (lane == 0) {
      int32_t* o_ops = ops + p * (long long)MR;
      int32_t* o_cnt = cnts + p * (long long)MR;
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
      if (bS >= cutoff) {
        const int rclip = max(rlen - bI, 0);
        if (rclip > 0) put(OP_CLIP, rclip);
        int i = bI, j = bJ, state = 0, done = 0, cur_op = -1, cur_cnt = 0;
        while (!done && i > 0 && j > 0) {
          const int byte = scr[(long long)(i + j - 1) * ROW + i];
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
      int32_t* st = stats + p * 8;
      st[0] = bS;
      st[1] = bI;
      st[2] = bJ;
      st[3] = bC;
      st[4] = startj;
      st[5] = min(ridx, MR);
      st[6] = of;
      st[7] = 0;
    }
    __syncwarp();  // lane 0 is done reading before the scratch is reused
  }
}

}  // namespace

extern "C" int soap3dp_dp_align(const void* reads, const void* wins,
                                const void* params, int P, int Lr, int Lw,
                                int MR, int match, int mismatch, int gap_open,
                                int gap_ext, void* stats, void* ops,
                                void* cnts, void* scratch, int cells_per_lane,
                                int blocks, void* stream) {
  if (P <= 0) return 0;
  const Scores sc{match, mismatch, gap_open, gap_ext, gap_open - gap_ext};
  const dim3 grid(blocks), block(32 * WARPS_PER_BLOCK);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const uint8_t*>(reads);
  const auto* w = static_cast<const uint8_t*>(wins);
  const auto* pr = static_cast<const int32_t*>(params);
  auto* st = static_cast<int32_t*>(stats);
  auto* o = static_cast<int32_t*>(ops);
  auto* c = static_cast<int32_t*>(cnts);
  auto* scr = static_cast<uint8_t*>(scratch);
  switch (cells_per_lane) {
    case 4:
      dp_align_kernel<4><<<grid, block, 0, s>>>(r, w, pr, P, Lr, Lw, MR, sc,
                                                st, o, c, scr);
      break;
    case 8:
      dp_align_kernel<8><<<grid, block, 0, s>>>(r, w, pr, P, Lr, Lw, MR, sc,
                                                st, o, c, scr);
      break;
    case 16:
      dp_align_kernel<16><<<grid, block, 0, s>>>(r, w, pr, P, Lr, Lw, MR, sc,
                                                 st, o, c, scr);
      break;
    case 32:
      dp_align_kernel<32><<<grid, block, 0, s>>>(r, w, pr, P, Lr, Lw, MR, sc,
                                                 st, o, c, scr);
      break;
    case 64:
      dp_align_kernel<64><<<grid, block, 0, s>>>(r, w, pr, P, Lr, Lw, MR, sc,
                                                 st, o, c, scr);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int soap3dp_warps_per_block() { return WARPS_PER_BLOCK; }
