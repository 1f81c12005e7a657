// The anti-diagonal forward DP of one problem by one warp, shared by the
// fused kernel (banded_dp.cu) and the forward-only kernel (dp_forward.cu).
//
// Same recurrences, tie-breaks and direction encoding as the reference's
// `_dp_forward_scan` (soap3dp_tpu/kernels/banded_dp.py:106-219):
//   * lane l holds C consecutive cells i = l*C .. l*C+C-1 of the
//     anti-diagonal in registers; the only cross-lane traffic per
//     diagonal is one __shfl_up_sync per state vector (the i-1 neighbour
//     of the lane's first cell);
//   * the per-diagonal best (max score, then largest i, then the count
//     of ties) is a warp reduction, folded across diagonals in order, as
//     the reference does (an equal score on a smaller j resets the
//     count);
//   * each diagonal's direction bytes (bits 0-1 H, 2 D, 3-4 I, 5 match)
//     are handed to the caller's sink as C/4 32-bit words per lane,
//     cell i = l*C + c in byte c & 3 of word c >> 2.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace soap3dp {

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

// one problem's parameters: the (P, 8) int32 row of the wrappers
struct Problem {
  int rlen, wlen, clip_l, clip_r, anchor_l, anchor_r, cutoff;
};

struct Best {
  int bS, bI, bJ, bC;
};

__device__ __forceinline__ int clampneg(int x) { return max(x, NEG); }

__device__ __forceinline__ Problem load_problem(const int32_t* prm) {
  return Problem{prm[0], prm[1], prm[2], prm[3], prm[4], prm[5], prm[6]};
}

// Runs diagonals d = 1 .. Lr+Lw of one problem (rd: its read, wn: its
// window) on the calling warp; calls sink(d, word) once per diagonal
// with every lane active. Returns the best cell, the same on all lanes.
template <int C, typename Sink>
__device__ __forceinline__ Best wavefront(const uint8_t* __restrict__ rd,
                                          const uint8_t* __restrict__ wn,
                                          int Lr, int Lw, const Problem& pb,
                                          const Scores& sc, int lane,
                                          Sink&& sink) {
  static_assert(C % 4 == 0, "cells per lane must pack into 32-bit words");
  const int ND = Lr + Lw;
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
  const int rmin = pb.rlen - pb.clip_r;

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
      const int init_j = (j < pb.anchor_l) ? 0 : NEG;
      const int init_jm1 = (j - 1 < pb.anchor_l) ? 0 : NEG;
      const bool fresh_ok = (i - 1) <= pb.clip_l;
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
            i <= pb.clip_l ? sc.go : sc.gi + sc.ge * (i - min(pb.clip_l, i));
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
      const bool elig = i >= 1 && i <= pb.rlen && j >= 1 && j <= pb.wlen &&
                        i >= rmin && j >= pb.anchor_r;
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
    sink(d, word);

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
  return Best{bS, bI, bJ, bC};
}

}  // namespace soap3dp
