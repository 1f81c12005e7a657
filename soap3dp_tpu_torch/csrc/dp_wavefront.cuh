// The anti-diagonal forward DP of one problem by one warp, shared by the
// fused kernel (banded_dp.cu) and the forward-only kernel (dp_forward.cu),
// in two forms: wavefront16, two cells per 32-bit register on Hopper's
// 16x2 integer instructions, for reads of at most 255 bases and scores
// of magnitude at most 15 (the main path's; see its note for why 16 bits
// are exact), and wavefront, one cell per register, for everything else.
// On an H100 the forward issues integer instructions at the int32 rate
// (16 lanes per SM partition per clock), so its time is its instruction
// count: the 16x2 form and the fold's per-phase bounds cut it by ~2x.
// A 16x2 instruction does two cells' operations, so the 16-bit form's
// operations bound is at twice the int32 rate.
//
// Same recurrences, tie-breaks and direction encoding as the reference's
// `_dp_forward_scan` (soap3dp_tpu/kernels/banded_dp.py:106-219), every
// cell of every diagonal computed exactly (the forward-only kernel
// writes them all):
//   * lane l holds C consecutive cells i = l*C .. l*C+C-1 of the
//     anti-diagonal in registers; the cross-lane traffic per diagonal is
//     three __shfl_up_sync (H and I of diagonal d-1, the window chars) of
//     the i-1 neighbour of the lane's first cell; its H of diagonal d-2
//     is the H shuffled in on the diagonal before;
//   * the two previous diagonals' H alternate between two register
//     arrays (the d loop steps twice per iteration), so no value moves;
//   * window and read chars are packed four to a word: one byte permute
//     shifts the window chars along the diagonal and one __vcmpeq4 gives
//     the match bytes of four cells;
//   * the max chains are Hopper's three-input DPX max (__vimax3_s32);
//   * the column-0 initialisation runs only on the first Lr diagonals
//     (a separate instantiation of the step), the row-0 one on lane 0
//     after the cells;
//   * the per-diagonal best (max score, then largest i, then the count
//     of ties) is folded across diagonals in order as the reference does
//     (an equal score on a smaller j resets the count). Each lane keeps
//     only the max of its eligible cells; one __any_sync(lmax >= bS)
//     vote decides whether the diagonal can change the fold (it cannot
//     when every eligible score is below bS), and only then do the
//     three warp reductions run;
//   * each diagonal's direction bytes (bits 0-1 H, 2 D, 3-4 I, 5 match)
//     are handed to the caller's sink as C/4 32-bit words per lane,
//     cell i = l*C + c in byte c & 3 of word c >> 2.
// Also the traceback's state machine, one move at a time (tb_move) and
// the runs that close a walk (tb_close), which K1 and TB share.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
  constexpr int W = C / 4;
  const int ND = Lr + Lw;
  const int i0 = lane * C;
  // HA / HB: H of diagonals d-1 and d-2 (roles swap every diagonal);
  // D1, I1: diagonal d-1; rdw / chw: read and window chars, packed
  int HA[C], HB[C], D1[C], I1[C];
  uint32_t rdw[W], chw[W];
#pragma unroll
  for (int q = 0; q < W; ++q) {
    uint32_t w = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = i0 + 4 * q + b;
      if (i >= 1 && i <= Lr) w |= (uint32_t)rd[i - 1] << (8 * b);
    }
    rdw[q] = w;
    chw[q] = 0xffffffffu;  // no char yet: -1 matches no read code
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    HA[c] = (i0 + c == 0) ? 0 : NEG_BIG;
    HB[c] = NEG_BIG;
    D1[c] = (i0 + c == 0) ? clampneg(sc.gi) : NEG_BIG;
    I1[c] = NEG_BIG;
  }
  int bS = NEG, bJ = 0, bI = 0, bC = 0;
  // eligible rows [rlo, rlen], eligible columns [jlo, wlen]
  const int rlo = max(1, pb.rlen - pb.clip_r);
  const int jlo = max(1, pb.anchor_r);
  int pH2 = NEG_BIG;  // H of diagonal d-2 at cell i0-1

  // one diagonal: H1 holds diagonal d-1, H2 diagonal d-2 and receives d
  auto step = [&](auto col0, int d, int(&H1)[C], int(&H2)[C]) {
    int pH1 = __shfl_up_sync(FULL, H1[C - 1], 1);
    int pI1 = __shfl_up_sync(FULL, I1[C - 1], 1);
    uint32_t pch = __shfl_up_sync(FULL, chw[W - 1], 1);
    if (lane == 0) {
      pH1 = NEG_BIG;
      pI1 = NEG_BIG;
      // the window char entering at i = 0 (a 32-bit clamped offset)
      pch = (uint32_t)wn[(unsigned)min(d - 1, Lw - 1)] << 24;
    }
    // shift the window chars one cell along the diagonal
#pragma unroll
    for (int q = W - 1; q > 0; --q) chw[q] = __byte_perm(chw[q - 1], chw[q], 0x6543);
    chw[0] = __byte_perm(pch, chw[0], 0x6543);
    uint32_t eqm[W], word[W];
#pragma unroll
    for (int q = 0; q < W; ++q) {
      eqm[q] = __vcmpeq4(chw[q], rdw[q]);
      word[q] = eqm[q] & 0x20202020u;  // the match bits
    }
    const int lo = max(rlo, d - pb.wlen), hi = min(pb.rlen, d - jlo);
    int lmax = NEG_BIG;
    // descending c: cell c-1 still holds diagonal d-1 (and d-2) values
#pragma unroll
    for (int c = C - 1; c >= 0; --c) {
      const int i = i0 + c;
      const int j = d - i;
      const int h1s = c > 0 ? H1[c - 1] : pH1;
      const int h2s = c > 0 ? H2[c - 1] : pH2;
      const int i1s = c > 0 ? I1[c - 1] : pI1;
      const bool eq = (eqm[c >> 2] >> (8 * (c & 3))) & 1u;
      const int dist = eq ? sc.m : sc.mm;
      const bool fresh_ok = i - 1 <= pb.clip_l;
      const int init_j = (j < pb.anchor_l) ? 0 : NEG;
      const int init_jm1 = (j - 1 < pb.anchor_l) ? 0 : NEG;
      // D: gap in the read, from (i, j-1)
      const int d_open = sc.go + H1[c];
      const int d_ext = sc.ge + D1[c];
      const int d_max = max(d_open, d_ext);
      int Dn = max(d_max, NEG);
      const int dD = d_ext > d_open ? 1 : 0;
      // I: gap in the window, from (i-1, j)
      const int i_fresh = fresh_ok ? init_j + sc.go : NEG_BIG;
      const int i_open = sc.go + h1s;
      const int i_ext = sc.ge + i1s;
      int In = __vimax3_s32(i_fresh, i_open, max(i_ext, NEG));
      const int dI =
          In == i_fresh ? DI_FRESH : (In == i_open ? DI_OPEN : DI_EXT);
      // H
      const int diag_true = dist + h2s;
      const int diag_fresh = fresh_ok ? init_jm1 + dist : NEG_BIG;
      int Hn = __vimax3_s32(__vimax3_s32(diag_true, diag_fresh, Dn), In, NEG);
      // Hn equals d_open or d_ext exactly when it equals their max
      const int dH =
          Hn == diag_true
              ? DH_DIAG
              : (Hn == d_max ? DH_D : (Hn == diag_fresh ? DH_SM : DH_I));
      if constexpr (decltype(col0)::value) {
        if (i == d) {  // column j = 0: clipped-prefix inits
          const int raw =
              i <= pb.clip_l ? sc.go : sc.gi + sc.ge * (i - min(pb.clip_l, i));
          Hn = clampneg(raw);
          Dn = clampneg(raw + sc.gi);
          In = NEG_BIG;
        }
      }
      word[c >> 2] |= (uint32_t)(dH | (dD << 2) | (dI << 3)) << (8 * (c & 3));
      if (i >= lo && i <= hi) lmax = max(lmax, Hn);
      H2[c] = Hn;
      D1[c] = Dn;
      I1[c] = In;
    }
    if (lane == 0) {  // row i = 0: free start inside the anchor
      const int init0 = d < pb.anchor_l ? 0 : NEG;
      H2[0] = clampneg(init0);
      D1[0] = NEG_BIG;
      I1[0] = clampneg(init0 + sc.gi);
    }
    pH2 = pH1;
    sink(d, word);

    // diagonal best: max score, then largest i, then the tie count; the
    // fold changes only if some eligible score reaches bS
    if (__any_sync(FULL, lmax >= bS)) {
      const int s = __reduce_max_sync(FULL, lmax);
      int li = -1, lc = 0;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int i = i0 + c;
        if (i >= lo && i <= hi && H2[c] == s) {
          li = i;
          ++lc;
        }
      }
      const int istar = __reduce_max_sync(FULL, li);
      const int cstar = __reduce_add_sync(FULL, lc);
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
  };

  using Col0 = std::true_type;
  using NoCol0 = std::false_type;
  // diagonals 1 .. Lr hold the column-0 cell i == d; the loop invariant
  // at the top of each pair of steps: HA = diagonal d-1, HB = d-2
  const int d_col0 = min(Lr, ND);
  int d = 1;
  for (; d + 1 <= d_col0; d += 2) {
    step(Col0{}, d, HA, HB);
    step(Col0{}, d + 1, HB, HA);
  }
  if (d <= d_col0) {
    step(Col0{}, d, HA, HB);
    ++d;
#pragma unroll
    for (int c = 0; c < C; ++c) {  // restore the invariant
      const int t = HA[c];
      HA[c] = HB[c];
      HB[c] = t;
    }
  }
  for (; d + 1 <= ND; d += 2) {
    step(NoCol0{}, d, HA, HB);
    step(NoCol0{}, d + 1, HB, HA);
  }
  if (d <= ND) step(NoCol0{}, d, HA, HB);
  return Best{bS, bI, bJ, bC};
}

// ------------------------------------------------------------------
// The same forward with two cells in each 32-bit register (cell 2k in
// the low 16 bits, 2k+1 in the high), on Hopper's 16x2 integer
// instructions (VIADD.16x2, VIMNMX.S16x2, VIMNMX3.S16x2): half the
// instructions per cell for the recurrences and the direction codes.
//
// Why 16 bits are exact. Every stored H, D, I value is either a clamped
// result (>= NEG = -32000, at most rlen * match) or the masking value,
// and every candidate is a stored value plus one score constant. With
// |scores| <= SCORE16_MAX and reads of at most 255 bases the clamped
// values lie in [-32000, 3825] and need no change; the masking value
// NEG_BIG becomes B16 = -32400, so a candidate made from it lies in
// [-32415, -32385]: below NEG - 15 like every candidate made from
// NEG_BIG in 32 bits, and without wrapping. Every comparison the
// recurrences make (the max chains with their clamp, d_ext > d_open,
// and the equalities against a clamped result that pick the direction
// codes) therefore has the 32-bit outcome, so every direction byte and
// every best cell is the 32-bit forward's. The fold's bounds lo/hi and
// the anchor offset are clamped to +-30000, which keeps their
// comparisons with i <= 255.
constexpr int SCORE16_MAX = 15;
constexpr int B16 = -32400;
constexpr uint32_t B16x2 = ((uint32_t)B16 & 0xffffu) * 0x10001u;
constexpr uint32_t NEGx2 = ((uint32_t)NEG & 0xffffu) * 0x10001u;

__device__ __forceinline__ bool fits16(int Lr, const Scores& sc) {
  return Lr <= 255 && abs(sc.m) <= SCORE16_MAX && abs(sc.mm) <= SCORE16_MAX &&
         abs(sc.go) <= SCORE16_MAX && abs(sc.ge) <= SCORE16_MAX &&
         abs(sc.gi) <= SCORE16_MAX;
}

__device__ __forceinline__ uint32_t rep2(int v) {  // v in both halves
  return ((uint32_t)v & 0xffffu) * 0x10001u;
}
__device__ __forceinline__ int lo16(uint32_t x) { return (int)(short)(x & 0xffffu); }
__device__ __forceinline__ int hi16(uint32_t x) { return (int)x >> 16; }
__device__ __forceinline__ int clamp16(int v) { return min(max(v, -30000), 30000); }
// 1 in each half where a and b differ, else 0
__device__ __forceinline__ uint32_t ne2(uint32_t a, uint32_t b) {
  return __vminu2(a ^ b, 0x00010001u);
}
// 0xffff in each half that is negative: PTX prmt with the selector's
// sign-replicate bit (bytes 1 and 3 replicated from their sign), which
// __byte_perm drops
__device__ __forceinline__ uint32_t negm2(uint32_t x) {
  uint32_t r;
  asm("prmt.b32 %0, %1, 0, 0xbb99;" : "=r"(r) : "r"(x));
  return r;
}
__device__ __forceinline__ uint32_t sel2(uint32_t m, uint32_t a, uint32_t b) {
  return (a & m) | (b & ~m);
}

// ANCHORED = false drops the left anchor from the recurrences (every
// fresh start scores 0): exact on every cell with j < anchor_l, so a
// caller that reads only the cells of the problem's window takes it
// when anchor_l > wlen; true computes every cell as the reference does.
template <int C, bool ANCHORED, typename Sink>
__device__ __forceinline__ Best wavefront16(const uint8_t* __restrict__ rd,
                                            const uint8_t* __restrict__ wn,
                                            int Lr, int Lw, const Problem& pb,
                                            const Scores& sc, int lane,
                                            Sink&& sink) {
  static_assert(C % 4 == 0, "cells per lane must pack into 32-bit words");
  constexpr int W = C / 4, P = C / 2;
  const int ND = Lr + Lw;
  const int i0 = lane * C;
  const uint32_t m2 = rep2(sc.m), mm2 = rep2(sc.mm), go2 = rep2(sc.go),
                 ge2 = rep2(sc.ge);
  // HA / HB: H of diagonals d-1 and d-2 (roles swap every diagonal);
  // D1, I1: diagonal d-1; fm: fresh-start mask (i - 1 <= clip_l)
  uint32_t HA[P], HB[P], D1[P], I1[P], fm[P];
  uint32_t rdw[W], chw[W];
#pragma unroll
  for (int q = 0; q < W; ++q) {
    uint32_t w = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = i0 + 4 * q + b;
      if (i >= 1 && i <= Lr) w |= (uint32_t)rd[i - 1] << (8 * b);
    }
    rdw[q] = w;
    chw[q] = 0xffffffffu;
  }
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = i0 + 2 * k;
    HA[k] = i == 0 ? (B16x2 & 0xffff0000u) : B16x2;
    HB[k] = B16x2;
    D1[k] = i == 0 ? (B16x2 & 0xffff0000u) | (rep2(clampneg(sc.gi)) & 0xffffu)
                   : B16x2;
    I1[k] = B16x2;
    fm[k] = (i - 1 <= pb.clip_l ? 0xffffu : 0u) |
            (i <= pb.clip_l ? 0xffff0000u : 0u);
  }
  // packed cell indices of pair 0 and their negatives
  const uint32_t i2base = (uint32_t)i0 | ((uint32_t)(i0 + 1) << 16);
  const uint32_t ni2base = ((uint32_t)(-i0) & 0xffffu) |
                           ((uint32_t)(-(i0 + 1)) << 16);  // -i per half
  int bS = NEG, bJ = 0, bI = 0, bC = 0;
  const int rlo = max(1, pb.rlen - pb.clip_r);
  const int jlo = max(1, pb.anchor_r);
  uint32_t pH2 = B16x2;
  // between diagonals rlen + jlo and wlen + rlo the eligible cells are
  // the rows rlo .. rlen whatever d: their masks are set once
  uint32_t mid_out[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = i0 + 2 * k;
    mid_out[k] = (i >= rlo && i <= pb.rlen ? 0u : 0xffffu) |
                 (i + 1 >= rlo && i + 1 <= pb.rlen ? 0u : 0xffff0000u);
  }

  using Pairs = uint32_t[P];
  auto step = [&](auto col0, auto edge, int d, Pairs& H1, Pairs& H2) {
    uint32_t pH1 = __shfl_up_sync(FULL, H1[P - 1], 1);
    uint32_t pI1 = __shfl_up_sync(FULL, I1[P - 1], 1);
    uint32_t pch = __shfl_up_sync(FULL, chw[W - 1], 1);
    if (lane == 0) {
      pH1 = B16x2;
      pI1 = B16x2;
      pch = (uint32_t)wn[(unsigned)min(d - 1, Lw - 1)] << 24;
    }
#pragma unroll
    for (int q = W - 1; q > 0; --q) chw[q] = __byte_perm(chw[q - 1], chw[q], 0x6543);
    chw[0] = __byte_perm(pch, chw[0], 0x6543);
    uint32_t eqm[W], word[W], code[P];
#pragma unroll
    for (int q = 0; q < W; ++q) eqm[q] = __vcmpeq4(chw[q], rdw[q]);
    constexpr bool EDGE = decltype(edge)::value;
    const int lo = EDGE ? clamp16(max(rlo, d - pb.wlen)) : rlo;
    const int hi = EDGE ? clamp16(min(pb.rlen, d - jlo)) : pb.rlen;
    const uint32_t nlo2 = rep2(-lo), hi2 = rep2(hi);
    const uint32_t a2 = rep2(clamp16(pb.anchor_l - d));  // anchor_l - j - i
    uint32_t lmax2 = B16x2;
#pragma unroll
    for (int k = P - 1; k >= 0; --k) {
      const uint32_t h1s = __byte_perm(k > 0 ? H1[k - 1] : pH1, H1[k], 0x5432);
      const uint32_t h2s = __byte_perm(k > 0 ? H2[k - 1] : pH2, H2[k], 0x5432);
      const uint32_t i1s = __byte_perm(k > 0 ? I1[k - 1] : pI1, I1[k], 0x5432);
      const uint32_t M = __byte_perm(eqm[k >> 1], 0, (k & 1) ? 0x3322 : 0x1100);
      const uint32_t dist = sel2(M, m2, mm2);
      const uint32_t i2 = i2base + 0x00020002u * k;
      // fresh starts: init_j = 0 where j < anchor_l, NEG elsewhere
      uint32_t i_fresh, diag_fresh;
      if (ANCHORED) {
        const uint32_t x = __vadd2(a2, i2);                 // anchor_l - j
        const uint32_t out_j = negm2(__vadd2(x, 0xffffffffu));  // j >= anchor_l
        const uint32_t out_jm1 = negm2(x);                 // j - 1 >= anchor_l
        i_fresh = sel2(fm[k] & ~out_j, go2, B16x2);
        diag_fresh = sel2(fm[k], sel2(out_jm1, __vadd2(dist, NEGx2), dist),
                          B16x2);
      } else {
        i_fresh = sel2(fm[k], go2, B16x2);
        diag_fresh = sel2(fm[k], dist, B16x2);
      }
      // D: gap in the read, from (i, j-1)
      const uint32_t d_open = __vadd2(H1[k], go2);
      const uint32_t d_ext = __vadd2(D1[k], ge2);
      const uint32_t d_max = __vmaxs2(d_open, d_ext);
      uint32_t Dn = __vmaxs2(d_max, NEGx2);
      const uint32_t dD = ne2(d_max, d_open);  // d_ext > d_open
      // I: gap in the window, from (i-1, j)
      const uint32_t i_open = __vadd2(h1s, go2);
      const uint32_t i_ext = __vadd2(i1s, ge2);
      uint32_t In = __vimax3_s16x2(i_fresh, i_open, __vmaxs2(i_ext, NEGx2));
      const uint32_t nf = ne2(In, i_fresh);
      const uint32_t dI = nf + (nf & ne2(In, i_open));
      // H
      const uint32_t diag_true = __vadd2(dist, h2s);
      uint32_t Hn = __vimax3_s16x2(__vimax3_s16x2(diag_true, diag_fresh, Dn),
                                   In, NEGx2);
      const uint32_t na = ne2(Hn, diag_true);
      const uint32_t nad = na & ne2(Hn, d_max);
      const uint32_t dH = na + nad + (nad & ne2(Hn, diag_fresh));
      code[k] = dH + (dD << 2) + (dI << 3);
      if constexpr (decltype(col0)::value) {
        const int c = d - i0;
        if (c >= 2 * k && c < 2 * k + 2) {  // column j = 0 at i = d
          const int i = d;
          const int raw =
              i <= pb.clip_l ? sc.go : sc.gi + sc.ge * (i - min(pb.clip_l, i));
          const uint32_t hm = (c & 1) ? 0xffff0000u : 0x0000ffffu;
          Hn = sel2(hm, rep2(clampneg(raw)), Hn);
          Dn = sel2(hm, rep2(clampneg(raw + sc.gi)), Dn);
          In = sel2(hm, B16x2, In);
        }
      }
      // eligible cells: lo <= i <= hi
      const uint32_t out =
          EDGE ? negm2(__vadd2(i2, nlo2) |
                       __vadd2(hi2, __vadd2(ni2base, rep2(-2 * k))))
               : mid_out[k];
      lmax2 = __vmaxs2(lmax2, sel2(out, B16x2, Hn));
      H2[k] = Hn;
      D1[k] = Dn;
      I1[k] = In;
    }
    if (lane == 0) {  // row i = 0: free start inside the anchor
      const int init0 = (!ANCHORED || d < pb.anchor_l) ? 0 : NEG;
      H2[0] = (H2[0] & 0xffff0000u) | (rep2(clampneg(init0)) & 0xffffu);
      D1[0] = (D1[0] & 0xffff0000u) | (B16x2 & 0xffffu);
      I1[0] = (I1[0] & 0xffff0000u) | (rep2(clampneg(init0 + sc.gi)) & 0xffffu);
    }
    pH2 = pH1;
#pragma unroll
    for (int q = 0; q < W; ++q)
      word[q] = __byte_perm(code[2 * q], code[2 * q + 1], 0x6420) |
                (eqm[q] & 0x20202020u);
    sink(d, word);

    const int lmax = max(lo16(lmax2), hi16(lmax2));
    if (__any_sync(FULL, lmax >= bS)) {
      const int s = __reduce_max_sync(FULL, lmax);
      int li = -1, lc = 0;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int i = i0 + c;
        const int h = (c & 1) ? hi16(H2[c >> 1]) : lo16(H2[c >> 1]);
        if (i >= lo && i <= hi && h == s) {
          li = i;
          ++lc;
        }
      }
      const int istar = __reduce_max_sync(FULL, li);
      const int cstar = __reduce_add_sync(FULL, lc);
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
  };

  // diagonals d .. d_end in steps of two (HA = diagonal d-1, HB = d-2 at
  // the top of each pair of steps; an odd last step swaps them back)
  int d = 1;
  auto run = [&](auto col0, auto edge, int d_end) {
    for (; d + 1 <= d_end; d += 2) {
      step(col0, edge, d, HA, HB);
      step(col0, edge, d + 1, HB, HA);
    }
    if (d <= d_end) {
      step(col0, edge, d, HA, HB);
      ++d;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const uint32_t t = HA[k];
        HA[k] = HB[k];
        HB[k] = t;
      }
    }
  };
  using T = std::true_type;
  using F = std::false_type;
  const int d_col0 = min(Lr, ND);  // the diagonals with a column-0 cell
  const int mid_end = min(ND, pb.wlen + rlo);
  run(T{}, T{}, d_col0);
  run(F{}, T{}, min(mid_end, pb.rlen + jlo - 1));
  run(F{}, F{}, mid_end);
  run(F{}, T{}, ND);
  return Best{bS, bI, bJ, bC};
}

// The traceback's walk (K1's and TB's): the cell (i, j), the gap chain
// it is in (state 0 none, 1 deletion, 2 insertion), whether it stopped
// itself (a soft-clip or fresh-insert exit) with the left clip and start
// it found, and the run being counted.
struct TbWalk {
  int i, j, state, done, clipv, startj, cur_op, cur_cnt;
};

// One move of the reference's traceback sweep (`_traceback_scan`,
// soap3dp_tpu/kernels/banded_dp.py:409) from cell (w.i, w.j), whose
// direction byte is `byte`; a finished run goes to put(op, count).
template <typename Put>
__device__ __forceinline__ void tb_move(int byte, TbWalk& w, Put& put) {
  const int dH = byte & 3, dD = (byte >> 2) & 1, dI = (byte >> 3) & 3;
  const int mop = ((byte >> 5) & 1) ? OP_MATCH : OP_MISMATCH;
  const bool do_diag = w.state == 0 && dH == DH_DIAG;
  const bool do_sm = w.state == 0 && dH == DH_SM;
  const bool do_d = w.state == 1 || (w.state == 0 && dH == DH_D);
  const bool do_i = w.state == 2 || (w.state == 0 && dH == DH_I);
  const bool i_fresh = do_i && dI == DI_FRESH;
  const int op = (do_diag || do_sm) ? mop : (do_d ? OP_DEL : OP_INS);
  const int ni = (do_diag || (do_i && !i_fresh)) ? w.i - 1 : w.i;
  const int nj = (do_diag || do_sm || do_d) ? w.j - 1 : w.j;
  const int nstate = do_d ? (dD == DD_OPEN ? 0 : 1)
                          : ((do_i && !i_fresh) ? (dI == DI_OPEN ? 0 : 2) : 0);
  if (do_sm || i_fresh) {
    w.clipv = w.i - 1;
    w.startj = do_sm ? w.j - 1 : w.j;
    w.done = 1;
  }
  if (op == w.cur_op) {
    ++w.cur_cnt;
  } else {
    if (w.cur_cnt > 0) put(w.cur_op, w.cur_cnt);
    w.cur_op = op;
    w.cur_cnt = 1;
  }
  w.i = ni;
  w.j = nj;
  w.state = nstate;
}

// The end of a walk: the exits at the window start (j == 0: an insert
// tail and the left clip, at most clip_l of it free) and at the read
// start (i == 0), then the last runs: the current one (an insert tail
// merged into a trailing insert run), the insert tail, the left clip.
template <typename Put>
__device__ __forceinline__ void tb_close(TbWalk& w, int clip_l, Put& put) {
  int ins_tail = 0;
  if (!w.done && w.j == 0 && w.i > 0) {  // walked off the window start
    const int scl = min(clip_l, w.i);
    ins_tail = w.i - scl;
    w.clipv = scl;
    w.startj = 0;
  } else if (!w.done && w.i == 0) {      // walked off the read start
    w.startj = w.j;
  }
  if (w.cur_cnt > 0 && ins_tail > 0 && w.cur_op == OP_INS) {
    w.cur_cnt += ins_tail;
    ins_tail = 0;
  }
  if (w.cur_cnt > 0) put(w.cur_op, w.cur_cnt);
  if (ins_tail > 0) put(OP_INS, ins_tail);
  if (w.clipv > 0) put(OP_CLIP, w.clipv);
}

}  // namespace soap3dp
