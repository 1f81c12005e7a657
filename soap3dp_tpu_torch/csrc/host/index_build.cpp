// Fused FM-table + SA-sampling + LUT construction for the index builder.
//
// The numpy builder stages re-scan multi-GB arrays once per derived
// table (build_v2.log at 3.1 Gbp: fm 950 s + sampling 672 s + lut
// 664 s on one core — each stage is several full passes over the
// 12.4 GB suffix array / 3.1 GB code array plus transient int32/int64
// temporaries). These routines produce bit-identical artifacts in ONE
// streaming pass each (tests/test_builder_native.py asserts equality
// against the numpy implementations):
//
//   fused_tables_u32: one pass over SA rows emitting, simultaneously,
//     the packed BWT words + per-word occ counts (builder.py
//     _build_fm_tables), the value-sampled SA bitvector + rank
//     directory + samples (_build_sa_sampling), the sentinel row
//     (bwt_from_sa's `primary`), and the base counts — the SA is read
//     once sequentially and `codes` is the only random access.
//
//   lut_build: rolling k-mer counting pass over the text
//     (_build_lut): counts + short-suffix bumps + cumsum, no suffix
//     array access at all.
//
// Array-size contract (caller allocates):
//   occ         4 * (n/16 + 1) u32, flat occ[4w + c]
//   bwt_words   n/16 + 1      u32
//   mark_rank   (n+1)/32 + 1  u32
//   mark_words  (n+1)/32 + 1  u32
//   sa_samples  n/rate + 1    u32 (exact count of rows with sa%rate==0)
//   lut_lo/hi   4^k           u32

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// codes: n bytes of 2-bit base codes; sa: n+1 u32 rows (sa[0..n] is a
// permutation of 0..n); sa_rate: power of two. Returns 0 on success.
int fused_tables_u32(const uint8_t* codes, int64_t n, const uint32_t* sa,
                     int64_t sa_rate, uint32_t* occ, uint32_t* bwt_words,
                     uint32_t* mark_rank, uint32_t* mark_words,
                     uint32_t* sa_samples, int64_t* primary_out,
                     int64_t* base_counts) {
  if (n <= 0 || (sa_rate & (sa_rate - 1)) != 0) return 1;
  const uint32_t rmask = (uint32_t)(sa_rate - 1);
  uint32_t occ_acc[4] = {0, 0, 0, 0};
  uint32_t word = 0;
  int64_t j = 0;  // BWT position (rows minus the sentinel row)
  uint32_t rank_acc = 0, mword = 0;
  int64_t ns = 0, primary = -1;
  for (int64_t i = 0; i <= n; ++i) {
    // SA sampling over ROW index i (n+1 rows incl. the sentinel row)
    if ((i & 31) == 0) {
      mark_rank[i >> 5] = rank_acc;
      mword = 0;
    }
    const uint32_t s = sa[i];
    if ((s & rmask) == 0) {
      mword |= 1u << (i & 31);
      sa_samples[ns++] = s;
      ++rank_acc;
    }
    if ((i & 31) == 31) mark_words[i >> 5] = mword;
    // BWT char over position j (sentinel row contributes no char)
    if (s == 0) {
      primary = i;
    } else {
      if ((j & 15) == 0) {
        uint32_t* o = occ + 4 * (j >> 4);
        o[0] = occ_acc[0]; o[1] = occ_acc[1];
        o[2] = occ_acc[2]; o[3] = occ_acc[3];
        word = 0;
      }
      const uint32_t c = codes[s - 1];
      ++occ_acc[c];
      word |= c << (2 * (j & 15));
      if ((j & 15) == 15) bwt_words[j >> 4] = word;
      ++j;
    }
  }
  if (j != n || primary < 0) return 2;
  // tails: partial BWT word (padding packs as 0 = 'A', masked by occ),
  // any untouched occ/bwt entries up to nw, partial mark word, and
  // rank entries for trailing all-zero mark words
  const int64_t nw = n / 16 + 1;
  if ((j & 15) != 0) bwt_words[j >> 4] = word;
  for (int64_t w = (j + 15) >> 4; w < nw; ++w) {
    uint32_t* o = occ + 4 * w;
    o[0] = occ_acc[0]; o[1] = occ_acc[1];
    o[2] = occ_acc[2]; o[3] = occ_acc[3];
    bwt_words[w] = 0;
  }
  const int64_t rows = n + 1, nmw = (n + 1) / 32 + 1;
  if ((rows & 31) != 0) mark_words[rows >> 5] = mword;
  for (int64_t w = (rows + 31) >> 5; w < nmw; ++w) {
    mark_rank[w] = rank_acc;
    mark_words[w] = 0;
  }
  if ((rows & 31) == 0 && (rows >> 5) < nmw) {
    // row count is a multiple of 32: the final directory word was never
    // entered in the loop; its rank is the grand total
    mark_rank[rows >> 5] = rank_acc;
    mark_words[rows >> 5] = 0;
  }
  *primary_out = primary;
  int64_t bc[4] = {0, 0, 0, 0};
  // base counts from occ totals (occ excludes the sentinel only)
  for (int c = 0; c < 4; ++c) bc[c] = occ_acc[c];
  std::memcpy(base_counts, bc, sizeof bc);
  return 0;
}

// [lo, hi) SA-row interval for every k-mer, matching builder._build_lut:
// counts of full k-mers + short-suffix bumps + cumsums.
int lut_build(const uint8_t* codes, int64_t n, int32_t k,
              uint32_t* lut_lo, uint32_t* lut_hi) {
  if (n <= 0 || k < 1 || k > 15) return 1;
  const int64_t size = (int64_t)1 << (2 * k);
  const uint32_t mask = (uint32_t)(size - 1);
  std::vector<uint32_t> cnt((size_t)size, 0);
  const int64_t valid = n - k + 1 > 0 ? n - k + 1 : 0;
  uint32_t val = 0;
  int64_t i = 0;
  for (; i < k - 1 && i < n; ++i) val = ((val << 2) | codes[i]) & mask;
  for (; i < n; ++i) {
    val = ((val << 2) | codes[i]) & mask;
    ++cnt[val];  // k-mer starting at i-k+1
  }
  (void)valid;
  // short suffixes (length 1..k-1): each sorts immediately before the
  // patterns it prefixes (past-the-end ranks below any base)
  std::vector<uint32_t> bumps((size_t)size, 0);
  const int64_t start0 = valid > 0 ? valid : 0;
  for (int64_t st = start0; st < n; ++st) {
    uint32_t m_v = 0;
    for (int64_t t = 0; st + t < n; ++t)
      m_v |= (uint32_t)codes[st + t] << (2 * (k - 1 - t));
    ++bumps[m_v];
  }
  // lo = 1 + excl-cumsum(cnt) + incl-cumsum(bumps); hi = lo + cnt
  uint64_t excl = 0, binc = 0;
  for (int64_t m = 0; m < size; ++m) {
    binc += bumps[m];
    const uint64_t lo = 1 + excl + binc;
    lut_lo[m] = (uint32_t)lo;
    lut_hi[m] = (uint32_t)(lo + cnt[m]);
    excl += cnt[m];
  }
  return 0;
}

}  // extern "C"
