// SA-IS suffix array construction (linear time, induced sorting).
//
// Replaces the reference's Larsson-Sadakane qsufsort + incremental BWT
// build (2bwt-lib/QSufSort.c:53, BWTConstruct.c:113) for the offline
// index builder: SA-IS is O(n) and a single pass over flat arrays, so
// a whole-genome suffix array builds in minutes on one core.
//
// Exposed C ABI (loaded from Python via ctypes):
//   int sais_u8_u32(const uint8_t* t, int64_t n, uint32_t* sa)
// computes the suffix array of t[0..n) over alphabet {0..255} with the
// usual virtual-sentinel convention (suffix end-of-string < any char),
// writing n entries to sa. Returns 0 on success. Valid for any
// n < 2^32 - 1 — which covers every genome within the index format's
// 4 Gbp limit, so the production path is ALWAYS the uint32 template:
// positions fit u32, the SA buffer halves (24.8 -> 12.4 GB at
// 3.1 Gbp, and no separate int64 buffer + convert copy on top), and
// the streamed SA element traffic halves. Throughput itself is
// latency-bound on the random T/ls reads, so the time win is modest
// (~1.0x measured at 250 Mbp under contention) — the footprint is
// the point.
//   int sais_u8(const uint8_t* t, int64_t n, int64_t* sa)
// same, int64 output (kept as the differential oracle for the u32
// path and for hypothetical >4 Gbp texts).
//
// The template is unsigned-safe: EMPTY = (I)-1 (0xFFFFFFFF for u32 —
// distinguishable from every position since n < 2^32 - 1), descending
// loops use the `i-- > 0` form, and no comparison relies on negative
// values.
//
// Memory plan (matters at 3.1 Gbp): beyond the caller's n*4B SA buffer
// the top level keeps
//   ls        n bytes        (L/S types)
//   lms       nlms * 4B      (exact-size allocation, nlms <= n/2)
//   name      ceil(n/2)*4B   (LMS positions are >= 2 apart, so names
//                             are stored at index j/2 — half an array;
//                             freed before recursing)
//   red/sa1   nlms * 4B      (the reduced problem always fits 32 bits
//                             for n <= 4 Gbp since nlms <= n/2 < 2^31)
// so the 3.1 Gbp human build peaks around ~25 GB including the SA
// buffer.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

template <typename I>
struct Sais {
  // T: values in [0, K); SA: output, length n.
  template <typename Char>
  static int run(const Char* T, I n, I K, I* SA) {
    if (n == 0) return 0;
    if (n == 1) { SA[0] = 0; return 0; }
    const I EMPTY = (I)-1;  // never a position: n < EMPTY by contract

    std::vector<uint8_t> ls((size_t)n);  // 1 = S-type, 0 = L-type
    ls[n - 1] = 0;  // last real char is L-type (> virtual sentinel)
    for (I i = n - 1; i-- > 0;)
      ls[(size_t)i] = (T[i] < T[i + 1] || (T[i] == T[i + 1] && ls[(size_t)i + 1])) ? 1 : 0;

    auto is_lms = [&](I i) { return i > 0 && ls[(size_t)i] && !ls[(size_t)i - 1]; };

    std::vector<I> cnt((size_t)K, 0), head((size_t)K), tail((size_t)K);
    for (I i = 0; i < n; ++i) cnt[(size_t)T[i]]++;
    auto reset_heads = [&]() {
      I s = 0;
      for (I c = 0; c < K; ++c) { head[(size_t)c] = s; s += cnt[(size_t)c]; }
    };
    auto reset_tails = [&]() {
      I s = 0;
      for (I c = 0; c < K; ++c) { s += cnt[(size_t)c]; tail[(size_t)c] = s; }
    };

    auto induce = [&](const I* lms, size_t nlms) {
      for (I i = 0; i < n; ++i) SA[i] = EMPTY;
      // place LMS suffixes at bucket tails, in the given order reversed
      reset_tails();
      for (size_t k = nlms; k-- > 0;) {
        I j = lms[k];
        SA[--tail[(size_t)T[j]]] = j;
      }
      // induce L-types left-to-right; virtual sentinel first.
      // The loops are memory-latency-bound: each step reads T/ls at a
      // random position SA[i]-1. SA itself streams sequentially, so
      // prefetching T/ls at SA[i+PF]-1 overlaps ~PF cache misses
      // (measured 1.35x on the 250 Mbp induce; SA[i+PF] may still be
      // unwritten (-1) in these progressive fills — harmless, the
      // prefetch is skipped).
      constexpr I PF = 24;
      reset_heads();
      {
        I j = n - 1;  // suffix preceding the sentinel
        if (!ls[(size_t)j]) SA[head[(size_t)T[j]]++] = j;
      }
      for (I i = 0; i < n; ++i) {
        if (i + PF < n) {
          I jp = SA[i + PF];
          if (jp != EMPTY && jp != 0) {
            __builtin_prefetch(&T[jp - 1]);
            __builtin_prefetch(&ls[(size_t)jp - 1]);
          }
        }
        I j = SA[i];
        if (j != EMPTY && j != 0 && !ls[(size_t)j - 1])
          SA[head[(size_t)T[j - 1]]++] = j - 1;
      }
      // induce S-types right-to-left
      reset_tails();
      for (I i = n; i-- > 0;) {
        if (i >= PF) {
          I jp = SA[i - PF];
          if (jp != EMPTY && jp != 0) {
            __builtin_prefetch(&T[jp - 1]);
            __builtin_prefetch(&ls[(size_t)jp - 1]);
          }
        }
        I j = SA[i];
        if (j != EMPTY && j != 0 && ls[(size_t)j - 1])
          SA[--tail[(size_t)T[j - 1]]] = j - 1;
      }
    };

    // collect LMS positions in text order (count first: exact-size alloc,
    // no push_back growth spikes at multi-GB scale)
    size_t nlms_sz = 0;
    for (I i = 1; i < n; ++i)
      if (is_lms(i)) ++nlms_sz;
    std::vector<I> lms(nlms_sz);
    {
      size_t k = 0;
      for (I i = 1; i < n; ++i)
        if (is_lms(i)) lms[k++] = i;
    }
    I nlms = (I)nlms_sz;
    if (nlms == 0) {
      // strictly decreasing text: SA is reverse identity by induction
      induce(lms.data(), 0);
      return 0;
    }

    induce(lms.data(), nlms_sz);

    // name LMS substrings in SA order; two consecutive LMS positions
    // differ by >= 2, so names live at index j/2 (half-size array)
    std::vector<I> name((size_t)(n / 2 + 1), EMPTY);
    I names = 0;
    I prev = EMPTY;
    constexpr I PF = 24;
    for (I i = 0; i < n; ++i) {
      if (i + PF < n) {
        I jp = SA[i + PF];
        if (jp != EMPTY && jp != 0) {
          __builtin_prefetch(&T[jp]);
          __builtin_prefetch(&ls[(size_t)jp]);
          __builtin_prefetch(&name[(size_t)(jp / 2)], 1);
        }
      }
      I j = SA[i];
      if (j == EMPTY || j == 0 || !is_lms(j)) continue;
      if (prev == EMPTY) {
        name[(size_t)(j / 2)] = names++;
      } else {
        // compare LMS substrings at prev and j
        bool same = true;
        for (I d = 0;; ++d) {
          I a = prev + d, b = j + d;
          bool ea = a >= n, eb = b >= n;
          if (ea || eb) { same = ea && eb; break; }
          if (T[a] != T[b] || ls[(size_t)a] != ls[(size_t)b]) { same = false; break; }
          if (d > 0 && (is_lms(a) || is_lms(b))) { same = is_lms(a) && is_lms(b); break; }
        }
        if (!same) ++names;
        name[(size_t)(j / 2)] = names - 1;
      }
      prev = j;
    }

    // reduced problem: names of LMS substrings in text order. nlms <= n/2,
    // so for any text within the 4 Gbp format limit the reduced problem
    // fits int32 — recurse narrow to halve the recursion tree's memory.
    bool narrow = sizeof(I) > 4 && (int64_t)nlms < ((int64_t)1 << 31)
                  && (int64_t)names < ((int64_t)1 << 31);
    std::vector<I> sa1((size_t)nlms);
    if (narrow) {
      std::vector<int32_t> red32((size_t)nlms);
      for (I k = 0; k < nlms; ++k)
        red32[(size_t)k] = (int32_t)name[(size_t)(lms[(size_t)k] / 2)];
      std::vector<I>().swap(name);  // free before recursing
      if ((int64_t)names < (int64_t)nlms) {
        std::vector<int32_t> sa32((size_t)nlms);
        int rc = Sais<int32_t>::run(red32.data(), (int32_t)nlms,
                                    (int32_t)names, sa32.data());
        if (rc) return rc;
        for (I k = 0; k < nlms; ++k) sa1[(size_t)k] = (I)sa32[(size_t)k];
      } else {
        for (I k = 0; k < nlms; ++k) sa1[(size_t)red32[(size_t)k]] = k;
      }
    } else {
      std::vector<I> red((size_t)nlms);
      for (I k = 0; k < nlms; ++k)
        red[(size_t)k] = name[(size_t)(lms[(size_t)k] / 2)];
      std::vector<I>().swap(name);
      if (names < nlms) {
        int rc = run<I>(red.data(), nlms, names, sa1.data());
        if (rc) return rc;
      } else {
        for (I k = 0; k < nlms; ++k) sa1[(size_t)red[(size_t)k]] = k;
      }
    }

    // final induce with LMS suffixes in sorted order (reuse sa1's storage
    // pattern: overwrite sa1 in place via a temp swap through lms order)
    std::vector<I> sorted_lms((size_t)nlms);
    for (I k = 0; k < nlms; ++k) {
      if (k + PF < nlms) __builtin_prefetch(&lms[(size_t)sa1[(size_t)(k + PF)]]);
      sorted_lms[(size_t)k] = lms[(size_t)sa1[(size_t)k]];
    }
    std::vector<I>().swap(sa1);
    std::vector<I>().swap(lms);
    induce(sorted_lms.data(), nlms_sz);
    return 0;
  }
};

}  // namespace

extern "C" {

// Production path: u32 output, valid for every text within the index
// format's 4 Gbp limit (n < 2^32 - 1 so EMPTY stays distinguishable).
int sais_u8_u32(const uint8_t* t, int64_t n, uint32_t* sa) {
  if (n < 0 || n >= (int64_t)0xFFFFFFFF) return 1;
  return Sais<uint32_t>::run(t, (uint32_t)n, (uint32_t)256, sa);
}

int sais_u8(const uint8_t* t, int64_t n, int64_t* sa) {
  if (n < 0) return 1;
  if (n < (int64_t)1 << 31) {
    std::vector<int32_t> sa32((size_t)n);
    int rc = Sais<int32_t>::run(t, (int32_t)n, (int32_t)256, sa32.data());
    if (rc) return rc;
    for (int64_t i = 0; i < n; ++i) sa[i] = sa32[(size_t)i];
    return 0;
  }
  return Sais<int64_t>::run(t, n, (int64_t)256, sa);
}

// Test hook: force the int64 template regardless of n, so the code path
// taken by >2^31 texts (human-scale builds) is exercised by small tests.
int sais_u8_force64(const uint8_t* t, int64_t n, int64_t* sa) {
  if (n < 0) return 1;
  return Sais<int64_t>::run(t, n, (int64_t)256, sa);
}

}  // extern "C"
