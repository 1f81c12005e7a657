// The decoupled look-back between tiles of one launch, shared by FS4 and
// FS5 (fm_search.cu) and DW (dp_wire.cu): a single-pass scan in which
// each block takes a ticket (so tiles run in ticket order and a tile
// waits only on tiles that already run), publishes its own count,
// sums the counts of the tiles before it back to the nearest that holds
// its inclusive count, and publishes its inclusive count.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace soap3dp_lookback {

constexpr unsigned FULL = 0xffffffffu;  // a whole warp
constexpr int LOOKBACK = 8;             // status words a lane a round
constexpr uint32_t ST_AGG = 1u;         // the tile's own count
constexpr uint32_t ST_INCL = 2u;        // the count up to the tile

// the inclusive scan of x over a warp
__device__ __forceinline__ int32_t warp_scan(int32_t x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

__device__ __forceinline__ uint64_t ld_status(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void st_status(unsigned long long* p,
                                          uint64_t v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// A tile's status word: the high 32 bits its tag (the call's
// generation << 2) and state (1: its own count, 2: the count of every
// tile up to it), the low 32 bits the count. FS4, FS5 and DW keep their
// statuses and ticket counter across calls on one card and stream (the
// wrappers' scan state, zeroed once); each call takes a generation above
// every earlier call's there, so a word an earlier call left reads as
// not yet written, and counts its tickets from the ones they took.
__device__ __forceinline__ uint64_t status_word(uint32_t tag, uint32_t state,
                                                uint32_t count) {
  return (static_cast<uint64_t>(tag | state) << 32) | count;
}

// one warp: publish tile t's count, sum the counts of the tiles before
// it back to the nearest that holds its inclusive count (before tile 0
// an inclusive 0), publish its inclusive count; returns the count
// before the tile. A round reads the status words of the 256 tiles
// before the last round's at once (8 a lane), so a tile that finds no
// inclusive count near it walks back 256 tiles a round, not 32. The
// single-pass scan of FS4 (the firsts), FS5 (the lanes' counts) and DW
// (the runs' words). With ACQUIRE the warp fences after the statuses it
// read and before it publishes its own (FS5's flagged words, DW's
// header: what tile 0 wrote before its status is seen before the tile's
// atomics), while none of its stores is in flight.
template <bool ACQUIRE>
__device__ int32_t tile_lookback(unsigned long long* status, int64_t t,
                                 int32_t count, int lane, uint32_t tag) {
  const uint32_t agg = tag | ST_AGG, incl = tag | ST_INCL;
  const uint32_t own = static_cast<uint32_t>(count);
  if (t == 0) {
    if (lane == 0) st_status(status, status_word(tag, ST_INCL, own));
    return 0;
  }
  if (lane == 0) st_status(status + t, status_word(tag, ST_AGG, own));
  int32_t before = 0;
  for (int64_t j = t - 1;; j -= 32 * LOOKBACK) {
    uint64_t s[LOOKBACK];
#pragma unroll
    for (int q = 0; q < LOOKBACK; ++q) {
      const int64_t i = j - 32 * q - lane;
      s[q] = i >= 0 ? ld_status(status + i) : status_word(tag, ST_INCL, 0);
    }
    for (;;) {  // until every word holds a count of this call
      bool wait = false;
#pragma unroll
      for (int q = 0; q < LOOKBACK; ++q) {
        const uint32_t hi = static_cast<uint32_t>(s[q] >> 32);
        wait |= hi != agg && hi != incl;
      }
      if (!__any_sync(FULL, wait)) break;
      __nanosleep(32);
#pragma unroll
      for (int q = 0; q < LOOKBACK; ++q) {
        const uint32_t hi = static_cast<uint32_t>(s[q] >> 32);
        if (hi != agg && hi != incl)
          s[q] = ld_status(status + j - 32 * q - lane);
      }
    }
    // the nearest inclusive count: the least distance 32 q + lane
    int near = 32 * LOOKBACK;
#pragma unroll
    for (int q = LOOKBACK - 1; q >= 0; --q)
      if (static_cast<uint32_t>(s[q] >> 32) == incl) near = 32 * q + lane;
    near = __reduce_min_sync(FULL, near);
    uint32_t sum = 0;
#pragma unroll
    for (int q = 0; q < LOOKBACK; ++q)
      if (32 * q + lane <= near) sum += static_cast<uint32_t>(s[q]);
    before += static_cast<int32_t>(__reduce_add_sync(FULL, sum));
    if (near < 32 * LOOKBACK) break;
  }
  if (ACQUIRE) __threadfence();
  if (lane == 0)
    st_status(status + t, status_word(tag, ST_INCL,
                                      static_cast<uint32_t>(before + count)));
  return before;
}

}  // namespace soap3dp_lookback
