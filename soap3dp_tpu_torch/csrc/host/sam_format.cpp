// Columnar SAM text formatter.
//
// The Python block writer (io/sam.py write_block) assembles each field
// with vectorized numpy, but the np.char.add chain still costs ~1.5-2us
// per record and runs on the single output thread; at 200k+ records per
// block the serialization backlog stalls the whole pipeline through the
// bounded writer queue. This C path emits the same bytes in one pass
// (~100-200ns per record): the analog of the reference's hand-rolled
// record assembly in BGS-IO.cpp:2131-2273 (which likewise bypasses any
// general-purpose formatting layer for the hot path).
//
// Hot-path extras (all optional, bench sam_out tax work — VERDICT r3 #4):
//  * names may arrive as the numpy 'S' fixed-width buffer directly
//    (name_w > 0, NUL-padded rows) so Python never builds a ragged copy
//  * gapless=1 emits "<seq_len>M" cigars straight from seq_lens — the
//    fast path's cigars are always single-M, so no cigar column exists
//  * seq_src lets a paired-end block keep mate-1/mate-2 code+qual
//    matrices separate: src >= 0 reads seq_codes row src, src < 0 reads
//    seq2_codes row ~src — the 2x(N,L) interleave copy never happens
//  * xa_off/xa_ent carry a record's XA:Z alternates as a CSR group:
//    record i's entries are rows xa_off[i] .. xa_off[i+1] - 1 of the
//    (E, 4) rows (chrom, strand, pos, nm), each written as
//    "name,(+|-)pos+1,<seq_len>M,nm;" after the X0..XG block; a record
//    with none gets no XA tag, and xa_off NULL writes no XA at all
//
// C ABI (ctypes): sam_format_block(...) writes SAM text lines for n
// records into `out` and returns the byte count, or -1 if out_cap is
// too small (caller re-allocates; sizes are estimated generously so
// this is a safety net, not a code path).

#include <cstdint>
#include <cstring>

namespace {

inline char* put_u64(char* p, uint64_t v) {
  char tmp[20];
  int i = 0;
  do { tmp[i++] = '0' + (char)(v % 10); v /= 10; } while (v);
  while (i) *p++ = tmp[--i];
  return p;
}

inline char* put_i64(char* p, int64_t v) {
  if (v < 0) { *p++ = '-'; return put_u64(p, (uint64_t)(-v)); }
  return put_u64(p, (uint64_t)v);
}

const char kBase[4] = {'A', 'C', 'G', 'T'};

}  // namespace

extern "C" {

int64_t sam_format_block(
    int64_t n,
    const uint8_t* names, const int64_t* name_off, int64_t name_w,
    const int64_t* flags,
    const uint8_t* rnames, const int64_t* rname_off,
    const int64_t* chroms,
    const int64_t* poss,
    const int64_t* mapqs,
    const uint8_t* cigars, const int64_t* cigar_off, int32_t gapless,
    int32_t has_mate,
    const int64_t* mate_chroms, const int64_t* mate_poss,
    const int64_t* tlens,
    int32_t has_seq, int64_t L,
    const uint8_t* seq_codes, const int64_t* seq_lens,
    int32_t has_qual, const uint8_t* quals,
    const uint8_t* seq2_codes, const uint8_t* quals2,
    const int64_t* seq_src, int64_t L2,
    int32_t has_tags, const int64_t* x0, const int64_t* x1,
    const int64_t* xm,
    const int64_t* xa_off, const int64_t* xa_ent,
    uint8_t* out, int64_t out_cap) {
  char* p = (char*)out;
  char* end = (char*)out + out_cap;
  for (int64_t i = 0; i < n; ++i) {
    int64_t f = flags[i];
    int64_t c = chroms[i];
    // QNAME source + length: ragged (name_off) or fixed-width rows
    const uint8_t* nm;
    size_t nl;
    if (name_w > 0) {
      nm = names + i * name_w;
      nl = strnlen((const char*)nm, (size_t)name_w);
    } else {
      nm = names + name_off[i];
      nl = (size_t)(name_off[i + 1] - name_off[i]);
    }
    // worst case per record: name + cigar + RNAME + RNEXT + 2*L +
    // ~120 digits/tabs (reference names can be arbitrarily long —
    // scaffold/contig headers — so they must be counted, not folded
    // into the constant)
    int64_t rn = (c >= 0) ? rname_off[c + 1] - rname_off[c] : 1;
    int64_t mc0 = has_mate ? mate_chroms[i] : -1;
    int64_t mrn = (mc0 >= 0 && mc0 != c)
        ? rname_off[mc0 + 1] - rname_off[mc0] : 1;
    int64_t maxl = (L2 > L) ? L2 : L;
    int64_t need = (int64_t)nl
        + (cigar_off ? cigar_off[i + 1] - cigar_off[i] : 22)
        + rn + mrn + 2 * (has_seq ? maxl : 1) + 160;
    if (end - p < need) return -1;
    // QNAME FLAG RNAME POS MAPQ CIGAR
    std::memcpy(p, nm, nl); p += nl;
    *p++ = '\t';
    p = put_i64(p, f); *p++ = '\t';
    if (c >= 0) {
      size_t rl = (size_t)(rname_off[c + 1] - rname_off[c]);
      std::memcpy(p, rnames + rname_off[c], rl); p += rl;
      *p++ = '\t';
      p = put_i64(p, poss[i] + 1);
    } else {
      *p++ = '*'; *p++ = '\t'; *p++ = '0';
    }
    *p++ = '\t';
    p = put_i64(p, mapqs[i]); *p++ = '\t';
    if (gapless && has_seq) {
      p = put_i64(p, seq_lens[i]); *p++ = 'M';
    } else if (cigar_off && cigar_off[i + 1] > cigar_off[i]) {
      size_t cl = (size_t)(cigar_off[i + 1] - cigar_off[i]);
      std::memcpy(p, cigars + cigar_off[i], cl); p += cl;
    } else {
      *p++ = '*';
    }
    *p++ = '\t';
    // RNEXT PNEXT TLEN
    if (!has_mate || mate_chroms[i] < 0) {
      *p++ = '*'; *p++ = '\t'; *p++ = '0'; *p++ = '\t';
      p = put_i64(p, has_mate ? tlens[i] : 0);
    } else {
      int64_t mc = mate_chroms[i];
      if (mc == c) {
        *p++ = '=';
      } else {
        size_t rl = (size_t)(rname_off[mc + 1] - rname_off[mc]);
        std::memcpy(p, rnames + rname_off[mc], rl); p += rl;
      }
      *p++ = '\t';
      p = put_i64(p, mate_poss[i] + 1); *p++ = '\t';
      p = put_i64(p, tlens[i]);
    }
    *p++ = '\t';
    // SEQ QUAL (reverse-complement when FLAG_REVERSE and mapped)
    if (has_seq) {
      int64_t sl = seq_lens[i];
      const uint8_t* sc;
      const uint8_t* q = nullptr;
      if (seq_src) {
        int64_t s = seq_src[i];
        if (s >= 0) {
          sc = seq_codes + s * L;
          if (has_qual) q = quals + s * L;
        } else {
          sc = seq2_codes + (~s) * L2;
          if (has_qual) q = quals2 + (~s) * L2;
        }
      } else {
        sc = seq_codes + i * L;
        if (has_qual) q = quals + i * L;
      }
      bool rev = (f & 0x10) && !(f & 0x4);
      if (rev) {
        for (int64_t j = sl - 1; j >= 0; --j) *p++ = kBase[3 - (sc[j] & 3)];
      } else {
        for (int64_t j = 0; j < sl; ++j) *p++ = kBase[sc[j] & 3];
      }
      *p++ = '\t';
      if (has_qual) {
        if (rev) {
          for (int64_t j = sl - 1; j >= 0; --j) *p++ = (char)q[j];
        } else {
          std::memcpy(p, q, (size_t)sl); p += sl;
        }
      } else {
        *p++ = '*';
      }
    } else {
      *p++ = '*'; *p++ = '\t'; *p++ = '*';
    }
    if (has_tags) {
      std::memcpy(p, "\tX0:i:", 6); p += 6; p = put_i64(p, x0[i]);
      std::memcpy(p, "\tX1:i:", 6); p += 6; p = put_i64(p, x1[i]);
      std::memcpy(p, "\tXM:i:", 6); p += 6; p = put_i64(p, xm[i]);
      std::memcpy(p, "\tXO:i:0\tXG:i:0", 14); p += 14;
    }
    if (xa_off) {
      for (int64_t e = xa_off[i]; e < xa_off[i + 1]; ++e) {
        const int64_t* x = xa_ent + 4 * e;
        size_t rl = (size_t)(rname_off[x[0] + 1] - rname_off[x[0]]);
        // the tag's head, the name, three numbers of up to 21 bytes,
        // 6 marks, the newline
        if (end - p < (int64_t)rl + 80) return -1;
        if (e == xa_off[i]) { std::memcpy(p, "\tXA:Z:", 6); p += 6; }
        std::memcpy(p, rnames + rname_off[x[0]], rl); p += rl;
        *p++ = ',';
        *p++ = x[1] ? '-' : '+';
        p = put_i64(p, x[2] + 1); *p++ = ',';
        p = put_i64(p, seq_lens[i]); *p++ = 'M'; *p++ = ',';
        p = put_i64(p, x[3]); *p++ = ';';
      }
    }
    *p++ = '\n';
  }
  return (int64_t)((uint8_t*)p - out);
}

}  // extern "C"
