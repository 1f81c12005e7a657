// Native FASTA/FASTQ batch reader: the rebuild's analog of the
// reference's C++ QueryParser (QueryParser.cpp:27-995) — buffered
// gzip-aware parsing with direct 2-bit encoding into the caller's
// rectangular batch buffers, so Python never touches per-read data.
//
// Exposed via ctypes (see soap3dp_tpu/io/fastq_native.py):
//   fqr_open(path)                      -> handle (NULL on error)
//   fqr_next_batch(handle, B, maxlen, codes, lens, quals, names,
//                  name_stride, flags)  -> number of reads produced
//   fqr_close(handle)
//
// codes:  B x maxlen uint8 2-bit codes (non-ACGT -> G=2), zero padded
// lens:   B int32 (clipped to maxlen)
// quals:  B x maxlen raw quality bytes (FASTQ only), zero padded
// names:  B x name_stride bytes, NUL-terminated (truncated if long)
// flags:  int32[2]: [0] = has_qual (0/1), [1] = saw_truncated_read

#include <zlib.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

constexpr int kBufSize = 1 << 20;

struct Reader {
  gzFile gz;
  unsigned char* buf;
  int len;   // bytes in buf
  int pos;   // cursor
  bool eof;
  bool err;  // gzread reported a decompression/CRC error
  int format;  // 0 = unknown, 1 = FASTA, 2 = FASTQ
  // pending FASTA record state: header of the NEXT record already read
  char pending_name[256];
  bool has_pending;

  bool fill() {
    if (eof) return len > pos;
    if (pos > 0) {
      memmove(buf, buf + pos, len - pos);
      len -= pos;
      pos = 0;
    }
    int got = gzread(gz, buf + len, kBufSize - len);
    if (got < 0) {
      // CRC error / truncated gzip: surface as a parse error, not EOF,
      // so damaged inputs are not silently read as shorter files.
      err = true;
      eof = true;
    } else if (got == 0) {
      eof = true;
    } else {
      len += got;
    }
    return len > pos;
  }

  // Read one line (without terminator) into out (capacity cap); returns
  // length or -1 at EOF. Lines longer than cap are consumed but clipped.
  int getline(char* out, int cap) {
    int n = 0;
    bool any = false;
    for (;;) {
      if (pos >= len && !fill()) return any ? n : -1;
      unsigned char* start = buf + pos;
      unsigned char* nl = (unsigned char*)memchr(start, '\n', len - pos);
      int span = nl ? (int)(nl - start) : (len - pos);
      any = any || span > 0 || nl != nullptr;
      int take = span < cap - n ? span : cap - n;
      memcpy(out + n, start, take);
      n += take;
      pos += span + (nl ? 1 : 0);
      if (nl) {
        if (n > 0 && out[n - 1] == '\r') n--;  // CRLF
        return n;
      }
    }
  }
};

unsigned char kCode[256];
struct CodeInit {
  CodeInit() {
    memset(kCode, 2, sizeof(kCode));  // non-ACGT -> G
    kCode[(int)'A'] = 0; kCode[(int)'a'] = 0;
    kCode[(int)'C'] = 1; kCode[(int)'c'] = 1;
    kCode[(int)'G'] = 2; kCode[(int)'g'] = 2;
    kCode[(int)'T'] = 3; kCode[(int)'t'] = 3;
  }
} code_init;

void store_name(char* dst, int stride, const char* line, int linelen) {
  // name = first whitespace-delimited token after '>'/'@'
  int i = 0;
  while (i < linelen && line[i] != ' ' && line[i] != '\t') i++;
  int n = i < stride - 1 ? i : stride - 1;
  memcpy(dst, line, n);
  dst[n] = 0;
}

}  // namespace

extern "C" {

void* fqr_open(const char* path) {
  gzFile gz = gzopen(path, "rb");
  if (!gz) return nullptr;
  gzbuffer(gz, kBufSize);
  Reader* r = new Reader();
  r->gz = gz;
  r->buf = (unsigned char*)malloc(kBufSize);
  r->len = r->pos = 0;
  r->eof = false;
  r->err = false;
  r->format = 0;
  r->has_pending = false;
  return r;
}

void fqr_close(void* h) {
  Reader* r = (Reader*)h;
  if (!r) return;
  gzclose(r->gz);
  free(r->buf);
  delete r;
}

// Returns #reads; 0 = EOF; -1 = parse error.
int64_t fqr_next_batch(void* h, int64_t batch, int64_t maxlen,
                       unsigned char* codes, int32_t* lens,
                       unsigned char* quals, char* names,
                       int64_t name_stride, int32_t* flags) {
  Reader* r = (Reader*)h;
  static thread_local char* line = nullptr;
  static thread_local int line_cap = 0;
  int need = (int)(maxlen * 4 + 4096);
  if (line_cap < need) {
    line = (char*)realloc(line, need);
    line_cap = need;
  }
  // has_qual follows the persistent detected format (FASTA batches after
  // the first must keep reporting has_qual=0); defaults to 1 while the
  // format is still unknown and is re-derived before every return below.
  flags[0] = (r->format != 1);
  int64_t out = 0;
  while (out < batch) {
    unsigned char* crow = codes + out * maxlen;
    unsigned char* qrow = quals + out * maxlen;
    char* nrow = names + out * name_stride;
    if (r->format == 0) {
      int n = r->getline(line, line_cap);
      if (n < 0) break;
      if (n == 0) continue;
      if (line[0] == '>') {
        r->format = 1;
        flags[0] = 0;
        store_name(r->pending_name, sizeof(r->pending_name), line + 1, n - 1);
        r->has_pending = true;
      } else if (line[0] == '@') {
        r->format = 2;
        store_name(nrow, (int)name_stride, line + 1, n - 1);
        goto fastq_body;
      } else {
        return -1;
      }
      continue;
    }
    if (r->format == 1) {
      // FASTA: pending header -> sequence lines until next '>' or EOF
      if (!r->has_pending) break;
      {
        strncpy(nrow, r->pending_name, name_stride - 1);
        nrow[name_stride - 1] = 0;
        r->has_pending = false;
        int64_t sl = 0;
        memset(crow, 0, maxlen);
        memset(qrow, 0, maxlen);
        for (;;) {
          int n = r->getline(line, line_cap);
          if (n < 0) break;
          if (n == 0) continue;
          if (line[0] == '>') {
            store_name(r->pending_name, sizeof(r->pending_name),
                       line + 1, n - 1);
            r->has_pending = true;
            break;
          }
          for (int i = 0; i < n; i++) {
            if (sl < maxlen) {
              crow[sl] = kCode[(unsigned char)line[i]];
            } else {
              flags[1] = 1;
            }
            sl++;
          }
        }
        lens[out] = (int32_t)(sl < maxlen ? sl : maxlen);
        out++;
      }
      continue;
    }
    // FASTQ
    {
      int n = r->getline(line, line_cap);
      if (n < 0) break;
      if (n == 0) continue;
      if (line[0] != '@') return -1;
      store_name(nrow, (int)name_stride, line + 1, n - 1);
    }
  fastq_body: {
      int n = r->getline(line, line_cap);
      if (n < 0) return -1;
      int64_t sl = n < maxlen ? n : maxlen;
      if (n > maxlen) flags[1] = 1;
      memset(crow, 0, maxlen);
      for (int64_t i = 0; i < sl; i++)
        crow[i] = kCode[(unsigned char)line[i]];
      lens[out] = (int32_t)sl;
      if (r->getline(line, line_cap) < 0) return -1;  // '+'
      int qn = r->getline(line, line_cap);
      if (qn < 0) return -1;
      memset(qrow, 0, maxlen);
      int64_t ql = qn < maxlen ? qn : maxlen;
      memcpy(qrow, line, ql);
      out++;
    }
  }
  flags[0] = (r->format != 1);
  return r->err ? -1 : out;
}

}  // extern "C"
