"""ctypes loader for the native columnar SAM formatter
(csrc/host/sam_format.cpp), the analog of the reference's hand-rolled
record assembly (BGS-IO.cpp:2131-2273). Builds with g++ on first use;
SamWriter.write_block falls back to the vectorized numpy assembly when
unavailable (or when SOAP3DP_NO_NATIVE is set).
"""

from __future__ import annotations

import ctypes
import os
import sys
import threading

import numpy as np

from soap3dp_tpu_torch.utils.nativebuild import BUILD_DIR, SRC_DIR, build_native_lib

_lock = threading.Lock()
_lib = None
_tried = False

_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("SOAP3DP_NO_NATIVE"):
            return None
        src = os.path.join(SRC_DIR, "sam_format.cpp")
        so = os.path.join(BUILD_DIR, "libsamformat.so")
        if not os.path.exists(src):
            return None
        if not build_native_lib(src, so, "sam formatter", "numpy assembly"):
            return None
        lib = ctypes.CDLL(so)
        lib.sam_format_block.restype = ctypes.c_int64
        lib.sam_format_block.argtypes = [
            ctypes.c_int64,                       # n
            _U8P, _I64P, ctypes.c_int64,          # names, name_off, name_w
            _I64P,                                # flags
            _U8P, _I64P,                          # rnames, rname_off
            _I64P, _I64P, _I64P,                  # chroms, poss, mapqs
            _U8P, _I64P, ctypes.c_int32,          # cigars, cigar_off, gapless
            ctypes.c_int32, _I64P, _I64P, _I64P,  # has_mate, mc, mp, tlen
            ctypes.c_int32, ctypes.c_int64,       # has_seq, L
            _U8P, _I64P,                          # seq_codes, seq_lens
            ctypes.c_int32, _U8P,                 # has_qual, quals
            _U8P, _U8P, _I64P, ctypes.c_int64,    # seq2, quals2, seq_src, L2
            ctypes.c_int32, _I64P, _I64P, _I64P,  # has_tags, x0, x1, xm
            _I64P, _I64P,                         # xa_off, xa_ent
            _U8P, ctypes.c_int64]                 # out, out_cap
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _concat_with_offsets(items) -> tuple[np.ndarray, np.ndarray]:
    """bytes sequence -> (flat uint8 buffer, int64 offsets, length n+1).

    Fixed-width numpy 'S' arrays take a fully vectorized path (one
    masked ragged copy); lists of bytes fall back to a Python join."""
    a = np.asarray(items) if not isinstance(items, np.ndarray) else items
    if a.dtype.kind == "S":
        W = a.dtype.itemsize
        lens = np.char.str_len(a).astype(np.int64)
        off = np.zeros(len(a) + 1, np.int64)
        np.cumsum(lens, out=off[1:])
        m = np.ascontiguousarray(a).view(np.uint8).reshape(len(a), W)
        buf = m[np.arange(W, dtype=np.int64)[None, :] < lens[:, None]]
        return buf, off
    off = np.zeros(len(items) + 1, np.int64)
    np.cumsum(np.fromiter((len(x) for x in items), np.int64,
                          count=len(items)), out=off[1:])
    buf = np.frombuffer(b"".join(items), np.uint8) if off[-1] \
        else np.zeros(0, np.uint8)
    return buf, off


def _p64(a):
    return a.ctypes.data_as(_I64P)


def _p8(a):
    return a.ctypes.data_as(_U8P)


def format_block(names, flags, rname_buf, rname_off, chroms, poss, mapqs,
                 cigars, mate_chroms, mate_poss, tlens, seq_codes, seq_lens,
                 quals, tags, seq_src=None, xa=None) -> memoryview | None:
    """SAM text for a columnar block, or None when native is unavailable.

    rname_buf/rname_off are the writer's precomputed chrom-name table;
    everything else mirrors SamWriter.write_block's arguments. Returns a
    memoryview over a freshly allocated buffer (no extra copy; the
    caller hands it straight to file.write).

    Hot-path forms (VERDICT r3 #4 — the sam_out serialization tax):
      * names as a numpy 'S' array go to C as the fixed-width buffer
        itself (NUL-trim in C), skipping the ragged concat
      * cigars=None means gapless "<seq_len>M" formatted in C
      * seq_codes/quals may each be a (mate1, mate2) matrix pair with
        seq_src giving per-record rows (src >= 0 -> mate1[src],
        src < 0 -> mate2[~src]) so PE blocks skip the interleave copy
      * xa = (off, chrom, strand, pos, nm): each record's XA alternates
        as a CSR group (SamWriter.write_block), formatted in C
    """
    lib = _load()
    if lib is None:
        return None
    n = len(names)
    nm = names if isinstance(names, np.ndarray) else np.asarray(names)
    if nm.dtype.kind == "S" and nm.dtype.itemsize > 0:
        name_w = nm.dtype.itemsize
        name_buf = np.ascontiguousarray(nm).view(np.uint8)
        name_off = None
        name_total = n * name_w  # upper bound for the cap estimate
    else:
        name_w = 0
        name_buf, name_off = _concat_with_offsets(names)
        name_total = int(name_off[-1])
    if cigars is not None:
        if not (isinstance(cigars, np.ndarray) and cigars.dtype.kind == "S"):
            cigars = [c if isinstance(c, bytes) else c.encode()
                      for c in cigars]
        cig_buf, cig_off = _concat_with_offsets(cigars)
    else:
        cig_buf, cig_off = np.zeros(0, np.uint8), None

    def i64(a):
        return np.ascontiguousarray(np.asarray(a), np.int64)

    flags = i64(flags)
    chroms = i64(chroms)
    poss = i64(poss)
    mapqs = i64(mapqs)
    has_mate = mate_chroms is not None
    mc = i64(mate_chroms) if has_mate else flags
    mp = i64(mate_poss) if has_mate else flags
    tl = i64(tlens) if has_mate else flags
    has_seq = seq_codes is not None
    two_src = has_seq and isinstance(seq_codes, tuple)
    if two_src and seq_src is None:
        # without row-picking indices the second matrix would be read
        # at rows >= n/2 out of bounds in the C path (ADVICE r4)
        raise ValueError("tuple seq_codes requires seq_src")
    seq2 = np.zeros((0, 0), np.uint8)
    qual2 = np.zeros(0, np.uint8)
    L2 = 0
    src_a = None
    if two_src:
        seq_codes, seq2 = (np.ascontiguousarray(m, np.uint8)
                           for m in seq_codes)
        L, L2 = seq_codes.shape[1], seq2.shape[1]
        seq_lens = i64(seq_lens)
    elif has_seq:
        seq_codes = np.ascontiguousarray(seq_codes, np.uint8)
        L = seq_codes.shape[1]
        seq_lens = i64(seq_lens)
    else:
        seq_codes = np.zeros((0, 0), np.uint8)
        L = 0
        # an XA entry's cigar is its record's length, with or without SEQ
        seq_lens = flags if seq_lens is None else i64(seq_lens)
    if has_seq and seq_src is not None:
        src_a = i64(seq_src)
    has_qual = quals is not None
    if has_qual and two_src:
        qual_a, qual2 = (np.ascontiguousarray(m, np.uint8) for m in quals)
    elif has_qual:
        qual_a = np.ascontiguousarray(quals, np.uint8)
    else:
        qual_a = np.zeros(0, np.uint8)
    has_tags = tags is not None
    if has_tags:
        x0, x1, xm = (i64(t) for t in tags)
    else:
        x0 = x1 = xm = flags

    rn = np.asarray(rname_off)
    rn_max = int((rn[1:] - rn[:-1]).max()) if len(rn) > 1 else 1
    cap = name_total + int(cig_off[-1] if cig_off is not None else 22 * n) \
        + n * (2 * max(L, L2) + 2 * max(rn_max, 1) + 170)
    xa_off = xa_ent = None
    if xa is not None:
        xa_off = i64(xa[0])
        xa_ent = np.ascontiguousarray(np.stack([i64(a) for a in xa[1:]],
                                               axis=1))
        cap += len(xa_ent) * (rn_max + 80)
    out = np.empty(cap, np.uint8)
    written = lib.sam_format_block(
        n, _p8(name_buf),
        _p64(name_off) if name_off is not None else None, name_w,
        _p64(flags), _p8(rname_buf), _p64(rname_off),
        _p64(chroms), _p64(poss), _p64(mapqs),
        _p8(cig_buf), _p64(cig_off) if cig_off is not None else None,
        1 if cigars is None else 0,
        1 if has_mate else 0, _p64(mc), _p64(mp), _p64(tl),
        1 if has_seq else 0, L, _p8(seq_codes), _p64(seq_lens),
        1 if has_qual else 0, _p8(qual_a),
        _p8(seq2), _p8(qual2),
        _p64(src_a) if src_a is not None else None, L2,
        1 if has_tags else 0, _p64(x0), _p64(x1), _p64(xm),
        _p64(xa_off) if xa is not None else None,
        _p64(xa_ent) if xa is not None else None,
        _p8(out), cap)
    if written < 0:
        return None  # capacity miss: numpy fallback handles it
    return memoryview(out.data)[:written]
