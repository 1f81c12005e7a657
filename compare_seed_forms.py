"""FS1, FS2s and FS3 of several builds of csrc/fm_search.cu on the same
inputs.

    python3 compare_seed_forms.py [--start-arrays SRC] [SRC ...]

Each SRC is a version of soap3dp_tpu_torch/csrc/fm_search.cu with this
checkout's C interface (a lane's seed made in the kernels from
fmindex.SeedLanes, FS3's placements as the dedupe hands them over);
none: this checkout's own. ``--start-arrays`` names a version whose FS1
and FS2s take (lanes,) start and length arrays and whose FS3 takes
clamped rows, masked positions and a length a placement instead (the
port before its seeds were made in the kernels), fed the plain
versions' SeedLanes.bounds and the same prep in plain torch. Each is
built with nvcc (its registers from ptxas) and timed by torch.profiler
device events (chip_smoke._kernel_device_ms, 100 calls), the builds in
order, then in reverse, twice, so each gets four times, on a 50 Mbp
random genome's index (sa_rate 2, lut_k 13):

- fs1_seed: the DP seeding's largest call, 6,728 reads of 100 bases,
  the halved deep-DP seeds (107,648 lanes, S 8), 13 steps, general
  branch; staged seeds, and the same seeds given as start and length
  arrays (``_given``);
- fs2s_seed: its expansion into 524,288 slots (staged and given);
- fs1_round1: the search's round 1, 131,072 packed reads, pigeonhole
  segments 0-1 of 3 truncated to 16 bases (524,288 lanes), 3 steps;
- fs3_round1: 262,144 placements of those reads over 8 words, rows
  drawn over both strands, a tenth of them not valid (the sentinel row,
  as the dedupe leaves its slots past uniq).

Every call is held to its plain version, every element. Prints one line
a case and writes compare_seed_forms.json in chip_smoke.py's output
directory; exits non-zero if a call disagrees. Needs a card.
"""

import argparse
import ctypes
import json
import os
import re
import sys

import numpy as np


def registers(log: str) -> dict:
    """{FS1 / FS2s / FS3 kernel (mangled): registers} from a ptxas -v
    log."""
    out = {}
    for chunk in log.split("Compiling entry function '")[1:]:
        name = chunk.split("'", 1)[0]
        m = re.search(r"Used (\d+) registers", chunk)
        if m and any(k in name for k in ("fm_search_kernel",
                                         "seed_expand_kernel",
                                         "verify_kernel")):
            out[name] = int(m.group(1))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--start-arrays", default=None)
    ap.add_argument("srcs", nargs="*")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from soap3dp_tpu_torch import workloads
    from soap3dp_tpu_torch.fm import fmindex as tf
    from soap3dp_tpu_torch.fm.search import pack_read_matrix
    from soap3dp_tpu_torch.index.builder import build_index
    from soap3dp_tpu_torch.kernels import fm_search as fs
    from soap3dp_tpu_torch.kernels.cudalib import CudaKernel, CudaLibrary
    from soap3dp_tpu_torch.pipeline import dp_rescue

    if not torch.cuda.is_available():
        sys.exit("compare_seed_forms.py needs a card")
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    srcs = [os.path.abspath(s) for s in args.srcs] or [fs.FM_SEARCH_LIB.src]
    labels = [os.path.splitext(os.path.basename(s))[0] for s in srcs]
    regs, kern = {}, {}
    for label, src in zip(labels, srcs):
        lib = CudaLibrary("fm_search.cu")
        lib.src = src
        lib.load()
        regs[label] = registers(lib.build_log)
        kern[label] = (CudaKernel(lib, "soap3dp_fm_search",
                                  fs.SEARCH_KERNEL.argtypes),
                       CudaKernel(lib, "soap3dp_seed_expand_decode",
                                  fs.SEED_EXPAND_KERNEL.argtypes),
                       CudaKernel(lib, "soap3dp_verify",
                                  fs.VERIFY_KERNEL.argtypes))
    arrays = None
    if args.start_arrays:
        lib = CudaLibrary("fm_search.cu")
        lib.src = os.path.abspath(args.start_arrays)
        lib.load()
        label = os.path.splitext(os.path.basename(lib.src))[0]
        regs[label] = registers(lib.build_log)
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        arrays = (label,
                  CudaKernel(lib, "soap3dp_fm_search",
                             [P, I, LL, I, I, P, I, P, P, LL, I, I, I]
                             + [P] * 4 + [LL, LL, P, P, P]),
                  CudaKernel(lib, "soap3dp_seed_expand_decode",
                             [P, P, LL, P, I, LL, I] + [P] * 4
                             + [LL, P, LL] + [P] * 5),
                  CudaKernel(lib, "soap3dp_verify",
                             [P, I, LL, I, I] + [P] * 4
                             + [LL, I, P, LL, P, P]))
    for label, r in regs.items():
        print(f"registers {label}: {r}", flush=True)

    rng = np.random.default_rng(3)
    g = workloads.random_genome(rng, 50_000_000, name="chrP")
    didx = tf.device_index(build_index(g, sa_rate=2, lut_k=13), dev)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    B = 6728
    reads, lens = cs.sample_reads(rng, g.codes, B, 120, np.full(B, 100))
    sp, sl = dp_rescue.deep_dp_seed_matrix(lens, 120, halved=True)
    ori = tf.OrientedReads.of(t(reads), t(lens))
    staged = tf.SeedLanes.staged(t(sp), t(sl), t(lens))
    S = sp.shape[1]
    start, length = staged.bounds(S)
    given = tf.SeedLanes.given(start, length)
    B1 = 131072
    reads1, lens1 = cs.sample_reads(rng, g.codes, B1, 120, np.full(B1, 100))
    ori1 = tf.OrientedReads.of(t(pack_read_matrix(reads1).view(np.int32)),
                               t(lens1), 120, 100)
    pig = tf.SeedLanes.pigeonhole(t(lens1), 3, 0, 16)
    st1, ln1 = pig.bounds(2)
    M = 262144
    valid = t(rng.random(M) < 0.9)
    rows = torch.where(valid, t(rng.integers(0, 2 * B1, M)), 0x7FFFFFFF)
    tp = t(rng.integers(0, didx.n - 200, M))
    lens1_t = t(lens1.astype(np.int32))
    l, r = want_seed = tf.seed_intervals_plain(didx, ori, S, staged, 13,
                                               "general")
    incl, total = tf.lane_counts_plain(l, r, 64, S)
    K = 524288
    want = {"fs1_seed": want_seed,
            "fs2s_seed": (tf.seed_expand_plain(didx, l, incl, staged, S, K),),
            "fs1_round1": tf.seed_intervals_plain(didx, ori1, 2, pig, 3,
                                                  "packed"),
            "fs3_round1": (tf.count_mismatches_rows_plain(
                didx, tp, ori1, rows, lens1_t, valid),)}
    print(f"seeding {start.shape[0]} lanes, S {S}, {int(total)} slots of "
          f"{K} walked; round 1 {st1.shape[0]} lanes", flush=True)

    def ours(label, fn, *a):
        def call():
            fs.SEARCH_KERNEL, fs.SEED_EXPAND_KERNEL, fs.VERIFY_KERNEL = \
                kern[label]
            out = getattr(fs, fn)(*a)
            return out if isinstance(out, tuple) else (out,)
        return call

    def theirs_search(o, S_, st, ln, steps, mode):
        def call():
            src = o.source()
            rc = o.rc_lengths()
            N = st.shape[0]
            lo = torch.empty(N, dtype=torch.int64, device=dev)
            hi = torch.empty(N, dtype=torch.int64, device=dev)
            _, fn = arrays[1].function()
            err = fn(src.data.data_ptr(), src.kind, src.B, src.L, src.W,
                     rc.data_ptr(), S_, st.data_ptr(), ln.data_ptr(), N,
                     fs.MODES[mode], steps, didx.lut_k,
                     didx.occ_blocks.data_ptr(), didx.counts.data_ptr(),
                     didx.lut_lo.data_ptr(), didx.lut_hi.data_ptr(),
                     didx.primary, didx.n + 1, lo.data_ptr(), hi.data_ptr(),
                     fs._stream(dev))
            if err:
                raise RuntimeError(f"FS1 launch failed: {err}")
            return lo, hi
        return call

    def theirs_expand():
        words = torch.empty(3 * K, dtype=torch.int32, device=dev)
        _, fn = arrays[2].function()
        err = fn(l.data_ptr(), incl.data_ptr(), l.shape[0],
                 start.data_ptr(), S, K, didx.sa_rate,
                 didx.mark_words.data_ptr(), didx.mark_rank.data_ptr(),
                 didx.occ_blocks.data_ptr(), didx.counts.data_ptr(),
                 didx.primary, didx.sa_samples.data_ptr(),
                 didx.sa_samples.shape[0], words.data_ptr(), None, None,
                 None, fs._stream(dev))
        if err:
            raise RuntimeError(f"FS2s launch failed: {err}")
        return (words,)

    def theirs_verify():
        src = ori1.source()
        rc = ori1.rc_lengths()
        rc_rows = rows.clamp(0, 2 * B1 - 1)
        tp0 = torch.where(valid, tp, 0)
        read_len = lens1_t.long()[rc_rows % B1]
        out = torch.empty(M, dtype=torch.int64, device=dev)
        _, fn = arrays[3].function()
        err = fn(src.data.data_ptr(), src.kind, src.B, src.L, src.W,
                 rc.data_ptr(), rc_rows.data_ptr(), tp0.data_ptr(),
                 read_len.data_ptr(), M, 8, didx.pac.data_ptr(),
                 didx.pac.shape[0], out.data_ptr(), fs._stream(dev))
        if err:
            raise RuntimeError(f"FS3 launch failed: {err}")
        return (out,)

    cases = {"fs1_seed": {}, "fs2s_seed": {}, "fs1_round1": {},
             "fs3_round1": {}}
    if arrays:
        cases["fs1_seed"][arrays[0]] = theirs_search(ori, S, start, length,
                                                     13, "general")
        cases["fs2s_seed"][arrays[0]] = theirs_expand
        cases["fs1_round1"][arrays[0]] = theirs_search(ori1, 2, st1, ln1, 3,
                                                       "packed")
        cases["fs3_round1"][arrays[0]] = theirs_verify
    for label in labels:
        for tag, seeds in (("", staged), ("_given", given)):
            cases["fs1_seed"][label + tag] = ours(
                label, "search", didx, ori.source(), S, seeds, 13, "general")
            cases["fs2s_seed"][label + tag] = ours(
                label, "seed_expand_decode", didx, l, incl,
                seeds if tag == "" else tf.SeedLanes.given(start), S, K)
        cases["fs1_round1"][label] = ours(label, "search", didx,
                                          ori1.source(), 2, pig, 3, "packed")
        cases["fs3_round1"][label] = ours(label, "verify", didx,
                                          ori1.source(), rows, tp, valid,
                                          lens1_t, 8)
    symbol = {"fs1_seed": "fm_search_kernel",
              "fs2s_seed": "seed_expand_kernel",
              "fs1_round1": "fm_search_kernel",
              "fs3_round1": "verify_kernel"}
    out = {"card": card, "registers": regs, "cases": {}}
    bad = []
    for case, fns in cases.items():
        res = {n: [] for n in fns}
        order = list(fns) + list(fns)[::-1]
        for n in order + order:
            got = fns[n]()
            if not all(torch.equal(a, b) for a, b in zip(got, want[case])):
                bad.append((case, n))
            res[n].append(cs._kernel_device_ms(fns[n], 100, symbol[case]))
        out["cases"][case] = res
        print(case + " | " + " | ".join(
            f"{n} " + ", ".join(f"{x:.5f}" for x in v)
            for n, v in res.items()), flush=True)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "compare_seed_forms.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    if bad:
        sys.exit(f"calls that disagree with their plain versions: {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
