"""soap3dp-torch build: FASTA -> index.

One step replaces the reference's two-stage build (soap3-dp-builder ->
2BWT index files, then BGS-Build -> GPU occ tables; README.md section
2.1): the index layout is emitted directly, the same on-disk format as
soap3dp-builder's (soap3dp_tpu/cli/builder.py), so an index built by
either package loads in both. Index lands in <fasta>.index.t3i/ so
aligner invocations take "<fasta>.index" exactly like the reference.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="soap3dp-torch build",
        description="Build the 2BWT/FM index from a FASTA file")
    ap.add_argument("fasta", help="reference FASTA (plain or .gz)")
    ap.add_argument("--sa-rate", type=int, default=8,
                    help="SA sampling rate (power of 2; the reference's "
                         "SaValueFreq analog — smaller = faster decode, "
                         "more memory)")
    ap.add_argument("--lut-k", type=int, default=None,
                    help="k-mer lookup table depth (default: auto)")
    ap.add_argument("--ini", default=None,
                    help="builder ini (soap3-dp-builder.ini analog: "
                         "SaValueFreq key)")
    ap.add_argument("--no-resume", action="store_true",
                    help="discard any partial build state and start clean "
                         "(by default an interrupted build resumes after "
                         "its last completed stage)")
    args = ap.parse_args(argv)

    # layered config like the reference: ini then argv
    import configparser
    import os
    ini = args.ini or (os.path.exists("soap3-dp-builder.ini")
                       and "soap3-dp-builder.ini")
    if ini:
        cp = configparser.ConfigParser(inline_comment_prefixes=("#", ";"))
        cp.read(ini)
        try:
            args.sa_rate = cp.getint("BuildIndex", "SaValueFreq")
        except (configparser.Error, ValueError):
            pass

    from soap3dp_tpu_torch.index.builder import build_index_to
    from soap3dp_tpu_torch.index.packing import pack_fasta

    t0 = time.time()
    print(f"[builder] parsing {args.fasta}", file=sys.stderr)
    try:
        genome = pack_fasta(args.fasta)
    except (FileNotFoundError, IsADirectoryError, PermissionError,
            ValueError) as e:
        print(f"[builder] error: {e}", file=sys.stderr)
        return 1
    print(f"[builder] {genome.length} bp in {len(genome.names)} sequence(s); "
          f"building index", file=sys.stderr)
    out = f"{args.fasta}.index.t3i"
    # per-stage checkpointed build: an interrupted whole-genome build
    # (hour-class) resumes instead of restarting (SURVEY.md section 5)
    build_index_to(genome, out, sa_rate=args.sa_rate, lut_k=args.lut_k,
                   resume=not args.no_resume)
    print(f"[builder] wrote {out} in {time.time() - t0:.1f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
