"""soap3dp-torch view: decode succinct binary output to text.

The BGS-View / BGS-View-PE equivalent (BGS-View.cpp:65-165).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="soap3dp-torch view",
                                 description="decode .gout succinct output")
    ap.add_argument("gout")
    args = ap.parse_args(argv)

    from soap3dp_tpu_torch.io.succinct import read_succinct

    names, lens, records = read_succinct(args.gout)
    print(f"# {len(names)} sequences", file=sys.stderr)
    for qname, flag, chrom, pos, mapq, cig, nm in records:
        rname = names[chrom] if chrom >= 0 else "*"
        print(f"{qname.decode()}\t{flag}\t{rname}\t{pos + 1}\t{mapq}\t"
              f"{cig or '*'}\t{nm}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
