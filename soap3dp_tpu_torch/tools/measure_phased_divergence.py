"""A/B the phased BWT search against the single-phase search: the
port's copy of parse_records, run_ab and divergence from the repo's
tools/measure_phased_divergence.py, over soap3dp_tpu_torch's pipeline.

The phased scheme (segments {0,1} first, escalate unresolved pairs;
pipeline/pair.py _phase1_range, the analog of the reference's staged
phases in alignment.cu:1119-1236) can resolve a pair in phase 1 with a
complete best-score hit set but an INCOMPLETE suboptimal set, so X1 can
undercount and MAPQ can read high for phase-1-resolved pairs. run_ab
aligns the same pairs with phased_search on and off and divergence
counts the records that differ in each SAM field.

The JAX package's command line (its main) reads that package's cached
bench index and has no counterpart here; tests/test_torch_phased.py
drives these functions on the CPU.
"""

from __future__ import annotations

import io

from soap3dp_tpu_torch.io.sam import SamWriter
from soap3dp_tpu_torch.pipeline.options import AlignOptions
from soap3dp_tpu_torch.pipeline.pair import (Phase2Queue, RescueQueue,
                                             align_pair_batch,
                                             dispatch_pair_search)


def parse_records(sam_bytes: bytes) -> dict:
    """(qname, end) -> (pos, mapq, cigar, flag, X0, X1, XA)."""
    recs = {}
    for line in sam_bytes.decode().splitlines():
        if line.startswith("@"):
            continue
        f = line.split("\t")
        tags = dict(t.split(":", 2)[::2] for t in f[11:])
        key = (f[0], int(f[1]) & 0xC0)
        recs[key] = {
            "pos": int(f[3]), "mapq": int(f[4]), "cigar": f[5],
            "flag": int(f[1]), "x0": tags.get("X0"), "x1": tags.get("X1"),
            "xa": tags.get("XA"),
        }
    return recs


def run_ab(index, didx, b1, b2, opts_kw: dict) -> tuple[dict, dict]:
    """Align the same batch twice (phased on/off); return both record
    maps. Runs on the device of ``didx``."""
    out = {}
    for phased in (True, False):
        opts = AlignOptions(phased_search=phased, **opts_kw)
        buf = io.BytesIO()
        w = SamWriter(buf, index)
        rq = RescueQueue(index, didx, opts)
        p2q = Phase2Queue(index, didx, opts)
        pend = dispatch_pair_search(didx, b1, b2, opts)
        align_pair_batch(index, didx, b1, b2, opts, w,
                         pending_search=pend, rescue_queue=rq,
                         phase2_queue=p2q)
        p2q.process(w, rq)
        rq.flush(w)
        out[phased] = parse_records(buf.getvalue())
    return out[True], out[False]


def divergence(a: dict, b: dict) -> dict:
    keys = set(a) | set(b)
    n = max(len(keys), 1)
    miss = sum(1 for k in keys if k not in a or k not in b)
    fields = ("pos", "mapq", "cigar", "flag", "x0", "x1", "xa")
    diff = {f: 0 for f in fields}
    any_diff = 0
    for k in keys:
        if k not in a or k not in b:
            any_diff += 1
            continue
        d = False
        for f in fields:
            if a[k][f] != b[k][f]:
                diff[f] += 1
                d = True
        any_diff += d
    return {
        "records": len(keys), "missing_either": miss,
        "any_field_rate": round(any_diff / n, 6),
        **{f + "_rate": round(diff[f] / n, 6) for f in fields},
    }
