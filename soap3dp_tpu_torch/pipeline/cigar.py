"""CIGAR / NM / MD assembly from DP traceback runs (port of
soap3dp_tpu/pipeline/cigar.py; numpy, with the port's OP_* codes).

The analog of the reference's CigarStringEncoder + MD computation
(DV-DPfunctions.h:514-646; getMdStr, PE.h:71-79). The DP engine emits
right-to-left run-length op lists (see kernels/banded_dp.py); this
module renders them as SAM CIGAR strings and computes NM (edit
distance: mismatches + inserted + deleted bases) and MD strings by
replaying the alignment against the window codes.
"""

from __future__ import annotations

import numpy as np

from soap3dp_tpu_torch.kernels.banded_dp import (
    OP_CLIP, OP_DEL, OP_INS, OP_MATCH, OP_MISMATCH)
from soap3dp_tpu_torch.utils import dna

_SAM_OP = {OP_MATCH: "M", OP_MISMATCH: "M", OP_INS: "I", OP_DEL: "D",
           OP_CLIP: "S"}


def runs_to_cigar(ops: np.ndarray, cnts: np.ndarray, nrun: int) -> str:
    """Right-to-left runs -> left-to-right CIGAR (M collapses m/M)."""
    out: list[str] = []
    last_op, last_n = None, 0
    for r in range(nrun - 1, -1, -1):
        if cnts[r] == 0:
            continue
        op = _SAM_OP[int(ops[r])]
        if op == last_op:
            last_n += int(cnts[r])
        else:
            if last_op is not None:
                out.append(f"{last_n}{last_op}")
            last_op, last_n = op, int(cnts[r])
    if last_op is not None:
        out.append(f"{last_n}{last_op}")
    return "".join(out)


def runs_stats(ops: np.ndarray, cnts: np.ndarray, nrun: int) -> tuple[int, int, int, int]:
    """(NM, #mismatches, #gap-opens, #gap-extends) from the runs."""
    nm = mis = go = ge = 0
    for r in range(nrun):
        n, op = int(cnts[r]), int(ops[r])
        if op == OP_MISMATCH:
            nm += n
            mis += n
        elif op in (OP_INS, OP_DEL):
            nm += n
            go += 1
            ge += n - 1
    return nm, mis, go, ge


def runs_to_md(ops: np.ndarray, cnts: np.ndarray, nrun: int,
               win_codes: np.ndarray, start_j: int) -> str:
    """MD:Z string: replay the alignment over the window from start_j.

    MD covers aligned (M/D) columns only; insertions and clips are
    skipped, deletions appear as ^<bases>.
    """
    md: list[str] = []
    run = 0
    j = int(start_j)
    for r in range(nrun - 1, -1, -1):
        n, op = int(cnts[r]), int(ops[r])
        if n == 0:
            continue
        if op == OP_MATCH:
            run += n
            j += n
        elif op == OP_MISMATCH:
            for _ in range(n):
                md.append(str(run))
                md.append(chr(dna.CODE_TO_CHAR[win_codes[j]]))
                run = 0
                j += 1
        elif op == OP_DEL:
            md.append(str(run))
            run = 0
            md.append("^" + "".join(chr(dna.CODE_TO_CHAR[c])
                                    for c in win_codes[j:j + n]))
            j += n
        # OP_INS / OP_CLIP consume no window columns
    md.append(str(run))
    return "".join(md)
