"""Batched semi-global affine-gap DP: forward, traceback, CIGAR runs.

Port of soap3dp_tpu/kernels/banded_dp.py (``dp_align``, ``dp_forward``,
``dp_traceback``). Two implementations of each function:

* CUDA tensors: hand-written Hopper kernels, built with nvcc at first
  use into ``_build/`` and loaded with ctypes (see each source note).
  K1, ``csrc/banded_dp.cu``, replaces the TPU kernel
  ``_dp_align_pallas_kernel`` (soap3dp_tpu/kernels/banded_dp.py:606):
  forward, traceback and CIGAR runs in one launch, each run one packed
  word. K2 and TB, ``csrc/dp_forward.cu``, replace
  ``_dp_forward_pallas_kernel`` (:238) and the traceback sweep + host
  RLE that consume its directions (:409-600); ``dp_align`` takes them
  where the reference does (windows of FUSED_MAX_WINDOW and more, reads
  of at most 127), K1 elsewhere. DW, ``csrc/dp_wire.cu``, ends either
  route: the call's result wire (header, stats rows, the passing lanes'
  runs at their exact length), which the host downloads in two copies
  and ``parse_wire`` turns into dp_align's tuple, in place of the
  reference's ``_gather_runs_u16`` (:932) and the host code around it
  (:1000-1015).
* CPU tensors: the plain-torch version — the anti-diagonal forward of
  the reference's ``_dp_forward_scan``, its reverse traceback sweep and
  the host run-length encoding ``_rle_runs``, then the same wire
  (``dp_wire_plain``) and parse.

Each function takes a kernel for a CUDA tensor (or raises) and the
plain version for a CPU tensor, and nothing else: there is no fallback
from one to the other.

Recurrences (cells on anti-diagonal d = i + j depend on d-1 and d-2):

    H[i,j] = max(H[i-1,j-1] + subst, D[i,j], I[i,j])
    D[i,j] = max(H[i,j-1] + open, D[i,j-1] + ext)          # window gap
    I[i,j] = max(H[i-1,j] + open, I[i-1,j] + ext, fresh)   # read gap
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import warnings

import numpy as np
import torch

from soap3dp_tpu_torch.kernels import fm_search as fs
from soap3dp_tpu_torch.kernels.cudalib import CudaKernel, CudaLibrary

NEG = -32000          # DP_SCORE_NEG_INFINITY (DV-DPfunctions.cu:52)
NEG_BIG = -(1 << 20)  # masking value, far below any reachable score

# direction encodings
DH_DIAG, DH_D, DH_SM, DH_I = 0, 1, 2, 3
DD_OPEN, DD_EXT = 0, 1
DI_FRESH, DI_OPEN, DI_EXT = 0, 1, 2

# traceback op codes
OP_NONE, OP_MATCH, OP_MISMATCH, OP_INS, OP_DEL, OP_CLIP = 0, 1, 2, 3, 4, 5

@dataclasses.dataclass(frozen=True)
class DPScores:
    """Scoring scheme (soap3-dp.ini [DP]: 1 / -2 / -3 / -1 defaults)."""

    match: int = 1
    mismatch: int = -2
    gap_open: int = -3   # cost of a length-1 gap
    gap_ext: int = -1

    @property
    def gap_init(self) -> int:
        return self.gap_open - self.gap_ext


# ------------------------------------------------------------------
# Plain torch version
# ------------------------------------------------------------------

def _clamp(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(min=NEG)


def _shift(v: torch.Tensor) -> torch.Tensor:
    """v[..., i] -> v[..., i-1]; lane 0 filled with NEG_BIG."""
    return torch.cat([torch.full_like(v[:, :1], NEG_BIG), v[:, :-1]], dim=1)


def _dp_forward_scan(reads, rlens, wins, wlens, clip_l, clip_r, anchor_l,
                     anchor_r, sc: DPScores = DPScores()):
    """Anti-diagonal forward DP. Returns (best_score, hit_i, hit_j,
    count, dirs) with dirs (Lr+Lw, P, Lr+1) uint8, diag-major: the
    direction byte of each cell (bits 0-1 H, 2 D, 3-4 I, 5 match)."""
    P, Lr = reads.shape
    Lw = wins.shape[1]
    dev = reads.device
    i32 = torch.int32
    m, mm, go, ge, gi = (sc.match, sc.mismatch, sc.gap_open, sc.gap_ext,
                         sc.gap_init)
    i_vec = torch.arange(Lr + 1, dtype=i32, device=dev)[None, :]
    reads_pad = torch.cat([torch.zeros((P, 1), dtype=i32, device=dev),
                           reads.to(i32)], dim=1)
    wins_i = wins.to(i32)
    rlens = rlens.to(i32)[:, None]
    wlens = wlens.to(i32)[:, None]
    clip_l = clip_l.to(i32)[:, None]
    clip_r = clip_r.to(i32)[:, None]
    anchor_l = anchor_l.to(i32)[:, None]
    anchor_r = anchor_r.to(i32)[:, None]

    col0_raw = torch.where(
        i_vec == 0, 0,
        torch.where(i_vec <= clip_l, go,
                    gi + ge * (i_vec - torch.minimum(clip_l, i_vec))))
    col0_H = _clamp(col0_raw)
    col0_D = _clamp(col0_raw + gi)

    full = torch.full((P, Lr + 1), NEG_BIG, dtype=i32, device=dev)
    H1 = full.clone()
    H1[:, 0] = 0
    H2 = full.clone()
    D1 = full.clone()
    D1[:, 0] = max(gi, NEG)
    I1 = full.clone()
    chars = torch.full((P, Lr + 1), -1, dtype=i32, device=dev)
    bS = torch.full((P,), NEG, dtype=i32, device=dev)
    bJ = torch.zeros(P, dtype=i32, device=dev)
    bI = torch.zeros(P, dtype=i32, device=dev)
    bC = torch.zeros(P, dtype=i32, device=dev)
    ND = Lr + Lw
    dirs = torch.empty((ND, P, Lr + 1), dtype=torch.uint8, device=dev)
    fresh_ok = (i_vec - 1) <= clip_l
    is_lane0 = i_vec == 0
    row_ok = (i_vec >= 1) & (i_vec <= rlens) & (i_vec >= rlens - clip_r)

    for d in range(1, ND + 1):
        j_vec = d - i_vec
        newc = wins_i[:, min(d - 1, Lw - 1)]
        chars = torch.cat([newc[:, None], chars[:, :-1]], dim=1)
        init_j = torch.where(j_vec < anchor_l, 0, NEG)
        init_jm1 = torch.where(j_vec - 1 < anchor_l, 0, NEG)
        match = chars == reads_pad
        dist = torch.where(match, m, mm)

        d_open = go + H1
        d_ext = ge + D1
        D_new = _clamp(torch.maximum(d_open, d_ext))
        dD = (d_ext > d_open).to(i32)

        H1s, I1s, H2s = _shift(H1), _shift(I1), _shift(H2)
        i_fresh = torch.where(fresh_ok, init_j + go, NEG_BIG)
        i_open = go + H1s
        i_ext = ge + I1s
        I_new = _clamp(torch.maximum(i_fresh, torch.maximum(i_open, i_ext)))
        dI = torch.where(I_new == i_fresh, DI_FRESH,
                         torch.where(I_new == i_open, DI_OPEN, DI_EXT))

        diag_true = dist + H2s
        diag_fresh = torch.where(fresh_ok, init_jm1 + dist, NEG_BIG)
        H_new = _clamp(torch.maximum(torch.maximum(diag_true, diag_fresh),
                                     torch.maximum(D_new, I_new)))
        dH = torch.where(
            H_new == diag_true, DH_DIAG,
            torch.where((H_new == d_open) | (H_new == d_ext), DH_D,
                        torch.where(H_new == diag_fresh, DH_SM, DH_I)))

        on_col0 = i_vec == d
        H_new = torch.where(on_col0, col0_H, H_new)
        D_new = torch.where(on_col0, col0_D, D_new)
        I_new = torch.where(on_col0, NEG_BIG, I_new)
        H_new = torch.where(is_lane0, _clamp(init_j), H_new)
        D_new = torch.where(is_lane0, NEG_BIG, D_new)
        I_new = torch.where(is_lane0, _clamp(init_j + gi), I_new)

        dirs[d - 1] = (dH | (dD << 2) | (dI << 3)
                       | (match.to(i32) << 5)).to(torch.uint8)

        elig = row_ok & (j_vec >= 1) & (j_vec <= wlens) & (j_vec >= anchor_r)
        escore = torch.where(elig, H_new, NEG_BIG)
        s_star = escore.max(dim=1).values
        tie = escore == s_star[:, None]
        i_star = torch.where(tie, i_vec, -1).max(dim=1).values
        j_star = d - i_star
        c_star = tie.sum(dim=1, dtype=i32)
        better = (s_star > bS) | (
            (s_star == bS) & ((j_star < bJ) | ((j_star == bJ) & (i_star < bI))))
        equal = s_star == bS
        bC = torch.where(better, c_star, torch.where(equal, bC + c_star, bC))
        bS = torch.where(better, s_star, bS)
        bJ = torch.where(better, j_star, bJ)
        bI = torch.where(better, i_star, bI)
        H2, H1, D1, I1 = H1, H_new, D_new, I_new
    return bS, bI, bJ, bC, dirs


def _traceback_scan(dirs, hit_i, hit_j, active):
    """Reverse sweep over diagonals d = ND..1: a problem whose walk sits
    on diagonal d takes its move there. Returns the per-diagonal op
    stream (ND, P) (OP_NONE when idle) and the final walk state."""
    ND, P, Lr1 = dirs.shape
    dev = dirs.device
    i = torch.where(active, hit_i, 0).to(torch.int64)
    j = torch.where(active, hit_j, 0).to(torch.int64)
    state = torch.zeros(P, dtype=torch.int64, device=dev)
    done = ~active
    startj = torch.zeros(P, dtype=torch.int64, device=dev)
    clip = torch.zeros(P, dtype=torch.int64, device=dev)
    opseq = torch.zeros((ND, P), dtype=torch.int8, device=dev)
    rows = torch.arange(P, device=dev)
    for d in range(ND, 0, -1):
        act = ~done & (i > 0) & (j > 0) & (i + j == d)
        if not bool(act.any()):
            continue
        byte = dirs[d - 1, rows, i.clamp(0, Lr1 - 1)].to(torch.int64)
        dH = byte & 3
        dD = (byte >> 2) & 1
        dI = (byte >> 3) & 3
        mop = torch.where(((byte >> 5) & 1) == 1, OP_MATCH, OP_MISMATCH)
        do_diag = act & (state == 0) & (dH == DH_DIAG)
        do_sm = act & (state == 0) & (dH == DH_SM)
        do_d = act & ((state == 1) | ((state == 0) & (dH == DH_D)))
        do_i = act & ((state == 2) | ((state == 0) & (dH == DH_I)))
        i_fresh = do_i & (dI == DI_FRESH)
        op = torch.where(do_diag | do_sm, mop,
                         torch.where(do_d, OP_DEL, OP_INS))
        opseq[d - 1] = torch.where(act, op, OP_NONE).to(torch.int8)
        ni = torch.where(do_diag | (do_i & ~i_fresh), i - 1, i)
        nj = torch.where(do_diag | do_sm | do_d, j - 1, j)
        nstate = torch.where(
            do_d, torch.where(dD == DD_OPEN, 0, 1),
            torch.where(do_i & ~i_fresh, torch.where(dI == DI_OPEN, 0, 2), 0))
        state = torch.where(act, nstate, state)
        exit_now = do_sm | i_fresh
        clip = torch.where(exit_now, i - 1, clip)
        startj = torch.where(do_sm, j - 1, torch.where(i_fresh, j, startj))
        done = done | exit_now
        i = torch.where(act, ni, i)
        j = torch.where(act, nj, j)
    return opseq, (i, j, done, startj, clip)


def _dp_traceback_plain(dirs, rlens, hit_i, hit_j, clip_l, active):
    """Traceback sweep + host run-length encoding (the plain version of
    dp_traceback)."""
    act_t = torch.as_tensor(np.asarray(active), device=dirs.device)
    walk = _traceback_scan(dirs, hit_i.to(dirs.device),
                           hit_j.to(dirs.device), act_t)
    return _walk_runs(walk, rlens, hit_i, clip_l, active)


def _walk_runs(walk, rlens, hit_i, clip_l, active):
    """dp_traceback's outputs from a walk (_traceback_scan's op stream
    and exit state): the exits at the window and read starts, then the
    runs, run-length encoded on the host."""
    opseq, (i, j, done, startj, clip) = walk
    P = opseq.shape[1]
    i, j, done = i.cpu().numpy(), j.cpu().numpy(), done.cpu().numpy()
    startj, clip = startj.cpu().numpy(), clip.cpu().numpy()
    active = np.asarray(active)
    rlens_h = rlens.cpu().numpy().astype(np.int64)
    hit_i_h = hit_i.cpu().numpy().astype(np.int64)
    at_j0 = active & ~done & (j == 0) & (i > 0)
    scl = np.minimum(clip_l.cpu().numpy(), i)
    ins_tail = np.where(at_j0, i - scl, 0)
    clip = np.where(at_j0, scl, clip)
    startj = np.where(at_j0, 0, startj)
    at_i0 = active & ~done & (i == 0)
    startj = np.where(at_i0, j, startj)
    pass_idx = np.flatnonzero(active)
    if len(pass_idx) == 0:
        return (np.zeros((P, 1), np.int32), np.zeros((P, 1), np.int32),
                np.zeros(P, np.int32), startj)
    S = opseq.cpu().numpy().T[pass_idx, ::-1]   # (npass, ND) emission order
    rclip = (rlens_h - hit_i_h)[pass_idx]
    ops_s, cnts_s, nrun_s = _rle_runs(S, rclip, ins_tail[pass_idx],
                                      clip[pass_idx])
    MR = ops_s.shape[1]
    ops = np.zeros((P, MR), np.int32)
    cnts = np.zeros((P, MR), np.int32)
    nrun = np.zeros(P, np.int32)
    ops[pass_idx] = ops_s
    cnts[pass_idx] = cnts_s
    nrun[pass_idx] = nrun_s
    return ops, cnts, nrun, startj


def _rle_runs(S: np.ndarray, rclip: np.ndarray, ins_tail: np.ndarray,
              lclip: np.ndarray):
    """Run-length encode per-problem op streams into dense (P, MR) arrays.

    S is (P, ND) move ops (OP_NONE = idle step); rclip/ins_tail/lclip
    are per-problem counts for the bracketing runs."""
    P, ND = S.shape
    rows_m, cols_m = np.nonzero(S != OP_NONE)
    vals_m = S[rows_m, cols_m].astype(np.int32)
    cnt_m = np.ones(len(rows_m), np.int64)

    def seg(counts, op, segid):
        r = np.flatnonzero(counts > 0)
        return (r, np.full(len(r), segid, np.int8),
                np.zeros(len(r), np.int64),
                np.full(len(r), op, np.int32), counts[r].astype(np.int64))

    r0, s0, p0, v0, c0 = seg(np.asarray(rclip), OP_CLIP, 0)
    r2, s2, p2, v2, c2 = seg(np.asarray(ins_tail), OP_INS, 2)
    r3, s3, p3, v3, c3 = seg(np.asarray(lclip), OP_CLIP, 3)
    rows = np.concatenate([r0, rows_m, r2, r3])
    segs = np.concatenate([s0, np.ones(len(rows_m), np.int8), s2, s3])
    poss = np.concatenate([p0, cols_m, p2, p3])
    vals = np.concatenate([v0, vals_m, v2, v3])
    cnts = np.concatenate([c0, cnt_m, c2, c3])
    order = np.lexsort((poss, segs, rows))
    rows, vals, cnts = rows[order], vals[order], cnts[order]
    if len(rows) == 0:
        return (np.zeros((P, 1), np.int32), np.zeros((P, 1), np.int32),
                np.zeros(P, np.int32))
    change = np.concatenate(
        [[True], (vals[1:] != vals[:-1]) | (rows[1:] != rows[:-1])])
    runid = np.cumsum(change) - 1
    ops_r = vals[change]
    rows_r = rows[change]
    cnts_r = np.bincount(runid, weights=cnts).astype(np.int32)
    nrun = np.bincount(rows_r, minlength=P).astype(np.int32)
    MR = max(int(nrun.max()), 1)
    first = np.concatenate([[0], np.cumsum(nrun)[:-1]])
    col = np.arange(len(ops_r)) - first[rows_r]
    ops = np.zeros((P, MR), np.int32)
    cnts_d = np.zeros((P, MR), np.int32)
    ops[rows_r, col] = ops_r
    cnts_d[rows_r, col] = cnts_r
    return ops, cnts_d, nrun




# ------------------------------------------------------------------
# The runs as words, and the result wire
# ------------------------------------------------------------------

# a (P, 8) int32 problem row: what the kernels read of a problem
PARAM_COLUMNS = ("rlen", "wlen", "clip_l", "clip_r", "anchor_l", "anchor_r",
                 "cutoff")
# the result wire (csrc/dp_wire.cu): a header of WIRE_HEADER int32 words
# (passing lanes, overflowed lanes, run words, the wire's length in int32
# words), each lane's stats row of STATS_WORDS (score, hit_i, hit_j,
# n_best, startj, nrun, overflow, 0), then the passing lanes' runs
WIRE_HEADER, STATS_WORDS = 4, 8
CLIP16 = 4095  # the largest count a 16-bit run word holds


def run_budget(Lr: int, Lw: int) -> int:
    """Runs that hold any alignment of a read of at most Lr bases in a
    window of Lw: the walk's moves lower i + j, so at most Lr + Lw runs
    and the three brackets (right clip, insert tail, left clip); and
    every run but a deletion holds a move that lowers i, or the walk's
    last move, and no two deletion runs touch, so at most 2 (Lr + 1) + 1
    runs and the brackets. The kernels trace each alignment once with
    this budget; none overflows it."""
    return min(Lr + Lw + 4, 2 * Lr + 6)


def word_bits(Lr: int, Lw: int) -> int:
    """The bits of a run word: 16, (op << 12) | count, as the reference
    packs K1's runs, where no count can pass CLIP16 (a count is at most
    the read's or the window's length); else 32, (op << 28) | count."""
    return 16 if max(Lr, Lw) <= CLIP16 else 32


def pack_params(rlens, wlens, clip_l, clip_r, anchor_l, anchor_r,
                cutoff) -> np.ndarray:
    """The kernels' (P, 8) int32 problem rows (PARAM_COLUMNS, then 0),
    packed on the host from arrays or tensors on any device."""
    cols = [np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
            for x in (rlens, wlens, clip_l, clip_r, anchor_l, anchor_r,
                      cutoff)]
    out = np.zeros((len(cols[0]), 8), np.int32)
    for k, c in enumerate(cols):
        out[:, k] = c
    return out


def _run_words(ops, cnts, nrun, MR: int, bits: int):
    """Runs (P, w) -> the kernels' (P, MR) words (int16 for 16 bits,
    int32 for 32; zero past each row's runs), the stored run counts and
    the overflow flags: more than MR runs, or (16 bits) a stored count
    past CLIP16, clamped as the reference clamps it (banded_dp.py:884)."""
    P = len(nrun)
    stored = np.minimum(nrun, MR)
    o = np.zeros((P, MR), np.int64)
    c = np.zeros((P, MR), np.int64)
    k = min(MR, np.shape(ops)[1])
    o[:, :k], c[:, :k] = ops[:, :k], cnts[:, :k]
    valid = np.arange(MR)[None, :] < stored[:, None]
    of = nrun > MR
    if bits == 16:
        of |= ((c > CLIP16) & valid).any(axis=1)
        words = (o << 12) | np.minimum(c, CLIP16)
    else:
        words = (o << 28) | c
    words = np.where(valid, words, 0)
    return (torch.from_numpy(words.astype(np.int16 if bits == 16
                                          else np.int32)),
            stored.astype(np.int32), of)


def _k1_plain(reads, wins, params, MR: int, bits: int,
              sc: DPScores = DPScores()):
    """K1's outputs, plain torch (forward scan, then _k1_words): its
    stats rows (P, 8) int32 (score, hit_i, hit_j, n_best, startj, nrun,
    overflow, 0) and its runs (P, MR) as ``bits``-bit words, the TPU
    kernel's (``_dp_align_pallas_call``'s stats and runs, at budget MR),
    both on the host."""
    col = [params[:, k] for k in range(6)]
    return _k1_words(_dp_forward_scan(reads, col[0], wins, col[1], *col[2:],
                                      sc), params, MR, bits)


def _k1_words(fwd, params, MR: int, bits: int):
    """K1's stats rows and run words from the plain forward's outputs
    (best score, hit_i, hit_j, count, dirs): the traceback sweep and host
    run-length encoding of the lanes that reach their cutoff."""
    bS, bI, bJ, bC, dirs = fwd
    active = (bS >= params[:, 6].to(bS.device)).cpu().numpy()
    ops, cnts, nrun, startj = _dp_traceback_plain(
        dirs, params[:, 0], bI, bJ, params[:, 2], active)
    runs, stored, of = _run_words(ops, cnts, nrun, MR, bits)
    stats = np.stack([bS.cpu().numpy(), bI.cpu().numpy(), bJ.cpu().numpy(),
                      bC.cpu().numpy(), startj, stored, of,
                      np.zeros(len(of))], axis=1).astype(np.int32)
    return torch.from_numpy(stats), runs


def _tb_plain(dirs, params, stats, MR: int):
    """TB's outputs, plain torch: the walks of the problems whose score
    (stats word 0) reaches their cutoff (params word 6) over ``dirs``;
    writes words 4-7 of ``stats`` (host (P, 8) int32: startj, nrun,
    overflow, 0) and returns the runs (P, MR) as 32-bit words."""
    active = (stats[:, 0] >= params[:, 6]).cpu().numpy()
    ops, cnts, nrun, startj = _dp_traceback_plain(
        dirs, params[:, 0], stats[:, 1], stats[:, 2], params[:, 2], active)
    runs, stored, of = _run_words(ops, cnts, nrun, MR, 32)
    stats[:, 4] = torch.from_numpy(np.asarray(startj, np.int64))
    stats[:, 5] = torch.from_numpy(stored)
    stats[:, 6] = torch.from_numpy(of.astype(np.int32))
    stats[:, 7] = 0
    return runs


def dp_wire_plain(params, stats, runs) -> torch.Tensor:
    """DW's plain version: the result wire (int32, on the host) of the
    lanes' stats rows (n, 8), their problem rows (n, 8) (the cutoff in
    word 6) and their runs (n, MR) words (int16: 16-bit words, int32:
    32-bit): the header, the stats, then each passing lane's (score >=
    cutoff, nrun > 0, no overflow) first nrun words in lane order, 16-bit
    words two to an int32 word, low half first, an odd count ending in a
    zero half."""
    stats, runs = stats.cpu(), runs.cpu()
    n, MR = runs.shape
    nrun, of = stats[:, 5], stats[:, 6]
    traced = stats[:, 0] >= params[:, 6].cpu()
    passing = traced & (nrun > 0) & (of == 0)
    over = int((traced & (of != 0)).sum())
    keep = passing[:, None] & (torch.arange(MR)[None, :] < nrun[:, None])
    words = runs[keep].numpy()
    if runs.dtype == torch.int16:
        body = np.zeros(2 * (-(-len(words) // 2)), np.uint16)
        body[:len(words)] = words.astype(np.uint16)
        body = body.view(np.int32)
    else:
        body = words.astype(np.int32)
    head = [int(passing.sum()), over, len(words),
            WIRE_HEADER + STATS_WORDS * n + len(body)]
    return torch.cat([torch.tensor(head, dtype=torch.int32),
                      stats.reshape(-1).to(torch.int32),
                      torch.from_numpy(body)])


def parse_wire(head: np.ndarray, tail: np.ndarray, bits: int, cutoff
               ) -> tuple:
    """dp_align's tuple from a result wire: ``head`` its header and stats
    (int32), ``tail`` its runs section (int32 words, ``bits``-bit run
    words in them), ``cutoff`` the lanes' cutoffs. ops / cnts are as wide
    as the most runs of a lane (at least 1), zero past each lane's runs.
    Raises on a wire that disagrees with itself or holds an overflowed
    lane (the run budget holds every alignment: a kernel fault)."""
    n = (len(head) - WIRE_HEADER) // STATS_WORDS
    npass, nover, nwords, length = (int(x) for x in head[:WIRE_HEADER])
    st = head[WIRE_HEADER:].reshape(n, STATS_WORDS)
    score, nrun, of = st[:, 0], st[:, 5], st[:, 6]
    traced = score >= np.asarray(cutoff)
    passing = traced & (nrun > 0) & (of == 0)
    if nover or (traced & (of != 0)).any():
        raise RuntimeError(f"{nover} DP lanes overflowed the run budget, "
                           "which bounds every alignment")
    lens = np.where(passing, nrun, 0).astype(np.int64)
    nbody = -(-nwords * bits // 32)
    if npass != int(passing.sum()) or nwords != int(lens.sum()) \
            or length != len(head) + nbody or len(tail) < nbody:
        raise RuntimeError(f"the DP result wire disagrees with itself: "
                           f"header {head[:WIRE_HEADER].tolist()}, "
                           f"{int(passing.sum())} passing lanes of "
                           f"{int(lens.sum())} runs, {len(tail)} words")
    words = np.ascontiguousarray(tail[:nbody]).view(
        np.uint16 if bits == 16 else np.uint32)[:nwords].astype(np.int32)
    shift = 12 if bits == 16 else 28
    width = max(int(lens.max(initial=0)), 1)
    # each lane's first lens words, row by row: the wire's order
    held = np.arange(width)[None, :] < lens[:, None]
    ops = np.zeros((n, width), np.int32)
    cnts = np.zeros_like(ops)
    ops[held] = words >> shift
    cnts[held] = words & ((1 << shift) - 1)
    return (score.copy(), st[:, 1].copy(), st[:, 2].copy(), st[:, 3].copy(),
            ops, cnts, nrun.copy(), st[:, 4].astype(np.int64),
            np.zeros(n, bool))


def _plain_tuple(fwd, params, cutoff, Lr: int, Lw: int) -> tuple:
    """dp_align's tuple from the plain forward's outputs on packed
    problems: K1's plain words (_k1_words), DW's plain wire and the host
    parse."""
    bits = word_bits(Lr, Lw)
    stats, runs = _k1_words(fwd, params, run_budget(Lr, Lw), bits)
    wire = dp_wire_plain(params, stats, runs).numpy()
    k = WIRE_HEADER + STATS_WORDS * len(stats)
    return parse_wire(wire[:k], wire[k:], bits, cutoff)


def _align_plain(reads, wins, params, cutoff, sc: DPScores):
    """The plain dp_align of packed problems: the forward scan, then
    _plain_tuple."""
    col = [params[:, k] for k in range(6)]
    fwd = _dp_forward_scan(reads, col[0], wins, col[1], *col[2:], sc)
    return _plain_tuple(fwd, params, cutoff, reads.shape[1], wins.shape[1])


def dp_align_plain(reads, rlens, wins, wlens, clip_l, clip_r, anchor_l,
                   anchor_r, cutoff, sc: DPScores = DPScores()):
    """The plain-torch dp_align: forward scan, traceback sweep, host RLE,
    then the result wire and its parse (the route the kernels take). Same
    return tuple as dp_align (overflow is never set)."""
    params = pack_params(rlens, wlens, clip_l, clip_r, anchor_l, anchor_r,
                         cutoff)
    return _align_plain(reads, wins, torch.from_numpy(params).to(
        reads.device), params[:, 6], sc)


# ------------------------------------------------------------------
# The CUDA kernels: build, bind, launch
# ------------------------------------------------------------------

_SCRATCH_BUDGET = 1 << 29  # bytes of K1 direction scratch per launch
_DIRS_BUDGET = 1 << 30     # bytes of K2 directions per chunk of problems
_MAX_WARPS = 132 * 64      # 16 blocks of 4 warps on each of 132 SMs
# K1 serves windows below this width; the reference's fused kernel packs
# run counts into 12 bits (soap3dp_tpu/kernels/banded_dp.py:983) and
# hands wider windows to dp_forward + dp_traceback
FUSED_MAX_WINDOW = 4096


_P, _I = ctypes.c_void_p, ctypes.c_int
BANDED_DP_LIB = CudaLibrary("banded_dp.cu")
DP_FORWARD_LIB = CudaLibrary("dp_forward.cu")
DP_WIRE_LIB = CudaLibrary("dp_wire.cu")
# pointers and the stream as c_void_p, so none is cut to 32 bits
# soap3dp_dp_align(reads, wins, params, P, Lr, Lw, MR, word_bits, match,
#   mismatch, gap_open, gap_ext, stats, runs, scratch, cells_per_lane,
#   blocks, stream)
DP_KERNEL = CudaKernel(BANDED_DP_LIB, "soap3dp_dp_align",
                       [_P, _P, _P] + [_I] * 9 + [_P] * 3 + [_I, _I, _P])
# soap3dp_dp_forward(reads, wins, params, P, Lr, Lw, match, mismatch,
#   gap_open, gap_ext, stats, dirs, cells_per_lane, blocks, stream)
FORWARD_KERNEL = CudaKernel(DP_FORWARD_LIB, "soap3dp_dp_forward",
                            [_P, _P, _P] + [_I] * 7 + [_P, _P, _I, _I, _P])
# soap3dp_dp_traceback(dirs, P, Lr1, ND, params, stats, MR, runs, stream)
TRACEBACK_KERNEL = CudaKernel(DP_FORWARD_LIB, "soap3dp_dp_traceback",
                              [_P, _I, _I, _I, _P, _P, _I, _P, _P])
# soap3dp_dp_wire(params, n, runs, MR, word_bits, wire, scan, base, tag,
#   tiles, stream): one launch
WIRE_KERNEL = CudaKernel(DP_WIRE_LIB, "soap3dp_dp_wire",
                         [_P, _I, _P, _I, _I, _P, _P, ctypes.c_uint,
                          ctypes.c_uint, _I, _P])
# DW's look-back scan: tiles of 64 lanes (csrc/dp_wire.cu TILE)
WIRE_TILE = 64

# host syncs counted inside the wide route's chunk loop while
# WATCH_LOOP_SYNCS is set (torch.cuda's sync debug mode over the loop; a
# process-wide setting, so only where one thread drives the cards)
WATCH_LOOP_SYNCS = False
LOOP_SYNCS = 0


def _cells_per_lane(Lr: int) -> int:
    c = max(4, -(-(Lr + 1) // 32))
    if c > 64:
        raise ValueError(f"read length {Lr} exceeds the DP kernels' "
                         "2047-cell anti-diagonal")
    return 1 << (c - 1).bit_length()


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check_packed(name, reads, wins, params):
    """reads (P, Lr), wins (P, Lw) and params (P, 8) int32, contiguous, on
    one CUDA device."""
    P = reads.shape[0]
    for t in (reads, wins, params):
        if not t.is_cuda or t.device != reads.device:
            raise ValueError(f"{name} needs every tensor on one CUDA device")
        if t.dim() != 2 or t.shape[0] != P:
            raise ValueError(f"{name}: reads (P, Lr), wins (P, Lw) and "
                             f"params (P, 8) expected, got {tuple(t.shape)}")
    if params.shape[1] != 8 or params.dtype != torch.int32 \
            or not params.is_contiguous():
        raise ValueError(f"{name}: params must be contiguous (P, 8) int32")


_RESIDENT: dict[tuple[int, int], int] = {}


def _resident_warps(lib, dev: torch.device, C: int) -> int:
    """K1's warps resident on ``dev`` at once for C cells per lane (the
    occupancy API through the library; cached per card and C)."""
    key = (dev.index, C)
    if key not in _RESIDENT:
        fn = lib.soap3dp_dp_align_resident_warps
        fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int]
        with torch.cuda.device(dev):
            _RESIDENT[key] = int(fn(C))
    return _RESIDENT[key] or _MAX_WARPS


def wire_words(P: int, MR: int, bits: int) -> int:
    """The int32 words of a call's wire: its header, P stats rows and
    room for P x MR run words of ``bits`` bits. Raises where they pass
    2^31 (the wire's header and offsets are int32)."""
    n = WIRE_HEADER + STATS_WORDS * P + -(-P * MR * bits // 32)
    if P < 0 or MR < 1 or n >= 1 << 31:
        raise ValueError(f"DP wire: {P} lanes of {MR} {bits}-bit run words "
                         "do not fit an int32 wire")
    return n


def wire_tiles(n: int) -> int:
    """DW's tiles (blocks) for n lanes: ceil(n / WIRE_TILE), and one for
    no lanes (it writes the header)."""
    return max(1, -(-n // WIRE_TILE))


def _wire_buffers(P: int, MR: int, bits: int, dev: torch.device):
    """(wire, runs) of a call: the result wire, int32, room for its
    header, P stats rows and P x MR run words (wire_words); the kernels'
    runs (P, MR), int16 for 16-bit words, int32 for 32-bit."""
    wire = torch.empty(wire_words(P, MR, bits), dtype=torch.int32,
                       device=dev)
    runs = torch.empty((P, MR), dtype=torch.int16 if bits == 16
                       else torch.int32, device=dev)
    return wire, runs


def _wire_stats(wire: torch.Tensor, P: int) -> torch.Tensor:
    """The wire's (P, 8) stats rows, a view."""
    return wire[WIRE_HEADER:WIRE_HEADER + STATS_WORDS * P].view(P,
                                                                STATS_WORDS)


def _launch_dp(reads, wins, params, MR: int, stats, runs, sc: DPScores):
    """One launch of csrc/banded_dp.cu over P problems on the current
    stream of their device, with that device made current (a launch
    must run in the context of the memory it touches). The grid is at
    most the warps resident at once, so no problem waits for a second
    wave while the card can hold it. Writes ``stats`` (P, 8) int32 and
    ``runs`` (P, MR) words (int16: 16 bits, int32: 32)."""
    lib, fn = DP_KERNEL.function()
    P, Lr = reads.shape
    Lw = wins.shape[1]
    dev = reads.device
    C = _cells_per_lane(Lr)
    ND = Lr + Lw
    per_warp = ND * 32 * C
    wpb = int(lib.soap3dp_warps_per_block())
    warps = max(1, min(P, _resident_warps(lib, dev, C),
                       _SCRATCH_BUDGET // per_warp))
    blocks = -(-warps // wpb)
    scratch = torch.empty(blocks * wpb * per_warp, dtype=torch.uint8,
                          device=dev)
    bits = 16 if runs.dtype == torch.int16 else 32
    with torch.cuda.device(dev):
        err = fn(reads.data_ptr(), wins.data_ptr(), params.data_ptr(), P, Lr,
                 Lw, MR, bits, sc.match, sc.mismatch, sc.gap_open,
                 sc.gap_ext, stats.data_ptr(), runs.data_ptr(),
                 scratch.data_ptr(), C, blocks, _stream(dev))
    if err != 0:
        raise RuntimeError(f"banded DP kernel launch failed: CUDA error {err}")
    DP_KERNEL.count(dev, (P, Lr, Lw))


def _launch_forward(reads, wins, params, dirs, stats, sc: DPScores):
    """One launch of K2 (csrc/dp_forward.cu) over the P problems of
    ``dirs`` (ND, P, Lr+1) uint8, which it fills, and words 0-3 of their
    ``stats`` rows (P, 8) int32: best score, hit_i, hit_j, tie count."""
    _, fn = FORWARD_KERNEL.function()
    P, Lr = reads.shape
    Lw = wins.shape[1]
    dev = reads.device
    if dirs.shape != (Lr + Lw, P, Lr + 1) or dirs.dtype != torch.uint8 \
            or not dirs.is_contiguous():
        raise ValueError(f"dirs must be contiguous uint8 {(Lr + Lw, P, Lr + 1)}")
    warps = max(1, min(P, _MAX_WARPS))
    blocks = -(-warps // 4)
    with torch.cuda.device(dev):
        err = fn(reads.data_ptr(), wins.data_ptr(), params.data_ptr(), P, Lr,
                 Lw, sc.match, sc.mismatch, sc.gap_open, sc.gap_ext,
                 stats.data_ptr(), dirs.data_ptr(), _cells_per_lane(Lr),
                 blocks, _stream(dev))
    if err != 0:
        raise RuntimeError(f"DP forward kernel launch failed: CUDA error {err}")
    FORWARD_KERNEL.count(dev, (P, Lr, Lw))


def _launch_traceback(dirs, params, stats, runs, MR: int):
    """One launch of the traceback kernel over the P problems of ``dirs``,
    one warp a problem on at most the warps resident at once: a problem
    is traced where its score (``stats`` word 0) reaches its cutoff
    (``params`` word 6); writes words 4-7 of its stats row and its runs
    (``runs``: (P, MR) int32, 32-bit words)."""
    _, fn = TRACEBACK_KERNEL.function()
    ND, P, Lr1 = dirs.shape
    dev = dirs.device
    with torch.cuda.device(dev):
        err = fn(dirs.data_ptr(), P, Lr1, ND, params.data_ptr(),
                 stats.data_ptr(), MR, runs.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"DP traceback kernel launch failed: CUDA error "
                           f"{err}")
    TRACEBACK_KERNEL.count(dev, (P, Lr1 - 1, ND - Lr1 + 1))


def _launch_wire(params, runs, wire):
    """One call of DW (csrc/dp_wire.cu, one launch of wire_tiles(n)
    blocks on the card's scan state for the current stream,
    fm_search.gen_state("scan", ...), shared with FS4 and FS5): the
    header and the runs section of ``wire``, whose stats rows are
    written, from ``params`` (n, 8) and ``runs`` (n, MR) words (int16:
    16 bits, int32: 32). ``wire`` and ``params`` lie on 16-byte
    boundaries (the kernel reads and writes 16-byte vectors)."""
    n, MR = runs.shape
    dev = wire.device
    bits = 16 if runs.dtype == torch.int16 else 32
    if wire.numel() < wire_words(n, MR, bits):
        raise ValueError(f"DP wire: {wire.numel()} words, "
                         f"{wire_words(n, MR, bits)} needed")
    if wire.data_ptr() % 16 or params.data_ptr() % 16:
        raise ValueError("DP wire: the wire and params must lie on 16-byte "
                         "boundaries")
    _, fn = WIRE_KERNEL.function()
    with torch.cuda.device(dev), fs._STATE_LOCK:
        stream = _stream(dev)
        scan, tag, base = _wire_scan(dev, stream, n)
        fs._launched("DP wire", fn(
            params.data_ptr(), n, runs.data_ptr(), MR, bits,
            wire.data_ptr(), scan.data_ptr(), base, tag, wire_tiles(n),
            stream), dev, stream)
    WIRE_KERNEL.count(dev, (n, MR, bits))


def _wire_scan(dev: torch.device, stream: int, n: int
               ) -> tuple[torch.Tensor, int, int]:
    """DW's look-back state for a call of n lanes on ``stream``: the scan
    state FS4 and FS5 keep for the card and stream (fm_search.gen_state
    "scan": the ticket counter, then at least 2 wire_tiles(n) words, the
    tiles' statuses and their lanes words), the call's tag (its
    generation << 2) and its ticket base (the tickets earlier calls took
    there, 32 bits). The caller holds fm_search._STATE_LOCK until its
    launch is queued."""
    tiles = wire_tiles(n)
    scan, gen, base = fs.gen_state("scan", dev, stream, 2 * tiles + 1,
                                   tiles)
    return scan, gen << 2, base & 0xFFFFFFFF


def dp_wire(params, stats, runs) -> torch.Tensor:
    """DW on the card: the result wire (int32, as allocated; its first
    header[3] words are the wire) of the lanes' stats rows (n, 8) int32,
    problem rows (n, 8) int32 and runs (n, MR) words (int16: 16 bits,
    int32: 32), all on one CUDA device; dp_wire_plain is its plain
    version. (The DP routes launch DW on a wire their kernels filled.)"""
    n, MR = runs.shape
    if not (stats.is_cuda and params.is_cuda and runs.is_cuda) \
            or len({stats.device, params.device, runs.device}) != 1:
        raise ValueError("dp_wire needs every tensor on one CUDA device")
    bits = 16 if runs.dtype == torch.int16 else 32
    wire = _wire_buffers(n, MR, bits, stats.device)[0]
    _wire_stats(wire, n).copy_(stats)
    _launch_wire(params.contiguous(), runs.contiguous(), wire)
    return wire


def _to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` (on a card) as a host array: one copy into pinned memory on
    its device's current stream, waited for."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))
    done.synchronize()
    return host.numpy()


def _download(wire, P: int, bits: int, cutoff) -> tuple:
    """dp_align's tuple from a call's wire on the card: its header and
    stats in one copy, then its runs at their exact length (none if no
    lane passed)."""
    k = WIRE_HEADER + STATS_WORDS * P
    head = _to_host(wire[:k])
    tail = (_to_host(wire[k:int(head[3])]) if head[3] > k
            else np.zeros(0, np.int32))
    return parse_wire(head, tail, bits, cutoff)


def _empty_align():
    z = np.zeros(0, np.int32)
    return (z, z, z, z, np.zeros((0, 1), np.int32),
            np.zeros((0, 1), np.int32), z, z.astype(np.int64),
            np.zeros(0, bool))


def _k1_outputs(reads, wins, params, sc: DPScores):
    """K1 over packed problems: (the call's wire, its stats rows written;
    the runs (P, run_budget) words)."""
    P, Lr = reads.shape
    Lw = wins.shape[1]
    MR = run_budget(Lr, Lw)
    wire, runs = _wire_buffers(P, MR, word_bits(Lr, Lw), reads.device)
    _launch_dp(reads, wins, params, MR, _wire_stats(wire, P), runs, sc)
    return wire, runs


def _align_k1(reads, wins, params, cutoff, sc: DPScores):
    """dp_align of packed problems through K1 and DW: K1 writes the
    stats rows into the call's wire and its runs as words, DW the header
    and the passing lanes' runs, and the host downloads the wire."""
    wire, runs = _k1_outputs(reads, wins, params, sc)
    _launch_wire(params, runs, wire)
    return _download(wire, reads.shape[0],
                     16 if runs.dtype == torch.int16 else 32, cutoff)


@contextlib.contextmanager
def _chunk_loop():
    """The wide route's chunk loop; with WATCH_LOOP_SYNCS set, adds the
    host syncs torch reports inside it to LOOP_SYNCS."""
    global LOOP_SYNCS
    if not WATCH_LOOP_SYNCS:
        yield
        return
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    LOOP_SYNCS += sum("synchroniz" in str(w.message) for w in caught)


def _wide_outputs(reads, wins, params, sc: DPScores):
    """K2 and TB over packed problems, the problem axis in chunks whose
    directions fit _DIRS_BUDGET, one buffer serving every chunk: each
    chunk's K2 writes its stats rows into the call's wire and its TB
    traces the lanes that reach their cutoff into the runs, one after
    the other on the stream with no host round trip between. Returns
    (the wire, its stats rows written; the runs (P, run_budget) 32-bit
    words)."""
    P, Lr = reads.shape
    Lw = wins.shape[1]
    dev = reads.device
    ND, Lr1 = Lr + Lw, Lr + 1
    MR = run_budget(Lr, Lw)
    wire, runs = _wire_buffers(P, MR, 32, dev)
    stats = _wire_stats(wire, P)
    chunk = max(1, min(P, _DIRS_BUDGET // (ND * Lr1)))
    buf = torch.empty(ND * chunk * Lr1, dtype=torch.uint8, device=dev)
    with _chunk_loop():
        for p0 in range(0, P, chunk):
            p1 = min(P, p0 + chunk)
            dirs = buf[: ND * (p1 - p0) * Lr1].view(ND, p1 - p0, Lr1)
            _launch_forward(reads[p0:p1], wins[p0:p1], params[p0:p1], dirs,
                            stats[p0:p1], sc)
            _launch_traceback(dirs, params[p0:p1], stats[p0:p1],
                              runs[p0:p1], MR)
    return wire, runs


def _align_wide(reads, wins, params, cutoff, sc: DPScores):
    """dp_align of packed problems through K2, TB and DW: the reference's
    route for windows of FUSED_MAX_WINDOW and more (_wide_outputs); DW
    completes the wire after the last chunk, and the host downloads
    it."""
    wire, runs = _wide_outputs(reads, wins, params, sc)
    _launch_wire(params, runs, wire)
    return _download(wire, reads.shape[0], 32, cutoff)


def takes_wide_route(Lr: int, Lw: int) -> bool:
    """Whether dp_align takes K2 + traceback (else K1) on CUDA: where the
    reference leaves its fused kernel for dp_forward's Pallas kernel
    (a window of FUSED_MAX_WINDOW or more, and Lr + 1 <= 128)."""
    return Lw >= FUSED_MAX_WINDOW and Lr + 1 <= 128


def dp_align_packed(reads, wins, params, cutoff, sc: DPScores = DPScores()):
    """dp_align of problems whose vectors come packed: ``params`` (P, 8)
    int32 rows (PARAM_COLUMNS, pack_params) on the reads' device,
    ``cutoff`` their cutoffs on the host (the parse's). On CUDA tensors
    the route's kernels run (or raise), with no library kernel; on CPU
    tensors the plain version."""
    P, Lr = reads.shape
    if P == 0:
        return _empty_align()
    if reads.is_cuda:
        _check_packed("dp_align", reads, wins, params)
        route = _align_wide if takes_wide_route(Lr, wins.shape[1]) \
            else _align_k1
        return route(reads.to(torch.uint8).contiguous(),
                     wins.to(torch.uint8).contiguous(), params,
                     np.asarray(cutoff), sc)
    if reads.device.type != "cpu":
        raise ValueError(f"dp_align: no DP implementation for {reads.device}")
    return _align_plain(reads, wins, params, cutoff, sc)


def _packed(reads, rlens, wins, wlens, clip_l, clip_r, anchor_l, anchor_r,
            cutoff):
    """dp_align's nine inputs as dp_align_packed's four: the problem rows
    packed on the host and uploaded to the reads' device."""
    from soap3dp_tpu_torch.fm.fmindex import to_device

    params = pack_params(rlens, wlens, clip_l, clip_r, anchor_l, anchor_r,
                         cutoff)
    return reads, wins, to_device(params, reads.device), params[:, 6]


def _on_route(route, name: str, nine: tuple, sc: DPScores):
    """dp_align's nine inputs (all on one CUDA device) through ``route``
    whatever the shape."""
    if nine[0].shape[0] == 0:
        return _empty_align()
    reads, wins, params, cut = _packed(*nine)
    _check_packed(name, reads, wins, params)
    return route(reads.to(torch.uint8).contiguous(),
                 wins.to(torch.uint8).contiguous(), params, cut, sc)


def dp_align_cuda(reads, rlens, wins, wlens, clip_l, clip_r, anchor_l,
                  anchor_r, cutoff, sc: DPScores = DPScores()):
    """dp_align through K1 and DW whatever the shape (all tensors on one
    CUDA device)."""
    return _on_route(_align_k1, "dp_align_cuda", (
        reads, rlens, wins, wlens, clip_l, clip_r, anchor_l, anchor_r,
        cutoff), sc)


def dp_align_wide(reads, rlens, wins, wlens, clip_l, clip_r, anchor_l,
                  anchor_r, cutoff, sc: DPScores = DPScores()):
    """dp_align through K2, TB and DW whatever the shape (all tensors on
    one CUDA device)."""
    return _on_route(_align_wide, "dp_align_wide", (
        reads, rlens, wins, wlens, clip_l, clip_r, anchor_l, anchor_r,
        cutoff), sc)


def dp_forward(reads, rlens, wins, wlens, clip_l, clip_r, anchor_l, anchor_r,
               sc: DPScores = DPScores()):
    """Forward DP only. Returns (best_score, hit_i, hit_j, count, dirs)
    as tensors on the inputs' device: hit_i/hit_j are the 1-based end of
    the best cell, count the number of eligible cells with the best score
    (the reference's maxScoreCount), dirs (Lr+Lw, P, Lr+1) uint8,
    diagonal-major: the direction byte of each cell (bits 0-1 H, 2 D,
    3-4 I, 5 match). On CUDA tensors K2 runs (or raises); on CPU tensors
    the plain-torch scan."""
    if reads.is_cuda:
        P, Lr = reads.shape
        r, w, params, _ = _packed(reads, rlens, wins, wlens, clip_l, clip_r,
                                  anchor_l, anchor_r, np.zeros(P, np.int32))
        _check_packed("dp_forward", r, w, params)
        dirs = torch.empty((Lr + wins.shape[1], P, Lr + 1), dtype=torch.uint8,
                           device=reads.device)
        st = torch.empty((P, STATS_WORDS), dtype=torch.int32,
                         device=reads.device)
        _launch_forward(r.to(torch.uint8).contiguous(),
                        w.to(torch.uint8).contiguous(), params, dirs, st, sc)
        return st[:, 0], st[:, 1], st[:, 2], st[:, 3], dirs
    if reads.device.type != "cpu":
        raise ValueError(f"dp_forward: no DP implementation for {reads.device}")
    return _dp_forward_scan(reads, rlens, wins, wlens, clip_l, clip_r,
                            anchor_l, anchor_r, sc)


def dp_traceback(dirs, reads, rlens, wins, hit_i, hit_j, clip_l, active):
    """Traceback of dp_forward's directions for the ``active`` lanes.
    Returns numpy (ops, counts, nruns, start_j): ops/counts (P, MR)
    right-to-left runs (the first is the right clip), MR the most runs of
    any lane (at least 1); start_j the 0-based window offset where each
    alignment starts. ``reads`` and ``wins`` are accepted and unused (the
    match bit is in dirs). On CUDA tensors the traceback kernel and DW
    run (or raise); on CPU tensors their plain versions. Either way the
    runs go through the result wire and its parse."""
    del reads, wins
    ND, P, Lr1 = dirs.shape
    if dirs.device.type not in ("cuda", "cpu"):
        raise ValueError(f"dp_traceback: no implementation for {dirs.device}")
    # traced where score 0 reaches cutoff 0: the active lanes
    params = pack_params(rlens, np.zeros(P), clip_l, np.zeros(P),
                         np.zeros(P), np.zeros(P), np.zeros(P))
    stats = np.zeros((P, STATS_WORDS), np.int32)
    stats[:, 0] = np.where(np.asarray(active), 0, -1)
    stats[:, 1] = np.asarray(hit_i.cpu())
    stats[:, 2] = np.asarray(hit_j.cpu())
    MR = run_budget(Lr1 - 1, ND - Lr1 + 1)
    if dirs.is_cuda:
        from soap3dp_tpu_torch.fm.fmindex import to_device

        wire, runs = _wire_buffers(P, MR, 32, dirs.device)
        _wire_stats(wire, P).copy_(torch.from_numpy(stats))
        prm = to_device(params, dirs.device)
        _launch_traceback(dirs, prm, _wire_stats(wire, P), runs, MR)
        _launch_wire(prm, runs, wire)
        out = _download(wire, P, 32, params[:, 6])
    else:
        prm, st = torch.from_numpy(params), torch.from_numpy(stats)
        runs = _tb_plain(dirs, prm, st, MR)
        wire = dp_wire_plain(prm, st, runs).numpy()
        k = WIRE_HEADER + STATS_WORDS * P
        out = parse_wire(wire[:k], wire[k:], 32, params[:, 6])
    return out[4], out[5], out[6], out[7]


def _concat_align(parts):
    """dp_align results of consecutive problem slices as one: arrays
    concatenated, ops/cnts right-padded to the widest slice's."""
    mr = max(p[4].shape[1] for p in parts)

    def cat(k):
        if k in (4, 5):
            return np.concatenate([np.pad(p[k], ((0, 0), (0, mr - p[k].shape[1])))
                                   for p in parts])
        return np.concatenate([p[k] for p in parts])

    return tuple(cat(k) for k in range(9))


def dp_align_shards(shards, sc: DPScores = DPScores()):
    """dp_align over problems split into consecutive slices, each on one
    device, given as dp_align's nine inputs or as dp_align_packed's four
    (reads, wins, params, host cutoffs). Each slice is aligned on its
    device in a host thread of its own (each call waits on its wire's
    download, so one thread would run the devices one after the other;
    the ctypes launches release the interpreter lock), and the outputs
    are concatenated in problem order."""
    from soap3dp_tpu_torch.distributed.mesh import map_shards

    def one(j):
        s = shards[j]
        return (dp_align_packed(*s, sc=sc) if len(s) == 4
                else dp_align(*s, sc=sc))

    parts = map_shards([s[0].device for s in shards], one)
    return parts[0] if len(parts) == 1 else _concat_align(parts)


def dp_align(reads, rlens, wins, wlens, clip_l, clip_r, anchor_l, anchor_r,
             cutoff, sc: DPScores = DPScores(), mesh=None):
    """Forward + traceback in one call; host-ready numpy results
    ``(score, hit_i, hit_j, n_best, ops, cnts, nrun, startj, overflow)``.

    ops/cnts are right-to-left CIGAR runs for every lane with
    score >= cutoff (others have nrun == 0), as wide as the most runs of
    a lane; only the first nrun columns of a row are meaningful. On CUDA
    tensors Hopper kernels run (or raise): K2 + the traceback kernel
    where takes_wide_route, K1 elsewhere, then DW, the result wire the
    host downloads (the problems' vectors are packed on the host first:
    dp_align_packed takes them packed). On CPU tensors the plain-torch
    version runs, through the same wire. With ``mesh`` (a
    distributed.mesh.DeviceMesh) the problem axis is split into
    near-equal consecutive slices, slice j aligned on the mesh's device j
    through the same choice (dp_align_shards)."""
    if mesh is not None and mesh.size > 1:
        args = [a.tensor_split(mesh.size) for a in
                (reads, rlens, wins, wlens, clip_l, clip_r, anchor_l,
                 anchor_r, cutoff)]
        return dp_align_shards(
            [[a[j].to(dev) for a in args]
             for j, dev in enumerate(mesh.devices)], sc)
    if reads.device.type not in ("cuda", "cpu"):
        raise ValueError(f"dp_align: no DP implementation for {reads.device}")
    if reads.shape[0] == 0:
        return _empty_align()
    if reads.is_cuda:
        return dp_align_packed(*_packed(reads, rlens, wins, wlens, clip_l,
                                        clip_r, anchor_l, anchor_r, cutoff),
                               sc=sc)
    return dp_align_plain(reads, rlens, wins, wlens, clip_l, clip_r,
                          anchor_l, anchor_r, cutoff, sc)
