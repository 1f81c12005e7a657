"""Batched semi-global affine-gap DP: forward, traceback, CIGAR runs.

Port of soap3dp_tpu/kernels/banded_dp.py (``dp_align``, ``dp_forward``,
``dp_traceback``). Two implementations of each function:

* CUDA tensors: hand-written Hopper kernels, built with nvcc at first
  use into ``_build/`` and loaded with ctypes (see each source note).
  K1, ``csrc/banded_dp.cu``, replaces the TPU kernel
  ``_dp_align_pallas_kernel`` (soap3dp_tpu/kernels/banded_dp.py:606):
  forward, traceback and CIGAR runs in one launch. K2 and TB,
  ``csrc/dp_forward.cu``, replace ``_dp_forward_pallas_kernel`` (:238)
  and the traceback sweep + host RLE that consume its directions
  (:409-600); ``dp_align`` takes them where the reference does (windows
  of FUSED_MAX_WINDOW and more, reads of at most 127), K1 elsewhere.
* CPU tensors: the plain-torch version — the anti-diagonal forward of
  the reference's ``_dp_forward_scan``, its reverse traceback sweep and
  the host run-length encoding ``_rle_runs``.

Each function takes a kernel for a CUDA tensor (or raises) and the
plain version for a CPU tensor, and nothing else: there is no fallback
from one to the other.

Recurrences (cells on anti-diagonal d = i + j depend on d-1 and d-2):

    H[i,j] = max(H[i-1,j-1] + subst, D[i,j], I[i,j])
    D[i,j] = max(H[i,j-1] + open, D[i,j-1] + ext)          # window gap
    I[i,j] = max(H[i-1,j] + open, I[i-1,j] + ext, fresh)   # read gap
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from soap3dp_tpu_torch.kernels.cudalib import CudaKernel, CudaLibrary

NEG = -32000          # DP_SCORE_NEG_INFINITY (DV-DPfunctions.cu:52)
NEG_BIG = -(1 << 20)  # masking value, far below any reachable score

# direction encodings
DH_DIAG, DH_D, DH_SM, DH_I = 0, 1, 2, 3
DD_OPEN, DD_EXT = 0, 1
DI_FRESH, DI_OPEN, DI_EXT = 0, 1, 2

# traceback op codes
OP_NONE, OP_MATCH, OP_MISMATCH, OP_INS, OP_DEL, OP_CLIP = 0, 1, 2, 3, 4, 5

MAX_RUNS = 128  # first-launch run budget; see _max_runs_bound()


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


def _max_runs_bound(max_read_len: int) -> int:
    """Upper bound on CIGAR runs for an alignment passing the 0.3*L
    cutoff (every non-match run costs >= 3 score), rounded up to 128."""
    n = 2 * (7 * max_read_len // 30) + 4
    return -(-n // 128) * 128


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


def dp_align_plain(reads, rlens, wins, wlens, clip_l, clip_r, anchor_l,
                   anchor_r, cutoff, sc: DPScores = DPScores()):
    """The plain-torch dp_align: forward scan, traceback sweep, host RLE.
    Same return tuple as dp_align (overflow is never set)."""
    bS, bI, bJ, bC, dirs = _dp_forward_scan(
        reads, rlens, wins, wlens, clip_l, clip_r, anchor_l, anchor_r, sc)
    score = bS.cpu().numpy()
    active = score >= cutoff.cpu().numpy()
    ops, cnts, nrun, startj = _dp_traceback_plain(dirs, rlens, bI, bJ,
                                                  clip_l, active)
    return (score, bI.cpu().numpy(), bJ.cpu().numpy(), bC.cpu().numpy(),
            ops, cnts, nrun, startj.astype(np.int64),
            np.zeros(reads.shape[0], bool))


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
# pointers and the stream as c_void_p, so none is cut to 32 bits
# soap3dp_dp_align(reads, wins, params, P, Lr, Lw, MR, match, mismatch,
#   gap_open, gap_ext, stats, ops, cnts, scratch, cells_per_lane, blocks,
#   stream)
DP_KERNEL = CudaKernel(BANDED_DP_LIB, "soap3dp_dp_align",
                       [_P, _P, _P] + [_I] * 8 + [_P] * 4 + [_I, _I, _P])
# soap3dp_dp_forward(reads, wins, params, P, Lr, Lw, match, mismatch,
#   gap_open, gap_ext, stats, dirs, cells_per_lane, blocks, stream)
FORWARD_KERNEL = CudaKernel(DP_FORWARD_LIB, "soap3dp_dp_forward",
                            [_P, _P, _P] + [_I] * 7 + [_P, _P, _I, _I, _P])
# soap3dp_dp_traceback(dirs, P, Lr1, ND, tbp, active, lanes, n, MR, ops,
#   cnts, meta, stream)
TRACEBACK_KERNEL = CudaKernel(DP_FORWARD_LIB, "soap3dp_dp_traceback",
                              [_P, _I, _I, _I, _P, _P, _P, _I, _I,
                               _P, _P, _P, _P])


def _cells_per_lane(Lr: int) -> int:
    c = max(4, -(-(Lr + 1) // 32))
    if c > 64:
        raise ValueError(f"read length {Lr} exceeds the DP kernels' "
                         "2047-cell anti-diagonal")
    return 1 << (c - 1).bit_length()


def _check_problems(name, reads, wins, *vectors):
    """Every tensor on one CUDA device; reads (P, Lr), wins (P, Lw) and
    (P,) parameter vectors."""
    P = reads.shape[0]
    for t in (reads, wins) + vectors:
        if not t.is_cuda or t.device != reads.device:
            raise ValueError(f"{name} needs every tensor on one CUDA device")
        if t.shape[0] != P or t.dim() != (2 if t is reads or t is wins else 1):
            raise ValueError(f"{name}: reads (P, Lr), wins (P, Lw) and (P,) "
                             f"parameters expected, got {tuple(t.shape)}")


def _params(rlens, wlens, clip_l, clip_r, anchor_l, anchor_r, cutoff=None):
    """The kernels' (P, 8) int32 problem rows."""
    z = torch.zeros_like(rlens)
    return torch.stack(
        [rlens, wlens, clip_l, clip_r, anchor_l, anchor_r,
         z if cutoff is None else cutoff, z], dim=1).to(torch.int32).contiguous()


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


def _launch_dp(reads, wins, params, MR: int, sc: DPScores):
    """One launch of csrc/banded_dp.cu over P problems on the current
    stream of their device, with that device made current (a launch
    must run in the context of the memory it touches). The grid is at
    most the warps resident at once, so no problem waits for a second
    wave while the card can hold it. Returns device (stats (P, 8), ops
    (P, MR), cnts (P, MR))."""
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
    stats = torch.empty((P, 8), dtype=torch.int32, device=dev)
    ops = torch.zeros((P, MR), dtype=torch.int32, device=dev)
    cnts = torch.zeros((P, MR), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = fn(reads.data_ptr(), wins.data_ptr(), params.data_ptr(), P, Lr,
                 Lw, MR, sc.match, sc.mismatch, sc.gap_open, sc.gap_ext,
                 stats.data_ptr(), ops.data_ptr(), cnts.data_ptr(),
                 scratch.data_ptr(), C, blocks,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"banded DP kernel launch failed: CUDA error {err}")
    DP_KERNEL.count(dev, (P, Lr, Lw))
    return stats, ops, cnts


def _launch_forward(reads, wins, params, dirs, sc: DPScores):
    """One launch of K2 (csrc/dp_forward.cu) over the P problems of
    ``dirs`` (ND, P, Lr+1) uint8, which it fills. Returns device stats
    (P, 4) int32: best score, hit_i, hit_j, tie count."""
    _, fn = FORWARD_KERNEL.function()
    P, Lr = reads.shape
    Lw = wins.shape[1]
    dev = reads.device
    if dirs.shape != (Lr + Lw, P, Lr + 1) or dirs.dtype != torch.uint8 \
            or not dirs.is_contiguous():
        raise ValueError(f"dirs must be contiguous uint8 {(Lr + Lw, P, Lr + 1)}")
    warps = max(1, min(P, _MAX_WARPS))
    blocks = -(-warps // 4)
    stats = torch.empty((P, 4), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = fn(reads.data_ptr(), wins.data_ptr(), params.data_ptr(), P, Lr,
                 Lw, sc.match, sc.mismatch, sc.gap_open, sc.gap_ext,
                 stats.data_ptr(), dirs.data_ptr(), _cells_per_lane(Lr),
                 blocks, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"DP forward kernel launch failed: CUDA error {err}")
    FORWARD_KERNEL.count(dev, (P, Lr, Lw))
    return stats


def _launch_traceback(dirs, tbp, active, lanes, n: int, MR: int):
    """One launch of the traceback kernel over ``n`` problems (``lanes``,
    or all of them when None), one warp a problem on at most the warps
    resident at once. Returns device (ops (n, MR), cnts (n, MR), both
    zero past each row's runs; meta (n, 4): nrun, startj, overflow, 0)."""
    _, fn = TRACEBACK_KERNEL.function()
    ND, P, Lr1 = dirs.shape
    dev = dirs.device
    ops = torch.empty((n, MR), dtype=torch.int32, device=dev)
    cnts = torch.empty((n, MR), dtype=torch.int32, device=dev)
    meta = torch.empty((n, 4), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = fn(dirs.data_ptr(), P, Lr1, ND, tbp.data_ptr(),
                 active.data_ptr(), None if lanes is None else lanes.data_ptr(),
                 n, MR, ops.data_ptr(), cnts.data_ptr(), meta.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"DP traceback kernel launch failed: CUDA error "
                           f"{err}")
    TRACEBACK_KERNEL.count(dev, (n, Lr1 - 1, ND - Lr1 + 1))
    return ops, cnts, meta


def _traceback_cuda(dirs, rlens, hit_i, hit_j, clip_l, active):
    """dp_traceback through the traceback kernel. Lanes that overflow the
    first run budget are re-launched with a budget of ND + 4, a hard
    bound on the runs of any alignment. Returns numpy (ops, cnts, nrun,
    startj) with ops/cnts as wide as the largest budget launched."""
    ND, P, Lr1 = dirs.shape
    dev = dirs.device
    tbp = torch.stack([rlens, hit_i, hit_j, clip_l], dim=1).to(
        device=dev, dtype=torch.int32).contiguous()
    act = torch.as_tensor(active, device=dev).to(torch.uint8).contiguous()
    mr = max(MAX_RUNS, _max_runs_bound(Lr1 - 1))
    ops_d, cnts_d, meta = _launch_traceback(dirs, tbp, act, None, P, mr)
    m = meta.cpu().numpy()
    nrun, startj = m[:, 0].copy(), m[:, 1].astype(np.int64)
    redo = np.flatnonzero(m[:, 2] != 0)
    if redo.size:
        mr2 = ND + 4
        lanes = torch.from_numpy(redo.astype(np.int32)).to(dev)
        o2, c2, m2 = _launch_traceback(dirs, tbp, act, lanes, len(redo), mr2)
        ops_d = torch.nn.functional.pad(ops_d, (0, mr2 - mr))
        cnts_d = torch.nn.functional.pad(cnts_d, (0, mr2 - mr))
        ops_d[lanes.long()] = o2
        cnts_d[lanes.long()] = c2
        nrun[redo] = m2[:, 0].cpu().numpy()
        mr = mr2
    ops = np.zeros((P, mr), np.int32)
    cnts = np.zeros((P, mr), np.int32)
    pass_idx = np.flatnonzero(nrun > 0)
    if len(pass_idx):
        g = torch.from_numpy(pass_idx).to(dev)
        ops[pass_idx] = ops_d[g].cpu().numpy()
        cnts[pass_idx] = cnts_d[g].cpu().numpy()
    return ops, cnts, nrun, startj


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
        _check_problems("dp_forward", reads, wins, rlens, wlens, clip_l,
                        clip_r, anchor_l, anchor_r)
        P, Lr = reads.shape
        dirs = torch.empty((Lr + wins.shape[1], P, Lr + 1), dtype=torch.uint8,
                           device=reads.device)
        st = _launch_forward(
            reads.to(torch.uint8).contiguous(), wins.to(torch.uint8).contiguous(),
            _params(rlens, wlens, clip_l, clip_r, anchor_l, anchor_r), dirs, sc)
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
    match bit is in dirs). On CUDA tensors the traceback kernel runs (or
    raises); on CPU tensors the plain sweep and host run-length
    encoding."""
    del reads, wins
    if dirs.is_cuda:
        ops, cnts, nrun, startj = _traceback_cuda(dirs, rlens, hit_i, hit_j,
                                                  clip_l, active)
        w = max(int(nrun.max(initial=0)), 1)
        return ops[:, :w], cnts[:, :w], nrun, startj
    if dirs.device.type != "cpu":
        raise ValueError(f"dp_traceback: no implementation for {dirs.device}")
    return _dp_traceback_plain(dirs, rlens, hit_i, hit_j, clip_l, active)


def _empty_align():
    z = np.zeros(0, np.int32)
    return (z, z, z, z, np.zeros((0, 1), np.int32),
            np.zeros((0, 1), np.int32), z, z.astype(np.int64),
            np.zeros(0, bool))


def dp_align_cuda(reads, rlens, wins, wlens, clip_l, clip_r, anchor_l,
                  anchor_r, cutoff, sc: DPScores = DPScores()):
    """dp_align through K1 (all tensors on one CUDA device). Lanes that
    pass the cutoff but overflow the first run budget are re-launched
    with a budget of ND + 4, a hard bound on the runs of any alignment,
    so no lane is left overflowed."""
    P, Lr = reads.shape
    Lw = wins.shape[1]
    if P == 0:
        return _empty_align()
    _check_problems("dp_align_cuda", reads, wins, rlens, wlens, clip_l,
                    clip_r, anchor_l, anchor_r, cutoff)
    reads = reads.to(torch.uint8).contiguous()
    wins = wins.to(torch.uint8).contiguous()
    params = _params(rlens, wlens, clip_l, clip_r, anchor_l, anchor_r, cutoff)
    mr = max(MAX_RUNS, _max_runs_bound(Lr))
    stats, ops_d, cnts_d = _launch_dp(reads, wins, params, mr, sc)
    st = stats.cpu().numpy()
    cut = cutoff.cpu().numpy()
    redo = (st[:, 6] != 0) & (st[:, 0] >= cut)
    if redo.any():
        sel = torch.from_numpy(np.flatnonzero(redo)).to(reads.device)
        mr2 = Lr + Lw + 4
        st2, ops2, cnts2 = _launch_dp(reads[sel], wins[sel], params[sel],
                                      mr2, sc)
        ops_d = torch.nn.functional.pad(ops_d, (0, mr2 - mr))
        cnts_d = torch.nn.functional.pad(cnts_d, (0, mr2 - mr))
        ops_d[sel] = ops2
        cnts_d[sel] = cnts2
        st[redo] = st2.cpu().numpy()
        mr = mr2
    score, nrun = st[:, 0], st[:, 5]
    ops = np.zeros((P, mr), np.int32)
    cnts = np.zeros((P, mr), np.int32)
    pass_idx = np.flatnonzero((score >= cut) & (nrun > 0))
    if len(pass_idx):
        g = torch.from_numpy(pass_idx).to(reads.device)
        ops[pass_idx] = ops_d[g].cpu().numpy()
        cnts[pass_idx] = cnts_d[g].cpu().numpy()
    return (score, st[:, 1], st[:, 2], st[:, 3], ops, cnts, nrun,
            st[:, 4].astype(np.int64), st[:, 6].astype(bool))


def dp_align_wide(reads, rlens, wins, wlens, clip_l, clip_r, anchor_l,
                  anchor_r, cutoff, sc: DPScores = DPScores()):
    """dp_align through K2 and the traceback kernel (all tensors on one
    CUDA device): the reference's route for windows of FUSED_MAX_WINDOW
    and more. The problem axis goes in chunks whose directions fit
    _DIRS_BUDGET; one buffer serves every chunk, each traced before the
    next forward."""
    P, Lr = reads.shape
    Lw = wins.shape[1]
    if P == 0:
        return _empty_align()
    _check_problems("dp_align_wide", reads, wins, rlens, wlens, clip_l,
                    clip_r, anchor_l, anchor_r, cutoff)
    dev = reads.device
    reads = reads.to(torch.uint8).contiguous()
    wins = wins.to(torch.uint8).contiguous()
    params = _params(rlens, wlens, clip_l, clip_r, anchor_l, anchor_r)
    ND, Lr1 = Lr + Lw, Lr + 1
    chunk = max(1, min(P, _DIRS_BUDGET // (ND * Lr1)))
    buf = torch.empty(ND * chunk * Lr1, dtype=torch.uint8, device=dev)
    st = np.zeros((P, 4), np.int32)
    nrun = np.zeros(P, np.int32)
    startj = np.zeros(P, np.int64)
    parts = []
    for p0 in range(0, P, chunk):
        p1 = min(P, p0 + chunk)
        dirs = buf[: ND * (p1 - p0) * Lr1].view(ND, p1 - p0, Lr1)
        stats = _launch_forward(reads[p0:p1], wins[p0:p1], params[p0:p1],
                                dirs, sc)
        o, c, nrun[p0:p1], startj[p0:p1] = _traceback_cuda(
            dirs, rlens[p0:p1], stats[:, 1], stats[:, 2], clip_l[p0:p1],
            stats[:, 0] >= cutoff[p0:p1])
        st[p0:p1] = stats.cpu().numpy()
        parts.append((p0, p1, o, c))
    mr = max(o.shape[1] for _, _, o, _ in parts)
    ops = np.zeros((P, mr), np.int32)
    cnts = np.zeros((P, mr), np.int32)
    for p0, p1, o, c in parts:
        ops[p0:p1, : o.shape[1]] = o
        cnts[p0:p1, : c.shape[1]] = c
    return (st[:, 0], st[:, 1], st[:, 2], st[:, 3], ops, cnts, nrun, startj,
            np.zeros(P, bool))


def takes_wide_route(Lr: int, Lw: int) -> bool:
    """Whether dp_align takes K2 + traceback (else K1) on CUDA: where the
    reference leaves its fused kernel for dp_forward's Pallas kernel
    (a window of FUSED_MAX_WINDOW or more, and Lr + 1 <= 128)."""
    return Lw >= FUSED_MAX_WINDOW and Lr + 1 <= 128


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
    """dp_align over problems split into consecutive slices, each given
    as its nine dp_align inputs on one device. Each slice is aligned on
    its device in a host thread of its own (the wrappers wait on host
    copies per call, so one thread would run the devices one after the
    other; the ctypes launches release the interpreter lock), and the
    outputs are concatenated in problem order."""
    from soap3dp_tpu_torch.distributed.mesh import map_shards

    parts = map_shards([s[0].device for s in shards],
                       lambda j: dp_align(*shards[j], sc=sc))
    return parts[0] if len(parts) == 1 else _concat_align(parts)


def dp_align(reads, rlens, wins, wlens, clip_l, clip_r, anchor_l, anchor_r,
             cutoff, sc: DPScores = DPScores(), mesh=None):
    """Forward + traceback in one call; host-ready numpy results
    ``(score, hit_i, hit_j, n_best, ops, cnts, nrun, startj, overflow)``.

    ops/cnts are right-to-left CIGAR runs for every lane with
    score >= cutoff (others have nrun == 0); only the first nrun columns
    of a row are meaningful. On CUDA tensors a Hopper kernel runs (or
    raises): K2 + the traceback kernel where takes_wide_route, K1
    elsewhere. On CPU tensors the plain-torch version runs. With
    ``mesh`` (a distributed.mesh.DeviceMesh) the problem axis is split
    into near-equal consecutive slices, slice j aligned on the mesh's
    device j through the same choice (dp_align_shards)."""
    if mesh is not None and mesh.size > 1:
        args = [a.tensor_split(mesh.size) for a in
                (reads, rlens, wins, wlens, clip_l, clip_r, anchor_l,
                 anchor_r, cutoff)]
        return dp_align_shards(
            [[a[j].to(dev) for a in args]
             for j, dev in enumerate(mesh.devices)], sc)
    if reads.is_cuda:
        route = dp_align_wide if takes_wide_route(reads.shape[1],
                                                  wins.shape[1]) \
            else dp_align_cuda
        return route(reads, rlens, wins, wlens, clip_l, clip_r, anchor_l,
                     anchor_r, cutoff, sc)
    if reads.device.type != "cpu":
        raise ValueError(f"dp_align: no DP implementation for {reads.device}")
    return dp_align_plain(reads, rlens, wins, wlens, clip_l, clip_r,
                          anchor_l, anchor_r, cutoff, sc)
