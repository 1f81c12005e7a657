"""DP rescue: seeding, candidate windows, batched banded DP, results.

Port of soap3dp_tpu/pipeline/dp_rescue.py. The seed matrices and the
result containers are the reference's numpy code; the device halves run
on the index's device: ``_seed_cand_batch`` (the seeds' backward search,
their counts' scan, the lane expansion and SA decode through fmindex,
the FS1, FS5 and FS2s kernels on the card, the candidates fetched as
one packed vector of u32 words), ``_prescan_impl`` (the GP kernel on
the card, ``_prescan_plain`` on the CPU; ``_PRESCAN_CHUNK`` bounds the plain
version's (M, O) matrix only) and ``_pack_problems`` (the PK kernel on
the card, ``_pack_problems_plain`` on the CPU), both given their
candidates or problems as one block of words packed on the host
(``rescue_words``); and ``run_banded_dp`` uploads the rows its problems
name, their (P, 8) problem rows and PK's words in one copy, and calls
the port's ``dp_align_packed`` (the Hopper kernels on CUDA, their plain
versions on CPU), one slice of problems per device on a mesh.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from soap3dp_tpu_torch.index.builder import Index
from soap3dp_tpu_torch.utils import shapes, timers
from soap3dp_tpu_torch.distributed import mesh as dmesh
from soap3dp_tpu_torch.fm import fmindex
from soap3dp_tpu_torch.fm.fmindex import DeviceIndex, stage_to_device
from soap3dp_tpu_torch.kernels import fm_search
from soap3dp_tpu_torch.kernels.banded_dp import (DPScores, dp_align_shards,
                                                 pack_params)

MERGE_GAP = 50  # candidates within 50bp collapse (DP2_DIVIDE_GAP)
_PRESCAN_CHUNK = 1 << 14  # candidates a plain prescan pass (bounds memory)


def dp_margin(rlen: np.ndarray) -> np.ndarray:
    """DPS_MARGIN / DP2_MARGIN: l/4 for l > 100, else 25."""
    rlen = np.asarray(rlen)
    return np.where(rlen > 100, rlen >> 2, 25)


def single_dp_seed_matrix(lens: np.ndarray, max_len: int, halved: bool = False
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Per-read seed (positions (B,S), lengths (B,)) for single-end DP
    seeding (getSeedPositions STAGE_SINGLE_DP, definitions.h:323-377)."""
    lens = np.asarray(lens, np.int64)
    slen = np.select([lens > 300, lens > 80, lens > 60, lens > 40],
                     [70, 38, 32, 26], 22).astype(np.int64)
    trim = np.select([lens > 300, lens > 80, lens > 60, lens > 40],
                     [(lens * 0.15).astype(np.int64), 10, 4, 4], 0)
    h = np.where(lens > 300, (lens * 0.15).astype(np.int64), 0)
    num = np.where(lens > 120, 3 + lens // 100, 3)
    S = int(3 + (max_len // 100 if max_len > 120 else 0))
    i = np.arange(S, dtype=np.int64)[None, :]
    apart = (lens - trim - h) // np.maximum(num, 1)
    pos = h[:, None] + i * apart[:, None]
    last = np.minimum(h + (num - 1) * apart, lens - slen - trim)
    pos = np.where(i < (num - 1)[:, None], pos, last[:, None])
    pos = np.clip(pos, 0, np.maximum(lens - slen, 0)[:, None])
    if halved:
        half = slen // 2
        pos = np.concatenate([pos, pos + half[:, None]], axis=1)
        return pos.astype(np.int32), half.astype(np.int32)
    return pos.astype(np.int32), slen.astype(np.int32)


def deep_dp_seed_matrix(lens: np.ndarray, max_len: int, round2: bool = False,
                        halved: bool = False
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Per-read seed matrix for deep-DP seeding (getSeedPositions
    STAGE_DEEP_DP_ROUND1/2, definitions.h:378-441); ``halved`` replaces
    each seed by its two exact halves (1-mismatch pigeonhole)."""
    lens = np.asarray(lens, np.int64)
    table = [52, 30, 28, 26, 24] if round2 else [45, 26, 24, 22, 20]
    slen = np.select([lens > 150, lens > 80, lens > 60, lens > 40],
                     table[:4], table[4]).astype(np.int64)
    num = np.maximum(2, lens // np.maximum(slen, 1))
    r = np.arange(1, max(max_len, 2) + 1, dtype=np.int64)
    sl_r = np.select([r > 150, r > 80, r > 60, r > 40], table[:4], table[4])
    S = int(np.maximum(2, r // sl_r).max())
    i = np.arange(S, dtype=np.int64)[None, :]
    apart = np.maximum((lens - slen) // np.maximum(num - 1, 1), 1)
    pos = np.minimum(i * apart[:, None],
                     np.maximum(lens - slen, 0)[:, None])
    last = np.minimum((num - 1) * apart, np.maximum(lens - slen, 0))
    pos = np.where(i < num[:, None], pos, last[:, None])
    if halved:
        half = slen // 2
        pos = np.concatenate([pos, pos + half[:, None]], axis=1)
        return pos.astype(np.int32), half.astype(np.int32)
    return pos.astype(np.int32), slen.astype(np.int32)


@dataclasses.dataclass
class Candidates:
    """Candidate alignment loci: (read index into the subset, strand, pos)."""

    read: np.ndarray    # (M,) int32 — indices into the *subset* arrays
    strand: np.ndarray  # (M,) int8
    pos: np.ndarray     # (M,) int64 candidate read-start text position


def _seed_cand_batch(idx: DeviceIndex, reads: torch.Tensor,
                     lens: torch.Tensor, seed_pos: torch.Tensor,
                     seed_len: torch.Tensor, occ_cap: int, max_steps: int,
                     K: int):
    """Device half of seed_candidates: search + compacted SA decode.
    Returns (packed, total): packed the (3K,) int32 bit patterns of the
    reference's u32 words [row | pos | valid], row the oriented row id,
    pos the candidate read-start text position (0 where not valid);
    total the candidates before K (0-dim). The seeds' clamps into each
    read (the reference's concatenates, minimums and clamps) are made by
    FS1 and FS2s from the B reads' seed_pos, seed_len and lens as they
    load them (fmindex.SeedLanes.staged)."""
    S = seed_pos.shape[1]
    ori = fmindex.OrientedReads.of(reads, lens)
    seeds = fmindex.SeedLanes.staged(seed_pos, seed_len, lens)
    l, r = fmindex.seed_intervals(idx, ori, S, seeds, max_steps, "general")
    # each lane's candidates (its width clamped to occ_cap) counted and
    # scanned (FS5), expanded into K slots in lane order and decoded
    # (FS2s) on the card
    incl, total = fmindex.lane_counts(l, r, occ_cap, S)
    packed = fmindex.seed_expand_decode(idx, l, incl, seeds, S, K)
    return packed, total


def _prefix_to_host(packed: torch.Tensor, K: int, n: int) -> np.ndarray:
    """The first n words of each third of ``packed`` (3K,) as one host
    (3, n) uint32 array, in one transfer: on the card one 2-D copy into
    pinned memory (fm_search.copy_prefix, no kernel), then a wait on the
    card's stream."""
    if not packed.is_cuda:
        return packed.view(3, K)[:, :n].numpy().view(np.uint32)
    host = fm_search.copy_prefix(packed, 3, n)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(packed.device))
    done.synchronize()
    return host.numpy().view(np.uint32)


def seed_candidates(idx: DeviceIndex, reads: np.ndarray, lens: np.ndarray,
                    seed_pos: np.ndarray, seed_len: np.ndarray,
                    occ_cap: int = 64, merge_gap: int = MERGE_GAP
                    ) -> Candidates:
    """Exact-search the staged seeds on both strands, decode, merge. On a
    mesh the reads are padded to a mesh multiple (copies of read 0,
    whose candidates are dropped) and each replica seeds its shard; the
    merge sorts, so the candidates do not depend on the split."""
    B_real, L = reads.shape
    if B_real == 0:
        return Candidates(np.zeros(0, np.int32), np.zeros(0, np.int8),
                          np.zeros(0, np.int64))
    replicas = dmesh.replicas_of(idx)
    devices = [r.device for r in replicas]
    n = len(replicas)
    B = dmesh.pad_to_mesh(dmesh.mesh_of(idx), B_real)
    S = seed_pos.shape[1]
    seed_len = np.asarray(seed_len, np.int32)
    msl = int(seed_len.max()) if seed_len.size else 0
    max_steps = max(msl - idx.lut_k, min(idx.lut_k, msl))
    # budgets of the whole batch, split evenly over the shards
    K0 = -(-shapes.bucket(2 * B * S * 2, min_size=1024) // n)
    K_max = 2 * B * S * occ_cap // n
    Bs = B // n
    with timers.stage("dp.seed_cand"):
        shards = [dmesh.split_rows(devices, shapes.pad_rows(np.asarray(a), B))
                  for a in (reads, np.asarray(lens, np.int32),
                            np.asarray(seed_pos, np.int32), seed_len)]

        def shard(j):
            K = K0
            while True:
                packed, total = _seed_cand_batch(
                    replicas[j], *(a[j] for a in shards), occ_cap, max_steps,
                    min(K, K_max))
                t = int(total)
                if t <= K or K >= K_max:
                    break
                K = min(shapes.bucket(t), K_max)
            # a bucketed prefix of each third (the expansion's pad slots
            # are at the end), in one transfer
            Kc = min(K, K_max)
            tb = min(shapes.bucket(t, min_size=1024), Kc)
            return _prefix_to_host(packed, Kc, tb)

        parts = dmesh.map_shards(devices, shard)
    read, strand, posf = [], [], []
    for j, ph in enumerate(parts):
        vald = ph[2].astype(bool)
        rowf = ph[0].astype(np.int32)[vald]
        st = (rowf >= Bs).astype(np.int8)
        read.append((rowf - st.astype(np.int32) * Bs + j * Bs).astype(np.int32))
        strand.append(st)
        posf.append(ph[1][vald].astype(np.int64))
    read, strand, posf = (np.concatenate(x) for x in (read, strand, posf))
    keep = read < B_real  # drop mesh-padding rows
    read, strand, posf = read[keep], strand[keep], posf[keep]
    # merge: sort by (read, strand, pos); drop candidates within merge_gap
    order = np.lexsort((posf, strand, read))
    read, strand, posf = read[order], strand[order], posf[order]
    if read.size:
        same = ((np.diff(read) == 0) & (np.diff(strand) == 0)
                & (np.diff(posf) < merge_gap))
        keep = np.concatenate([[True], ~same])
        read, strand, posf = read[keep], strand[keep], posf[keep]
    return Candidates(read=read, strand=strand, pos=posf)


def rescue_words(read, rev, ws, rc_len, *more) -> np.ndarray:
    """The words of GP's candidates and PK's problems, packed on the
    host: row i is (read[i] | rev[i] << 31, ws[i]'s low and high 32
    bits, rc_len[i], then each of ``more``), as the int32 bit patterns
    of u32 words. ``read`` indexes the rows (below 2^31), ``rev`` (bool)
    takes its reverse complement of rc_len[i] bases, ``ws`` is the
    window start (0 <= ws < 2^63); rc_len and ``more`` (GP: the counted
    bases, the window's length) are int32 values."""
    read, ws = np.asarray(read, np.int64), np.asarray(ws, np.int64)
    cols = [read | (np.asarray(rev, bool).astype(np.int64) << 31), ws,
            ws >> 32, rc_len, *more]
    words = np.empty((len(read), len(cols)), np.uint32)
    for k, c in enumerate(cols):
        words[:, k] = np.asarray(c, np.int64) & 0xFFFFFFFF
    return words.view(np.int32)


def rescue_fields(words: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """rescue_words decoded (the plain versions' and the tools' reading of
    GP's and PK's words): (read, rev, ws, rc_len, *more), int64 but rev
    (bool); rc_len and ``more`` signed."""
    u = words[:, :3].to(torch.int64) & 0xFFFFFFFF
    return ((u[:, 0] & 0x7FFFFFFF), (u[:, 0] >> 31) == 1,
            u[:, 1] | (u[:, 2] << 32),
            *(words[:, k].to(torch.int64) for k in range(3, words.shape[1])))


def _oriented(reads: torch.Tensor, read: torch.Tensor, rev: torch.Tensor,
              rc_len: torch.Tensor) -> torch.Tensor:
    """The plain versions' oriented rows: row read[i], or its reverse
    complement of rc_len[i] bases where rev[i]."""
    rows = reads[read]
    return torch.where(rev[:, None], fmindex.revcomp_reads(rows, rc_len),
                       rows)


def _prescan_impl(idx: DeviceIndex, reads_p: torch.Tensor,
                  words: torch.Tensor, O: int, W: int) -> torch.Tensor:
    """Mismatch counts mm[m, o] of candidate m's oriented row (its read,
    or that read's reverse complement of rc_len bases) placed gapless at
    offset o of the genome window [ws, ws + W), over its first rlen
    bases; offsets past wlen - rlen score 1 << 20. ``words`` is the
    (M, 6) int32 block of rescue_words (read, strand, ws, rc_len, rlen,
    wlen). Returns (M, 3) int32 [min_mm, leftmost best offset,
    #zero-mismatch offsets]. GP on CUDA tensors (no (M, O) matrix; the
    row index, the start and the lengths read from the words in the
    kernel), _prescan_plain on CPU tensors."""
    if reads_p.is_cuda:
        Lr = reads_p.shape[1]
        if W < O + Lr - 1:
            raise ValueError(f"prescan: a window of {W} bases cannot hold "
                             f"{O} offsets of {Lr}-base reads")
        return fm_search.prescan(
            idx, fm_search.oriented_rows(reads_p, Lr, None), words, O)
    fmindex._require_cpu("_prescan_impl", reads_p)
    return _prescan_plain(idx, reads_p, words, O, W)


def _prescan_plain(idx: DeviceIndex, reads_p: torch.Tensor,
                   words: torch.Tensor, O: int, W: int) -> torch.Tensor:
    """The plain version of _prescan_impl: the words decoded, then Lr
    shift-and-add steps over the (M, O) matrix of mismatch counts."""
    read, rev, ws, rc_len, rlens, wlens = rescue_fields(words)
    oriented = _oriented(reads_p, read, rev, rc_len)
    wins = fmindex.extract_genome(idx, ws, W)
    M, Lr = oriented.shape
    mm = torch.zeros((M, O), dtype=torch.int32, device=reads_p.device)
    for l in range(Lr):
        ne = (wins[:, l:l + O] != oriented[:, l:l + 1]) & (l < rlens)[:, None]
        mm += ne.to(torch.int32)
    o = torch.arange(O, device=mm.device)[None, :]
    valid = o <= (wlens - rlens)[:, None]
    mm = torch.where(valid, mm, 1 << 20)
    min_mm = mm.min(dim=1).values
    best = torch.argmax((mm == min_mm[:, None]).to(torch.int32), dim=1)
    n0 = (mm == 0).sum(dim=1)
    return torch.stack([min_mm, best.to(torch.int32), n0.to(torch.int32)],
                       dim=1)


def gapless_prescan(idx: DeviceIndex, reads: np.ndarray, lens: np.ndarray,
                    cand: Candidates, win_start: np.ndarray,
                    win_len: np.ndarray, max_win: int
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-candidate best gapless placement in the window: (min_mm,
    leftmost best offset, #0-mismatch offsets). A candidate with
    min_mm == 0 scores the global maximum L*match, so the caller may
    emit it without running DP. A call uploads the reads and one block
    of the candidates' words (rescue_words) together (stage_to_device)
    and downloads one (M, 3) int32 result: on the card one copy each
    way, one GP launch and nothing else."""
    M = cand.read.shape[0]
    if M == 0:
        z = np.zeros(0, np.int32)
        return z, z, z
    dev = idx.device
    B, L = reads.shape
    O = shapes.bucket_multiple(max_win, 128)
    W = O + ((L + 127) // 128) * 128
    lens = np.asarray(lens, np.int32)[:M]
    # a reverse complement is as long as the last of its read's candidates
    # says (the reference's per-row lengths, assigned in candidate order)
    lens_rows = np.zeros(B, np.int32)
    lens_rows[cand.read] = lens
    words = rescue_words(cand.read, cand.strand == 1, win_start[:M],
                         lens_rows[cand.read], lens, win_len[:M])
    reads_d, words_d = stage_to_device([reads, words], dev)
    # the plain version's (M, O) matrix is cut into chunks; GP holds none
    chunk = M if dev.type == "cuda" else _PRESCAN_CHUNK
    outs = [_prescan_impl(idx, reads_d, words_d[s0:s0 + chunk], O, W)
            for s0 in range(0, M, chunk)]
    out = (outs[0] if len(outs) == 1 else torch.cat(outs)).cpu().numpy()
    return tuple(out.T.copy())


def _pack_problems(idx: DeviceIndex, reads: torch.Tensor,
                   words: torch.Tensor, max_win: int):
    """Device pack of DP problems: orient reads per candidate strand
    (row read, or its reverse complement of rc_len bases where its
    strand is reverse) and extract the genome windows of max_win bases
    at the window starts: ((P, L), (P, max_win)) uint8. ``words`` is
    the (P, 4) int32 block of rescue_words (read, strand, ws, rc_len).
    PK on CUDA tensors (one launch, the read rows read in place),
    _pack_problems_plain on CPU tensors."""
    if reads.is_cuda:
        src = fm_search.oriented_rows(reads, reads.shape[1], None)
        return fm_search.pack_problems(idx, src, words, max_win)
    fmindex._require_cpu("_pack_problems", reads)
    return _pack_problems_plain(idx, reads, words, max_win)


def _pack_problems_plain(idx: DeviceIndex, reads: torch.Tensor,
                         words: torch.Tensor, max_win: int):
    """The plain version of _pack_problems: the words decoded, each
    problem's row gathered and reverse-complemented by strand, and
    extract_genome."""
    read, rev, ws, rc_len = rescue_fields(words)
    return (_oriented(reads, read, rev, rc_len),
            fmindex.extract_genome(idx, ws, max_win))


@dataclasses.dataclass
class DPResult:
    """One DP alignment per surviving problem (arrays over problems)."""

    read: np.ndarray      # subset index
    strand: np.ndarray
    pos: np.ndarray       # absolute text position of the alignment start
    score: np.ndarray
    ops: np.ndarray       # (M, MAXRUNS) right-to-left run ops
    cnts: np.ndarray
    nrun: np.ndarray
    win_start: np.ndarray  # window origin (for MD reconstruction)
    n_best_cells: np.ndarray  # maxScoreCount within the window
    problem: np.ndarray   # index of the surviving input problem


def empty_dpresult() -> DPResult:
    z = np.zeros(0, np.int64)
    return DPResult(
        read=z.astype(np.int32), strand=z.astype(np.int8), pos=z,
        score=z.astype(np.int32), ops=np.zeros((0, 1), np.int32),
        cnts=np.zeros((0, 1), np.int32), nrun=np.zeros(0, np.int32),
        win_start=z, n_best_cells=z.astype(np.int32), problem=z)


def concat_dpresults(parts: list[DPResult]) -> DPResult:
    """Concatenate DPResults (ops/cnts right-padded to a common width)."""
    parts = [p for p in parts if p is not None and p.read.size]
    if not parts:
        return empty_dpresult()
    if len(parts) == 1:
        return parts[0]
    MR = max(p.ops.shape[1] for p in parts)

    def padw(a):
        return np.pad(a, ((0, 0), (0, MR - a.shape[1])))

    return DPResult(
        read=np.concatenate([p.read for p in parts]),
        strand=np.concatenate([p.strand for p in parts]),
        pos=np.concatenate([p.pos for p in parts]),
        score=np.concatenate([p.score for p in parts]),
        ops=np.concatenate([padw(p.ops) for p in parts]),
        cnts=np.concatenate([padw(p.cnts) for p in parts]),
        nrun=np.concatenate([p.nrun for p in parts]),
        win_start=np.concatenate([p.win_start for p in parts]),
        n_best_cells=np.concatenate([p.n_best_cells for p in parts]),
        problem=np.concatenate([p.problem for p in parts]))


def run_banded_dp(idx: DeviceIndex, reads: np.ndarray, lens: np.ndarray,
                  cand: Candidates, win_start: np.ndarray,
                  win_len: np.ndarray, max_win: int,
                  clip_l: np.ndarray, clip_r: np.ndarray,
                  anchor_l: np.ndarray, anchor_r: np.ndarray,
                  cutoff: np.ndarray, sc: DPScores,
                  index_host: Index | None = None) -> DPResult:
    """One batched DP over candidate windows; returns survivors only.
    Problem count and window width are bucketed (pad lanes get an
    unreachable cutoff, so they never survive). On a mesh the problem
    axis is padded to a mesh multiple and split evenly: each replica
    packs its slice's problems and aligns them on its device
    (dp_align_shards). A slice makes one upload (stage_to_device): the
    read rows its problems name, its (P, 8) problem rows and PK's words
    (rescue_words: the named row, the strand, the window start, the
    read's length)."""
    M_real = cand.read.shape[0]
    if M_real == 0:
        return empty_dpresult()
    replicas = dmesh.replicas_of(idx)
    n = len(replicas)
    reads, lens = np.asarray(reads), np.asarray(lens)
    M_pad = dmesh.pad_to_mesh(dmesh.mesh_of(idx),
                              shapes.bucket(M_real, min_size=128))
    max_win = shapes.bucket_multiple(max_win, 128)

    def pad(a):
        return shapes.pad_rows(np.asarray(a), M_pad, fill_from_first=False)

    cand = Candidates(read=pad(cand.read), strand=pad(cand.strand),
                      pos=pad(cand.pos))
    win_start, win_len = pad(win_start), pad(win_len)
    clip_l, clip_r = pad(clip_l), pad(clip_r)
    anchor_l, anchor_r = pad(anchor_l), pad(anchor_r)
    cutoff = np.concatenate([np.asarray(cutoff, np.int64),
                             np.full(M_pad - M_real, 1 << 20, np.int64)])
    # the kernels' problem rows, packed here; the cutoffs stay on the
    # host too, for the result wire's parse
    params = pack_params(lens[cand.read], win_len, clip_l, clip_r, anchor_l,
                         anchor_r, np.minimum(cutoff, 1 << 20))
    Ms = M_pad // n
    shards = []
    with timers.stage("dp.pack"):
        # replica j packs slice j's problems on its device (enqueued only)
        for j, rep in enumerate(replicas):
            dev = rep.device
            sl = slice(j * Ms, (j + 1) * Ms)
            # only the read rows the slice's problems name go up, with
            # the slice's problem rows and PK's words (a reverse
            # complement's length is its problem's, params column 0), in
            # one upload
            rows, cread = np.unique(cand.read[sl], return_inverse=True)
            words = rescue_words(cread, cand.strand[sl] == 1, win_start[sl],
                                 params[sl, 0])
            reads_d, params_d, words_d = stage_to_device(
                [reads[rows], params[sl], words], dev)
            oriented, wins = _pack_problems(rep, reads_d, words_d, max_win)
            shards.append((oriented, wins, params_d, params[sl, 6]))
    with timers.stage("dp.align"):
        score, hI, hJ, nbc, ops, cnts, nrun, startj, overflow = \
            dp_align_shards(shards, sc)
    passed = score >= cutoff
    if overflow.any():
        passed &= ~overflow
    if index_host is not None:
        # drop alignments whose reference span crosses a chromosome
        # boundary or an excluded ambiguity region
        from soap3dp_tpu_torch.io.sam import crosses_boundary
        end_j = hJ.astype(np.int64)
        span = np.maximum(end_j - startj, 1)
        passed &= ~crosses_boundary(
            index_host, (win_start + startj).astype(np.uint64), span)
    sel = np.flatnonzero(passed)
    return DPResult(
        read=cand.read[sel], strand=cand.strand[sel],
        pos=win_start[sel] + startj[sel], score=score[sel],
        ops=ops[sel], cnts=cnts[sel], nrun=nrun[sel],
        win_start=win_start[sel], n_best_cells=nbc[sel],
        problem=sel.astype(np.int64))
