"""DP rescue: seeding, candidate windows, batched banded DP, results.

Port of soap3dp_tpu/pipeline/dp_rescue.py. The seed matrices and the
result containers are the reference's numpy code; the device halves run
on the index's device: ``_seed_cand_batch`` (the seeds' backward search,
lane expansion and SA decode through fmindex, the FS1 and FS2s kernels
on the card), ``_prescan_impl`` (the GP kernel on the card,
``_prescan_plain`` on the CPU; ``_PRESCAN_CHUNK`` bounds the plain
version's (M, O) matrix only) and ``_pack_problems`` (the PK kernel on
the card, ``_pack_problems_plain`` on the CPU); and ``run_banded_dp``
uploads the rows its problems name and calls the port's ``dp_align``
(the Hopper kernels on CUDA, their plain versions on CPU), one slice of
problems per device on a mesh.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from soap3dp_tpu_torch.index.builder import Index
from soap3dp_tpu_torch.utils import shapes, timers
from soap3dp_tpu_torch.distributed import mesh as dmesh
from soap3dp_tpu_torch.fm import fmindex
from soap3dp_tpu_torch.fm.fmindex import DeviceIndex, to_device
from soap3dp_tpu_torch.kernels import fm_search
from soap3dp_tpu_torch.kernels.banded_dp import DPScores, dp_align_shards

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
    Returns (row, pos, valid, total) tensors: row is the oriented row
    id, pos the candidate read-start text position."""
    S = seed_pos.shape[1]
    lens = lens.to(torch.int64)
    ori = fmindex.OrientedReads.of(reads, lens)
    sp = torch.cat([seed_pos, seed_pos], dim=0).to(torch.int64)
    sl2 = torch.cat([seed_len, seed_len]).to(torch.int64)
    ln2 = torch.cat([lens, lens])
    sp = torch.minimum(sp, (ln2 - sl2).clamp(min=0)[:, None])
    slen_arr = torch.minimum(sl2, ln2)[:, None].expand(sp.shape)
    l, r = fmindex.seed_intervals(idx, ori, S, sp.reshape(-1),
                                  slen_arr.reshape(-1), max_steps, "general")
    # each lane's candidates (its width clamped to occ_cap) expanded into
    # K slots in lane order and decoded (FS2s on the card)
    cnt = (r - l).clamp(0, occ_cap)
    incl = torch.cumsum(cnt, 0)
    row, pos, valid = fmindex.seed_expand_decode(idx, l, incl, sp.reshape(-1),
                                                 S, K)
    return row, pos, valid, incl[-1]


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
                row, pos, valid, total = _seed_cand_batch(
                    replicas[j], *(a[j] for a in shards), occ_cap, max_steps,
                    min(K, K_max))
                t = int(total)
                if t <= K or K >= K_max:
                    break
                K = min(shapes.bucket(t), K_max)
            tb = min(shapes.bucket(t, min_size=1024), min(K, K_max))
            return torch.stack([row[:tb], pos[:tb],
                                valid[:tb].to(torch.int64)]).cpu().numpy()

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


def _prescan_impl(idx: DeviceIndex, reads_p: torch.Tensor,
                  lens_rows: torch.Tensor, read_idx: torch.Tensor,
                  strand: torch.Tensor, ws: torch.Tensor,
                  rlens: torch.Tensor, wlens: torch.Tensor, O: int, W: int
                  ) -> torch.Tensor:
    """Mismatch counts mm[m, o] of read ``read_idx[m]`` (its reverse
    complement of ``lens_rows`` bases where ``strand[m] == 1``) placed
    gapless at offset o of the genome window [ws[m], ws[m] + W), over
    its first rlens[m] bases; offsets past wlens[m] - rlens[m] score
    1 << 20. Returns (M, 3) [min_mm, leftmost best offset, #zero-mismatch
    offsets]. GP on CUDA tensors (no (M, O) matrix), _prescan_plain on
    CPU tensors."""
    if reads_p.is_cuda:
        B, Lr = reads_p.shape
        if W < O + Lr - 1:
            raise ValueError(f"prescan: a window of {W} bases cannot hold "
                             f"{O} offsets of {Lr}-base reads")
        src = fm_search.oriented_rows(reads_p.contiguous(), Lr,
                                      fmindex._i64(lens_rows))
        rows = fmindex._i64(read_idx) + B * (strand == 1).to(torch.int64)
        return fm_search.prescan(idx, src, rows, fmindex._i64(ws),
                                 fmindex._i64(rlens), fmindex._i64(wlens), O)
    fmindex._require_cpu("_prescan_impl", reads_p)
    return _prescan_plain(idx, reads_p, lens_rows, read_idx, strand, ws,
                          rlens, wlens, O, W)


def _prescan_plain(idx: DeviceIndex, reads_p: torch.Tensor,
                   lens_rows: torch.Tensor, read_idx: torch.Tensor,
                   strand: torch.Tensor, ws: torch.Tensor,
                   rlens: torch.Tensor, wlens: torch.Tensor, O: int, W: int
                   ) -> torch.Tensor:
    """The plain version of _prescan_impl: Lr shift-and-add steps over
    the (M, O) matrix of mismatch counts."""
    rc = fmindex.revcomp_reads(reads_p, lens_rows)
    oriented = torch.where(strand[:, None] == 1, rc[read_idx],
                           reads_p[read_idx])
    wins = fmindex.extract_genome(idx, ws, W)
    M, Lr = oriented.shape
    rlens = rlens.to(torch.int64)
    mm = torch.zeros((M, O), dtype=torch.int32, device=reads_p.device)
    for l in range(Lr):
        ne = (wins[:, l:l + O] != oriented[:, l:l + 1]) & (l < rlens)[:, None]
        mm += ne.to(torch.int32)
    o = torch.arange(O, device=mm.device)[None, :]
    valid = o <= (wlens.to(torch.int64) - rlens)[:, None]
    mm = torch.where(valid, mm, 1 << 20)
    min_mm = mm.min(dim=1).values
    best = torch.argmax((mm == min_mm[:, None]).to(torch.int32), dim=1)
    n0 = (mm == 0).sum(dim=1)
    return torch.stack([min_mm.to(torch.int64), best, n0], dim=1)


def gapless_prescan(idx: DeviceIndex, reads: np.ndarray, lens: np.ndarray,
                    cand: Candidates, win_start: np.ndarray,
                    win_len: np.ndarray, max_win: int
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-candidate best gapless placement in the window: (min_mm,
    leftmost best offset, #0-mismatch offsets). A candidate with
    min_mm == 0 scores the global maximum L*match, so the caller may
    emit it without running DP."""
    M = cand.read.shape[0]
    if M == 0:
        z = np.zeros(0, np.int32)
        return z, z, z
    dev = idx.device
    B, L = reads.shape
    O = shapes.bucket_multiple(max_win, 128)
    W = O + ((L + 127) // 128) * 128
    lens_rows = np.zeros(B, np.int32)
    lens_rows[cand.read] = np.asarray(lens, np.int32)[:M]
    reads_d = to_device(np.asarray(reads), dev)
    lens_rows_d = to_device(lens_rows, dev)
    outs = []
    # the plain version's (M, O) matrix is cut into chunks; GP holds none
    chunk = M if dev.type == "cuda" else _PRESCAN_CHUNK
    for s0 in range(0, M, chunk):
        sl = slice(s0, min(s0 + chunk, M))
        outs.append(_prescan_impl(
            idx, reads_d, lens_rows_d,
            to_device(cand.read[sl].astype(np.int64), dev),
            to_device(cand.strand[sl].astype(np.int8), dev),
            to_device(np.asarray(win_start[sl], np.int64), dev),
            to_device(np.asarray(lens[sl], np.int32), dev),
            to_device(np.asarray(win_len[sl], np.int32), dev), O, W))
    out = torch.cat(outs).cpu().numpy()
    return (out[:, 0].astype(np.int32), out[:, 1].astype(np.int32),
            out[:, 2].astype(np.int32))


def _pack_problems(idx: DeviceIndex, reads: torch.Tensor, lens: torch.Tensor,
                   cread: torch.Tensor, strand_rev: torch.Tensor,
                   win_start: torch.Tensor, un: int, max_win: int):
    """Device pack of DP problems: orient reads per candidate strand
    (read cread[p], or its reverse complement of lens[cread[p]] bases
    where strand_rev[p]) and extract the genome windows of max_win bases
    at win_start: ((P, L), (P, max_win)) uint8. ``un``, where not 0, is
    the length of every read (the plain version's uniform branch; PK
    reads ``lens`` either way). PK on CUDA tensors (one launch, the read
    rows read in place), _pack_problems_plain on CPU tensors."""
    if reads.is_cuda:
        src = fm_search.oriented_rows(reads.contiguous(), reads.shape[1],
                                      fmindex._i64(lens))
        return fm_search.pack_problems(idx, src, fmindex._i64(cread),
                                       strand_rev, fmindex._i64(win_start),
                                       max_win)
    fmindex._require_cpu("_pack_problems", reads)
    return _pack_problems_plain(idx, reads, lens, cread, strand_rev,
                                win_start, un, max_win)


def _pack_problems_plain(idx: DeviceIndex, reads: torch.Tensor,
                         lens: torch.Tensor, cread: torch.Tensor,
                         strand_rev: torch.Tensor, win_start: torch.Tensor,
                         un: int, max_win: int):
    """The plain version of _pack_problems: the batch's reverse
    complement gathered by strand, and extract_genome."""
    rc = fmindex.revcomp_reads_uniform(reads, un) if un \
        else fmindex.revcomp_reads(reads, lens)
    oriented = torch.where(strand_rev[:, None], rc[cread], reads[cread])
    wins = fmindex.extract_genome(idx, win_start, max_win)
    return oriented, wins


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
    (dp_align_shards). Only the read rows a slice's problems name are
    uploaded (cread indexes them)."""
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
    rlen = lens[cand.read].astype(np.int32)
    cutoff32 = np.minimum(cutoff, 1 << 20).astype(np.int32)
    Ms = M_pad // n
    shards = []
    with timers.stage("dp.pack"):
        # replica j packs slice j's problems on its device (enqueued only)
        for j, rep in enumerate(replicas):
            dev = rep.device
            sl = slice(j * Ms, (j + 1) * Ms)

            def d32(a):
                return to_device(np.asarray(a[sl], np.int32), dev)

            # only the read rows the slice's problems name go up
            rows, cread = np.unique(cand.read[sl], return_inverse=True)
            rlens = lens[rows].astype(np.int64)
            un = int(rlens[0]) if (rlens == rlens[0]).all() else 0
            oriented, wins = _pack_problems(
                rep, to_device(reads[rows], dev), to_device(rlens, dev),
                to_device(cread.astype(np.int64), dev),
                to_device(cand.strand[sl] == 1, dev),
                to_device(np.asarray(win_start[sl], np.int64), dev), un,
                max_win)
            shards.append((oriented, d32(rlen), wins, d32(win_len),
                           d32(clip_l), d32(clip_r), d32(anchor_l),
                           d32(anchor_r), d32(cutoff32)))
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
