"""Seed-and-verify k-mismatch search on torch tensors.

Port of soap3dp_tpu/fm/search.py: pigeonhole seeds, LUT-jumpstarted
backward search, lane expansion, SA decode, scatter-min hash dedupe
and packed XOR/popcount verification, with the same two/three-round
budget escalation. Results are element-for-element those of the
reference (same slot order, same hash, same dedupe winners).

A dispatch (``_search_batch_wire``) reads nothing back to the host (no
``.item()``, no ``nonzero``, no ``.cpu()``), so on a CUDA device its
work is only enqueued and batch i+1's search overlaps batch i's host
work; ``PendingSearch.result()`` is the one synchronisation point, and
the dispatch's one transfer is the reference's u32 result wire (8 bytes
a unique-placement slot, a bit a read), decoded by ``_parse_wire``. On
the card the kernels of kernels/fm_search.py do the device work: the
backward search and the verify read the packed reads in place, one
kernel counts the lanes' candidates, scans them and writes the wire's
flagged words (fmindex.lane_counts), one SA-decode kernel takes each of
the K candidate slots from that scan to its dedupe keys
(fmindex.expand_decode), the dedupe kernel (fmindex.dedupe) writes the
first occurrences in slot order, and one kernel tests the hits and
writes the rest of the wire (fmindex.search_wire), so the reference's
compaction (a scatter-max and a cummax over the slots), its scatter-min,
its nonzero, its cumsum and its packing run only in the plain versions
on the CPU. No library kernel runs in a dispatch: the seeds' bounds are
made in the kernels from the reads' lengths (fmindex.SeedLanes), the
verify takes the dedupe's outputs as they are, and the batch's int32
lengths cross to the card once.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from soap3dp_tpu_torch.utils import shapes, timers
from soap3dp_tpu_torch.distributed import mesh as dmesh
from soap3dp_tpu_torch.fm import fmindex
from soap3dp_tpu_torch.fm.fmindex import ROW_SENTINEL, DeviceIndex
from soap3dp_tpu_torch.kernels import fm_search


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Search parameters (see the reference SearchConfig for the
    measurements behind each default)."""

    k: int = 2
    occ_cap: int = 16
    occ_cap_round2: int = 256
    occ_cap_round3: int = 4096
    seed_slack: int = 2
    escalate_budget: int = 8192

    @property
    def num_seeds(self) -> int:
        return self.k + 1


@dataclasses.dataclass
class HitArrays:
    """Compacted struct-of-arrays hit set: (oriented row, text position,
    mismatch count), row b = read b forward, row B + b = its reverse
    complement. Fields are torch tensors (device) or numpy (host)."""

    row: object
    tp: object
    nmis: object
    valid: object
    flagged: object

    def to_host(self):
        """(row int32, tp uint32, nmis int32, valid bool, flagged bool)
        as numpy arrays."""
        def h(x):
            return x.cpu().numpy() if isinstance(x, torch.Tensor) \
                else np.asarray(x)
        return (h(self.row).astype(np.int32), h(self.tp).astype(np.uint32),
                h(self.nmis).astype(np.int32), h(self.valid).astype(bool),
                h(self.flagged).astype(bool))


def pack_read_matrix(reads: np.ndarray) -> np.ndarray:
    """Host-side 2-bit pack of (B, L) codes into (B, ceil(L/16)) uint32
    (byte 0 = codes 0-3, little-endian words)."""
    B, L = reads.shape
    W = (L + 15) // 16
    padded = np.zeros((B, W * 16), np.uint8)
    padded[:, :L] = reads
    by = (padded[:, 0::4] | (padded[:, 1::4] << 2)
          | (padded[:, 2::4] << 4) | (padded[:, 3::4] << 6))
    return np.ascontiguousarray(by).view("<u4")


@dataclasses.dataclass
class _Stages:
    """One dispatch's device results before its hit test: the batch's B
    reads, the total candidates (0-dim), the flagged words (int32
    (ceil(B / 32),)), the unique placements (urow, utp, uvalid) and
    their count uniq (0-dim), and each placement's mismatches nmis."""

    B: int
    total: torch.Tensor
    flags: torch.Tensor
    urow: torch.Tensor
    utp: torch.Tensor
    uvalid: torch.Tensor
    uniq: torch.Tensor
    nmis: torch.Tensor


def _search_stages(idx: DeviceIndex, reads: torch.Tensor,
                   lens: torch.Tensor, cfg: SearchConfig, cap: int,
                   max_seed_steps: int, seed_q: int, K: int, L: int, K2: int,
                   uniform_len: int, seed_lo: int, seed_hi: int,
                   wire: torch.Tensor | None = None) -> _Stages:
    """The device stages of one seed search dispatch (see _search_batch)
    up to the verify. With ``wire`` (the dispatch's int32 result wire)
    the flagged words are written into its words 2 .. 1 + ceil(B / 32)."""
    ori = fmindex.OrientedReads.of(reads, lens, L, uniform_len)
    B, L = ori.B, ori.L
    R = 2 * B
    if K <= 0:
        K = R * cfg.num_seeds * cap
    if K2 <= 0:
        K2 = K
    if seed_hi <= 0:
        seed_hi = cfg.num_seeds
    # pigeonhole segments seed_lo .. seed_hi - 1 of each read, truncated
    # to seed_q (the reference's _seed_bounds), S lanes a row
    S = seed_hi - seed_lo
    seeds = fmindex.SeedLanes.pigeonhole(lens, cfg.num_seeds, seed_lo, seed_q)
    if seed_q == idx.lut_k and max_seed_steps == 0:
        mode = "lut"      # LUT-only seeds: one table lookup per lane
    elif 0 < seed_q <= idx.lut_k + 16 and idx.lut_k <= 16:
        mode = "packed"   # the extension window fits one 16-base word
    else:
        mode = "general"
    l, r = fmindex.seed_intervals(idx, ori, S, seeds, max_seed_steps, mode)

    # each lane's candidates (its width, none past cap, where its read is
    # flagged) counted and scanned, expanded into K slots in lane order
    # and decoded
    nf = fm_search.flag_words(B)
    flags = (wire[2:2 + nf] if wire is not None else
             torch.empty(nf, dtype=torch.int32, device=l.device))
    incl, total, _ = fmindex.lane_counts(l, r, cap, S, flags)
    krow, ktp, pos_ok = fmindex.expand_decode(idx, l, incl, seeds, S, K)

    # scatter-min hash dedupe of (row, tp) before verification
    urow, utp, uvalid, uniq = fmindex.dedupe(krow, ktp, pos_ok, K2)

    # verify unique placements in the packed domain (rows clamped, tp 0
    # where not valid, each row's read length: the verify's own loads)
    nmis = fmindex.count_mismatches_rows(idx, utp, ori, urow, lens, uvalid)
    return _Stages(B, total, flags, urow, utp, uvalid, uniq, nmis)


def _search_batch(idx: DeviceIndex, reads: torch.Tensor, lens: torch.Tensor,
                  cfg: SearchConfig, cap: int, max_seed_steps: int,
                  seed_q: int = 0, K: int = 0, L: int = 0, K2: int = 0,
                  uniform_len: int = 0, seed_lo: int = 0, seed_hi: int = 0
                  ) -> tuple[HitArrays, torch.Tensor]:
    """One seed search dispatch. ``reads`` is a (B, L) uint8 code matrix
    or (B, W) int32 packed words (then L is given). Returns device
    HitArrays and the (total candidates, unique placements) pair: the
    reference's _search_batch, for callers that keep its arrays on the
    device; the search's own dispatches fetch _search_batch_wire."""
    st = _search_stages(idx, reads, lens, cfg, cap, max_seed_steps, seed_q,
                        K, L, K2, uniform_len, seed_lo, seed_hi)
    hit_ok = st.uvalid & (st.nmis <= cfg.k)
    shift = torch.arange(32, device=st.flags.device)
    flagged = ((st.flags.to(torch.int64)[:, None] >> shift) & 1
               ).reshape(-1)[:st.B].to(torch.bool)
    hits = HitArrays(row=torch.where(hit_ok, st.urow,
                                     torch.full_like(st.urow, ROW_SENTINEL)),
                     tp=st.utp, nmis=st.nmis, valid=hit_ok, flagged=flagged)
    return hits, torch.stack([st.total, st.uniq])


def _search_batch_wire(idx: DeviceIndex, reads: torch.Tensor,
                       lens: torch.Tensor, cfg: SearchConfig, cap: int,
                       max_seed_steps: int, seed_q: int = 0, K: int = 0,
                       L: int = 0, K2: int = 0, uniform_len: int = 0,
                       seed_lo: int = 0, seed_hi: int = 0) -> torch.Tensor:
    """_search_batch with everything the host needs in ONE vector, the
    int32 bit patterns of the reference's u32 words: [total, uniq |
    ceil(B / 32) flagged words (read b at bit b % 32 of word b // 32) |
    tp (K2) | meta (K2)], meta row (24 bits) | nmis (7 bits) | valid
    (bit 31), row and nmis clipped. 8 bytes a K2 slot and a bit a read
    cross the link; FS5 writes the flagged words and FS6 the rest on
    the card."""
    B = reads.shape[0]
    if K <= 0:
        K = 2 * B * cfg.num_seeds * cap
    if K2 <= 0:
        K2 = K
    wire = torch.empty(2 + fm_search.flag_words(B) + 2 * K2,
                       dtype=torch.int32, device=reads.device)
    st = _search_stages(idx, reads, lens, cfg, cap, max_seed_steps, seed_q,
                        K, L, K2, uniform_len, seed_lo, seed_hi, wire)
    return fmindex.search_wire(wire, st.B, st.total, st.uniq, st.urow,
                               st.utp, st.uvalid, st.nmis, cfg.k)


def _parse_wire(wire_h: np.ndarray, B: int, K2: int
                ) -> tuple[int, int, HitArrays]:
    """Host-side decode of _search_batch_wire's vector (its int32 bit
    patterns read as the u32 words): (total, uniq, host HitArrays)."""
    wire_h = wire_h.view(np.uint32)
    total, uniq = int(wire_h[0]), int(wire_h[1])
    nf = fm_search.flag_words(B)
    fl_words = wire_h[2:2 + nf]
    flagged = ((fl_words[:, None] >> np.arange(32, dtype=np.uint32)[None, :])
               & 1).astype(bool).reshape(-1)[:B]
    tp = wire_h[2 + nf:2 + nf + K2]
    meta = wire_h[2 + nf + K2:2 + nf + 2 * K2]
    row = (meta & 0xFFFFFF).astype(np.int32)
    nmis = ((meta >> 24) & 0x7F).astype(np.int32)
    valid = (meta >> 31).astype(bool)
    return total, uniq, HitArrays(row=row, tp=tp, nmis=nmis, valid=valid,
                                  flagged=flagged)


class _HostCopy:
    """Asynchronous device->host copy of a dispatch result: on CUDA the
    copy is enqueued into pinned memory behind the compute and an event
    marks its completion; ``numpy()`` waits for it."""

    def __init__(self, vec: torch.Tensor):
        if vec.is_cuda:
            self._host = torch.empty(vec.shape, dtype=vec.dtype,
                                     pin_memory=True)
            self._host.copy_(vec, non_blocking=True)
            # on the stream that runs the copy: vec's device, which need
            # not be the current one
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(vec.device))
        else:
            self._host, self._event = vec, None

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            with timers.wait("search.sync"):
                self._event.synchronize()
        return self._host.numpy()


def config_for(idx: DeviceIndex, k: int) -> SearchConfig:
    """Search config adapted to the environment (storm-gated escalation;
    SOAP3DP_ESCALATE=1 forces it, SOAP3DP_ESCALATE=0 disables it)."""
    env = os.environ.get("SOAP3DP_ESCALATE")
    if env == "0":
        return SearchConfig(k=k, occ_cap_round2=0, occ_cap_round3=0)
    if env:
        return SearchConfig(k=k, escalate_budget=1 << 30)
    return SearchConfig(k=k)


def default_seed_q(idx: DeviceIndex, cfg: SearchConfig) -> int:
    """Genome-size-scaled seed prefix length (LUT-only when 4^lut_k >= n,
    full packed window on repeat-heavy text)."""
    log4n = int(np.ceil(np.log2(max(idx.n, 4)) / 2))
    if idx.repeat_heavy:
        return idx.lut_k + 16
    if idx.lut_k >= log4n:
        return idx.lut_k
    return max(log4n + cfg.seed_slack, idx.lut_k)


def _steps_for(idx: DeviceIndex, seed_q: int, min_seg: int) -> int:
    """FM-step bound for seeds truncated to seed_q."""
    if min_seg >= idx.lut_k:
        return max(seed_q - idx.lut_k, 0)
    return max(seed_q - idx.lut_k, min(idx.lut_k - 1, seed_q))


# global candidate-work ceiling per dispatch (see the reference's _K_CEIL)
_K_CEIL = int(os.environ.get("SOAP3DP_K_CEIL", 1 << 24))


def _run_compacted(idx, reads, lens, cfg, cap, steps, seed_q, B, S,
                   uniform_len=0) -> HitArrays:
    """Dispatch _search_batch_wire (K2 = K, lossless), growing the
    compaction budget on overflow; returns host arrays sliced to a
    bucketed prefix."""
    cap = max(16, min(cap, _K_CEIL // max(2 * B * S, 1)))
    K = shapes.bucket(2 * B * S * 2, min_size=1024)
    K_max = 2 * B * S * cap
    while True:
        Kc = min(K, K_max)
        wire = _search_batch_wire(idx, reads, lens, cfg, cap, steps, seed_q,
                                  Kc, uniform_len=uniform_len)
        words = _HostCopy(wire).numpy()
        with timers.stage("search.parse"):
            t, u, hits = _parse_wire(words, B, Kc)
        if t <= Kc or K >= K_max:
            break
        K = min(shapes.bucket(t), K_max)
        timers.count("search.redispatch_reads", B)
    tb = min(shapes.bucket(u, min_size=1024), hits.row.shape[0])
    if tb < hits.row.shape[0]:
        hits = HitArrays(row=hits.row[:tb], tp=hits.tp[:tb],
                         nmis=hits.nmis[:tb], valid=hits.valid[:tb],
                         flagged=hits.flagged)
    return hits


class PendingSearch:
    """Async seed search: round 1 is enqueued at construction; `result()`
    syncs, grows the compaction budget if needed, and runs the
    escalation rounds (the double buffering of alignment.cu:554-561).

    On a mesh (an index from distributed.mesh.replicate_index) the batch
    is padded to a mesh multiple with copies of read 0 and split into
    one shard per replica, each dispatched on its device without a host
    sync, so the devices run concurrently. The round-1 cap and the
    budgets are sized from the padded global batch, as the reference's
    one program over the mesh sizes them (the budgets split evenly over
    the shards); compaction, dedupe and budget re-runs are per shard,
    and the shards' hits are joined in the order one dispatch over the
    whole batch gives (_join_shards)."""

    def __init__(self, idx: DeviceIndex, reads, lens,
                 cfg: SearchConfig = SearchConfig(),
                 seed_range: tuple[int, int] | None = None):
        self.idx = idx
        self.cfg = cfg
        self.seed_lo, self.seed_hi = seed_range or (0, cfg.num_seeds)
        self.replicas = dmesh.replicas_of(idx)
        self.devices = [r.device for r in self.replicas]
        n = len(self.replicas)
        self.reads_h = np.asarray(reads)
        self.lens_h = np.asarray(lens).astype(np.int32)
        self.B_ext = self.reads_h.shape[0]
        if n > 1 and self.B_ext:
            Bp = dmesh.pad_to_mesh(dmesh.mesh_of(idx), self.B_ext)
            self.reads_h = shapes.pad_rows(self.reads_h, Bp)
            self.lens_h = shapes.pad_rows(self.lens_h, Bp)
        self.B, self.L = self.reads_h.shape
        if 2 * self.B >= (1 << 24):
            raise ValueError(f"batch of {self.B} reads exceeds the 2^23-read "
                             "limit of 24-bit row ids; lower batch_size")
        S = cfg.num_seeds
        if self.B == 0:
            return
        if self.seed_lo == 0:
            timers.count("search.phase1_reads", self.B_ext)
        self.lens = dmesh.split_rows(self.devices, self.lens_h)
        with timers.stage("dispatch.pack"):
            packed_h = pack_read_matrix(self.reads_h)
        with timers.stage("dispatch.h2d"):
            self.packed = dmesh.split_rows(self.devices,
                                           packed_h.view(np.int32))
        max_len = int(self.lens_h.max())
        min_len = int(self.lens_h.min())
        self.min_seg = min_len // S
        self.longest_seg = -(-max_len // S)
        self.seed_q = min(default_seed_q(idx, cfg), self.longest_seg)
        self.steps = _steps_for(idx, self.seed_q,
                                min(self.min_seg, self.seed_q))
        S_eff = self.seed_hi - self.seed_lo
        self.K = shapes.bucket(self.B * S_eff * 5 // 4, min_size=1024)
        self.K2 = shapes.bucket(self.B * 2, min_size=1024)
        self.cap1 = max(1, min(cfg.occ_cap,
                               _K_CEIL // max(2 * self.B * S_eff, 1)))
        self.K_max = self.K2_max = 2 * self.B * S_eff * self.cap1
        self.uniform = int(self.lens_h[0]) \
            if (self.lens_h == self.lens_h[0]).all() else 0
        with timers.stage("dispatch.launch"):
            self._out = [self._dispatch(j, -(-self.K // n), -(-self.K2 // n))
                         for j in range(n)]

    def _dispatch(self, j: int, K: int, K2: int) -> _HostCopy:
        """Shard j's search with budgets K, K2 (clipped to its share of
        the lossless maxima)."""
        n = len(self.replicas)
        return _HostCopy(_search_batch_wire(
            self.replicas[j], self.packed[j], self.lens[j], self.cfg,
            self.cap1, self.steps, self.seed_q, min(K, self.K_max // n),
            L=self.L, K2=min(K2, self.K2_max // n), uniform_len=self.uniform,
            seed_lo=self.seed_lo, seed_hi=self.seed_hi))

    def _shard_result(self, j: int) -> HitArrays:
        """Shard j's round-1 hits, re-dispatched until lossless."""
        n = len(self.replicas)
        Bs = self.B // n
        K_max, K2_max = self.K_max // n, self.K2_max // n
        K, K2 = -(-self.K // n), -(-self.K2 // n)
        words = self._out[j].numpy()
        with timers.stage("search.parse"):
            t, u, hits = _parse_wire(words, Bs, min(K2, K2_max))
        while ((t > min(K, K_max) or u > min(K2, K2_max))
               and (K < K_max or K2 < K2_max)):
            if t > min(K, K_max):
                K = min(shapes.bucket(t), K_max)
            if u > min(K2, K2_max):
                K2 = min(shapes.bucket(u), K2_max)
            timers.count("search.redispatch_reads", Bs)
            with timers.stage("search.redispatch"):
                words = self._dispatch(j, K, K2).numpy()
                with timers.stage("search.parse"):
                    t, u, hits = _parse_wire(words, Bs, min(K2, K2_max))
        tb = min(shapes.bucket(u, min_size=1024), hits.row.shape[0])
        if tb < hits.row.shape[0]:
            hits = HitArrays(row=hits.row[:tb], tp=hits.tp[:tb],
                             nmis=hits.nmis[:tb], valid=hits.valid[:tb],
                             flagged=hits.flagged)
        return hits

    def _strip_pad(self, h: HitArrays) -> HitArrays:
        """Drop hits of mesh-padding rows and remap oriented row ids
        back to the caller's (unpadded) batch size."""
        if self.B == self.B_ext:
            return h
        row, tp, nm, va, fl = h.to_host()
        Bp, Be = self.B, self.B_ext
        strand = (row >= Bp) & va
        rid = row - strand.astype(np.int32) * Bp
        keep = va & (rid < Be)
        return HitArrays(
            row=(rid[keep] + strand[keep].astype(np.int32) * Be).astype(np.int32),
            tp=tp[keep], nmis=nm[keep],
            valid=np.ones(int(keep.sum()), bool), flagged=fl[:Be])

    def result(self) -> HitArrays:
        cfg = self.cfg
        B, S = self.B, self.cfg.num_seeds
        if B == 0:
            z = np.zeros(0, np.int32)
            return HitArrays(row=z, tp=z.astype(np.uint32), nmis=z,
                             valid=z.astype(bool), flagged=np.zeros(0, bool))
        n = len(self.replicas)
        hits = _join_shards([self._shard_result(j) for j in range(n)], B // n)
        # escalating re-runs of still-flagged reads with full pigeonhole
        # segments (round 2, then a bounded round 3)
        steps2 = _steps_for(self.idx, self.longest_seg,
                            min(self.min_seg, self.longest_seg))
        prev_cap_eff = self.cap1 if (
            (self.seed_lo, self.seed_hi) == (0, cfg.num_seeds)
            and self.seed_q >= self.longest_seg) else 0
        for rnd, cap in ((2, cfg.occ_cap_round2), (3, cfg.occ_cap_round3)):
            if cap <= 0:
                break
            flagged = np.asarray(hits.flagged)
            if not flagged.any():
                break
            sel = np.flatnonzero(flagged)
            if len(sel) > cfg.escalate_budget:
                break  # storm: keep truncated round-1 sets
            nb = min(shapes.bucket_quarter(len(sel), min_size=64), B)
            nb = min(dmesh.pad_to_mesh(dmesh.mesh_of(self.idx), nb), B)
            cap_eff = max(16, min(cap, _K_CEIL // max(2 * nb * S, 1)))
            if cap_eff <= prev_cap_eff:
                break
            prev_cap_eff = cap_eff
            timers.count(f"search.round{rnd}_reads", len(sel))
            with timers.stage(f"search.round{rnd}"):
                sel_pad = np.concatenate(
                    [sel, np.zeros(nb - len(sel), np.int64)]) \
                    if len(sel) < nb else sel[:nb]
                r2 = dmesh.split_rows(self.devices, self.reads_h[sel_pad])
                lh = self.lens_h[sel_pad]
                l2 = dmesh.split_rows(self.devices, lh)
                un2 = int(lh[0]) if (lh == lh[0]).all() else 0
                parts = dmesh.map_shards(
                    self.devices, lambda j: _run_compacted(
                        self.replicas[j], r2[j], l2[j], cfg, cap_eff, steps2,
                        0, nb // n, S, uniform_len=un2))
                hits2 = _join_shards(parts, nb // n)
                hits = _merge_round2(hits, hits2, sel, B, nb)
        return self._strip_pad(hits)


def _join_shards(parts: list[HitArrays], Bs: int) -> HitArrays:
    """One HitArrays from the searches of consecutive shards of Bs reads:
    shard j's oriented rows (forward 0..Bs-1, reverse complement
    Bs..2Bs-1) become the batch's (j*Bs + b, and B + j*Bs + b), and the
    valid hits are ordered by row, stably, which is the order of one
    dispatch over the whole batch (compaction and dedupe keep lane
    order, lanes are row-major). Host arrays; one part passes as is."""
    if len(parts) == 1:
        return parts[0]
    B = Bs * len(parts)
    rows, tps, nms, flags = [], [], [], []
    for j, h in enumerate(parts):
        row, tp, nm, va, fl = h.to_host()
        row = row[va]
        rows.append(np.where(row >= Bs, B - Bs, 0) + j * Bs + row)
        tps.append(tp[va])
        nms.append(nm[va])
        flags.append(fl)
    row = np.concatenate(rows)
    order = np.argsort(row, kind="stable")
    return HitArrays(row=row[order].astype(np.int32),
                     tp=np.concatenate(tps)[order],
                     nmis=np.concatenate(nms)[order],
                     valid=np.ones(len(row), bool),
                     flagged=np.concatenate(flags))


def search_reads(idx: DeviceIndex, reads, lens,
                 cfg: SearchConfig = SearchConfig()) -> HitArrays:
    """Two-round seed search over a read batch (host HitArrays)."""
    return PendingSearch(idx, reads, lens, cfg).result()


def _merge_round2(h1: HitArrays, h2: HitArrays, sel: np.ndarray, B: int,
                  nb: int) -> HitArrays:
    """Replace flagged reads' round-1 entries with their round-2 results."""
    row1, tp1, nm1, va1, _ = h1.to_host()
    row2, tp2, nm2, va2, fl2 = h2.to_host()
    n_sel = len(sel)
    read1 = np.where(row1 >= B, row1 - B, row1)
    keep1 = va1.copy()
    keep1[va1] = ~np.isin(read1[va1], sel)
    read2 = np.where(row2 >= nb, row2 - nb, row2)
    keep2 = va2 & (read2 < n_sel)
    strand2 = (row2 >= nb).astype(np.int32)
    g_row = np.where(keep2, sel[np.minimum(read2, n_sel - 1)]
                     + strand2 * B, 0).astype(np.int32)
    row = np.concatenate([row1[keep1], g_row[keep2]])
    tp = np.concatenate([tp1[keep1], tp2[keep2]])
    nm = np.concatenate([nm1[keep1], nm2[keep2]])
    flagged = np.zeros(B, bool)
    flagged[sel] = fl2[:n_sel]
    return HitArrays(row=row, tp=tp, nmis=nm,
                     valid=np.ones(len(row), bool), flagged=flagged)
