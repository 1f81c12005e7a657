"""Aligner options: the rebuild's InputOptions + IniParams analog.

Mirrors the reference's option surface (IniParam.h:52-127, README.md
section 2.2 flags, soap3-dp.ini keys) with the same defaults.
"""

from __future__ import annotations

import dataclasses

OUTPUT_ALL_VALID = 1   # -h 1
OUTPUT_ALL_BEST = 2    # -h 2 (default)
OUTPUT_UNIQUE_BEST = 3  # -h 3
OUTPUT_RANDOM_BEST = 4  # -h 4

FORMAT_SUCCINCT = 1    # -b 1
FORMAT_SAM = 2         # -b 2 (default)
FORMAT_BAM = 3         # -b 3


@dataclasses.dataclass
class AlignOptions:
    # alignment
    max_mismatches: int | None = None  # -s: 0..4 disables DP; None = DP pipeline
    output_mode: int = OUTPUT_ALL_BEST  # -h
    output_format: int = FORMAT_SAM     # -b
    max_read_len: int = 120             # -L
    min_insert: int = 1                 # -v
    max_insert: int = 500               # -u
    # output
    output_prefix: str | None = None    # -o
    output_md: bool = False             # -p
    read_group: str = "default"         # -D
    sample_name: str = "default"        # -A
    rg_option: str = ""                 # -R
    illumina13: bool = False            # -I: qualities are phred+64
    # ini-level knobs (soap3-dp.ini)
    max_output_per_read: int = 1000
    max_output_per_pair: int = 1000
    max_hits_each_end_for_pairing: int = 8000
    # storm threshold: when more than this many reads of a batch are
    # still-flagged, host re-alignment is skipped for the batch (they
    # keep device-truncated hit sets; ProceedDPForTooManyHits routing
    # applies) — bounds host work on satellite/microsat-dense genomes
    host_realign_budget: int = 256
    # half-aligned rescue: DP a NARROW window centered on the gapless
    # prescan's best offset (pad bases each side) instead of the full
    # min..max-insert window; candidates that fail the narrow DP and
    # whose window minimum-mismatch is <= half_narrow_fb_mm re-run on
    # the full window (a plausibly-elsewhere placement). 0 disables
    # (always full window — the reference's HalfEndAlgnBatch posture,
    # DV-DPfunctions.cu:2027-2109). The gapless argmax tracks the DP
    # optimum through mismatches, clips AND small indels; divergence
    # is measured by tools/measure_storm_divergence.py + the planted
    # accuracy harness.
    half_narrow_pad: int = 32
    half_narrow_fb_mm: int = 12
    soap3_mismatch_allow: int = 2
    min_mapq: int = 1
    max_mapq: int = 40
    bwa_like_score: bool = True
    max_front_clip: int = 49
    max_end_clip: int = 49
    skip_bwt_alignment: bool = False    # SkipSOAP3Alignment
    dp_for_too_many_hits: bool = False  # ProceedDPForTooManyHits
    dp_score_threshold: int | None = None  # None = DEFAULT = 0.3 * readlen
    # scoring ([DP] section)
    match_score: int = 1
    mismatch_score: int = -2
    gap_open_score: int = -3
    gap_extend_score: int = -1
    # strand arrangement ([PairEnd]): 0 = '+', 1 = '-'
    strand_left_leg: int = 0
    strand_right_leg: int = 1
    # rebuild-specific
    random_seed: int = 0                # random-best determinism
    batch_size: int = 1 << 16
    # phased BWT search (the reference's staged-phase scheme:
    # four_phases_alignment / all_best_alignment, alignment.cu:1119-1236):
    # round 1 searches pigeonhole segments {0,1} (complete for <= 1
    # mismatch); only pairs it cannot resolve search the remaining
    # segments. Disabled automatically for -h 1 (all-valid needs the
    # complete <= k set for every read) and k < 2; env kill switch
    # SOAP3DP_NO_PHASED=1.
    phased_search: bool = True
    half_rescue_seeded: bool = False    # phase-B seeded mate rescue round
    # DP seeding searches both exact halves of every seed — the
    # pigeonhole equivalent of the reference's 1-mismatch seed kernel
    # (single_1_mismatch_alignment2, alignment.cu:1839). Measured on
    # 4%-substituted 100bp reads (tools/seed_sensitivity.py): candidate
    # recall 0.99 vs 0.64 for exact full seeds, at ~12x the candidate
    # volume (deep-DP subsets are small, so the DP cost is bounded).
    dp_seed_1mm: bool = True

    @property
    def dp_enabled(self) -> bool:
        return self.max_mismatches is None

    def effective_mismatches(self, read_len: int) -> int:
        """-s default: 3 for reads >= 50bp else 2 (README section 2.2);
        the DP pipeline's BWT phase uses Soap3MisMatchAllow."""
        if self.max_mismatches is not None:
            return self.max_mismatches
        return self.soap3_mismatch_allow

    def dp_cutoff(self, read_len) -> int:
        """DPScoreThreshold DEFAULT = 0.3 * read length (soap3-dp.ini)."""
        import numpy as np
        if self.dp_score_threshold is not None:
            return np.full_like(np.asarray(read_len), self.dp_score_threshold)
        return (np.asarray(read_len) * 0.3).astype(int)
