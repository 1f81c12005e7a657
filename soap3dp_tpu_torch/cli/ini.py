"""soap3-dp.ini-compatible configuration loading.

The reference layers a `<binary>.ini` file under argv flags
(ParseIniFile, IniParam.cpp; key list in soap3-dp.ini). This module
reads the same key names into AlignOptions.
"""

from __future__ import annotations

import configparser
import os
import sys

from soap3dp_tpu_torch.pipeline.options import AlignOptions


def load_ini_options(path: str | None) -> AlignOptions | None:
    """Load AlignOptions from an ini file. Returns defaults-on-None
    behavior: None if no path given and no soap3-dp.ini is found."""
    if path is None:
        candidate = os.path.join(os.getcwd(), "soap3-dp.ini")
        if not os.path.exists(candidate):
            return None
        path = candidate
    cp = configparser.ConfigParser(inline_comment_prefixes=("#", ";"))
    cp.read(path)
    opts = AlignOptions()

    def geti(section, key, default):
        try:
            return cp.getint(section, key)
        except (configparser.Error, ValueError):
            return default

    opts.max_output_per_read = geti("Alignment", "MaxOutputPerRead",
                                    opts.max_output_per_read)
    opts.soap3_mismatch_allow = geti("Alignment", "Soap3MisMatchAllow",
                                     opts.soap3_mismatch_allow)
    opts.max_output_per_pair = geti("PairEnd", "MaxOutputPerPair",
                                    opts.max_output_per_pair)
    opts.max_hits_each_end_for_pairing = geti(
        "PairEnd", "MaxHitsEachEndForPairing",
        opts.max_hits_each_end_for_pairing)
    sa = cp.get("PairEnd", "StrandArrangement", fallback="+/-")
    if sa in ("+/-", "-/-", "+/+", "-/+"):
        opts.strand_left_leg = 0 if sa[0] == "+" else 1
        opts.strand_right_leg = 0 if sa[2] == "+" else 1
    opts.match_score = geti("DP", "MatchScore", opts.match_score)
    opts.mismatch_score = geti("DP", "MismatchScore", opts.mismatch_score)
    opts.gap_open_score = geti("DP", "GapOpenScore", opts.gap_open_score)
    opts.gap_extend_score = geti("DP", "GapExtendScore", opts.gap_extend_score)
    thr = cp.get("DP", "DPScoreThreshold", fallback="DEFAULT").strip()
    if thr.upper() != "DEFAULT":
        try:
            opts.dp_score_threshold = int(thr)
        except ValueError:
            print(f"[soap3dp] bad DPScoreThreshold {thr!r}; using DEFAULT",
                  file=sys.stderr)
    opts.min_mapq = geti("Score", "MinMAPQ", opts.min_mapq)
    opts.max_mapq = geti("Score", "MaxMAPQ", opts.max_mapq)
    opts.bwa_like_score = geti("Score", "BWALikeScore",
                               int(opts.bwa_like_score)) != 0
    opts.max_front_clip = geti("Clipping", "MaxFrontLenClipped",
                               opts.max_front_clip)
    opts.max_end_clip = geti("Clipping", "MaxEndLenClipped",
                             opts.max_end_clip)
    opts.skip_bwt_alignment = geti("OtherSettings", "SkipSOAP3Alignment",
                                   int(opts.skip_bwt_alignment)) != 0
    opts.dp_for_too_many_hits = geti("OtherSettings", "ProceedDPForTooManyHits",
                                     int(opts.dp_for_too_many_hits)) != 0
    return opts
