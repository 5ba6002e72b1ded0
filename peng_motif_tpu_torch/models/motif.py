"""Motif model: degenerate IUPAC patterns and their PWMs.

The host-side counterpart of the reference's IUPACPattern
(reference: src/iupac_pattern.{h,cpp}).  Table aggregation runs through
PatternTables; this module owns the small per-motif state and the merge /
similarity arithmetic (<=50 motifs of width <=14, on host by design:
greedy control flow is host-side).  The similarity sums and the motif
sort run in the native library, in the reference's float order.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..alphabets import (
    IUPAC_ALPHABET_SIZE,
    IUPAC_CHARS,
    IUPAC_MASKS,
    iupac_id_to_digits,
    iupac_id_to_string,
)
from ..utils import numerics

F32 = np.float32

MIN_MERGE_OVERLAP = 6  # reference: src/iupac_pattern.h:19

MIXIN_FACTOR = 0.2  # reference: src/iupac_pattern.cpp:24
MIXIN_BIAS = 0.7    # reference: src/iupac_pattern.cpp:25


def build_iupac_profile(bg_freq: np.ndarray) -> np.ndarray:
    """[11, 4] per-letter base profiles used for PWM -> IUPAC rendering
    (reference: src/iupac_pattern.cpp:215-238)."""
    profile = np.zeros((IUPAC_ALPHABET_SIZE, 4), dtype=F32)
    for c in range(IUPAC_ALPHABET_SIZE):
        for a in range(4):
            profile[c, a] = F32(MIXIN_FACTOR) * F32(bg_freq[a])
            if IUPAC_MASKS[c, a]:
                profile[c, a] = F32(profile[c, a] + F32(MIXIN_BIAS))
    return profile


class Motif:
    """One motif: IUPAC pattern id (until merged) + PWM + statistics."""

    def __init__(self, pattern_id: Optional[int], length: int):
        self.pattern_id = pattern_id
        self.length = length
        self.pwm: Optional[np.ndarray] = None        # [W, 4] float32
        self.comp_pwm: Optional[np.ndarray] = None
        self.n_sites: int = 0
        self.local_n_sites = np.zeros(length, dtype=np.int64)
        self.log_pvalue: np.float32 = F32(0.0)
        self.zscore: np.float32 = F32(0.0)
        self.bg_p: np.float32 = F32(0.0)
        self.expected_counts: np.float32 = F32(0.0)
        self.merged: bool = False
        self.opt_bg_order: int = 0

    # -- identity ----------------------------------------------------------

    def iupac_string(self) -> str:
        assert self.pattern_id is not None
        return iupac_id_to_string(self.pattern_id, self.length)

    def pattern_string(self, iupac_profile: np.ndarray) -> str:
        """Render the PWM as its nearest IUPAC string
        (reference: src/iupac_pattern.cpp:699-718).  Vectorized over
        positions x letters with the scalar path's exact expression
        order (double terms, float32 mean, left-to-right sum over the 4
        bases; first minimum wins, like the scalar strict <)."""
        eps = 1e-7
        rows = self.pwm.astype(np.float64)[:, None, :]          # [L, 1, 4]
        profs = np.asarray(iupac_profile, dtype=np.float64)[None, :, :]
        p1 = rows + eps
        p2 = profs + eps
        mean = ((rows + profs + 2 * eps) / 2).astype(F32).astype(np.float64)
        terms = (p1 * np.log2(p1) + p2 * np.log2(p2)
                 - 2 * mean * np.log2(mean))                    # [L, 11, 4]
        d = ((terms[..., 0] + terms[..., 1]) + terms[..., 2]) + terms[..., 3]
        best = np.argmin(d, axis=1)                             # first min
        return "".join(IUPAC_CHARS[m] for m in best)

    # -- attribute aggregation --------------------------------------------

    def set_aggregates(
        self,
        sum_counts: int,
        sum_expected: np.float32,
        sum_bg_p: np.float32,
        log_bonferroni: np.ndarray,
    ):
        """Fill statistics from aggregated base-pattern sums
        (reference: src/iupac_pattern.cpp:410-473)."""
        self.bg_p = F32(sum_bg_p)
        self.expected_counts = F32(sum_expected)
        self.zscore = numerics.zscore_from_sums(sum_counts, sum_expected)
        self.n_sites = int(sum_counts)
        self.local_n_sites[:] = self.n_sites
        digits = iupac_id_to_digits(self.pattern_id, self.length)
        self.log_pvalue = numerics.iupac_log_pvalue(
            self.n_sites, self.expected_counts, self.zscore, digits,
            log_bonferroni,
        )

    # -- PWMs --------------------------------------------------------------

    def set_pwm(self, pwm: np.ndarray, normalize: bool = True):
        self.pwm = np.asarray(pwm, dtype=F32).copy()
        if normalize:
            numerics.normalize_pwm(self.pwm)
        self.calculate_comp_pwm()

    def calculate_comp_pwm(self):
        """comp[p][a] = pwm[W-1-p][3-a]
        (reference: src/iupac_pattern.cpp:618-634)."""
        self.comp_pwm = self.pwm[::-1, ::-1].copy()

    def clone_with_pwm(self, pwm: np.ndarray) -> "Motif":
        """Copy with replaced (re-normalized) PWM
        (reference: src/iupac_pattern.cpp:44-72)."""
        m = Motif(self.pattern_id, self.length)
        m.local_n_sites = self.local_n_sites.copy()
        m.set_pwm(pwm, normalize=True)
        m.n_sites = self.n_sites
        m.log_pvalue = self.log_pvalue
        m.bg_p = self.bg_p
        m.expected_counts = self.expected_counts
        m.merged = self.merged
        m.opt_bg_order = self.opt_bg_order
        return m


# -- PWM similarity (reference: src/iupac_pattern.cpp:539-615) -------------


def calculate_d_bg(p_pwm, background, l: int, offset: int = 0) -> np.float32:
    """Divergence of a PWM stretch from the background distribution
    (reference: src/iupac_pattern.cpp:551-561; epsilon 1e-4)."""
    from ..native import calculate_d_bg_native  # noqa: PLC0415

    return calculate_d_bg_native(p_pwm, background, l, offset)


def calculate_s(p1_pwm, p2_pwm, background, offset1: int, offset2: int,
                l: int) -> np.float32:
    """S = 0.5*(d_bg(p1)+d_bg(p2)) - d(p1,p2)
    (reference: src/iupac_pattern.cpp:563-566)."""
    from ..native import calculate_s_native  # noqa: PLC0415

    return calculate_s_native(p1_pwm, p2_pwm, background, offset1, offset2, l)


def calculate_best_overlap(
    m1: Motif, m2: Motif, both_strands: bool, background
) -> Tuple[np.float32, int, bool]:
    """Best similarity over all shifts >= MIN_MERGE_OVERLAP and both
    orientations (reference: src/iupac_pattern.cpp:568-615).

    Returns (max_s, max_shift, max_comp) with shifts defined relative to
    the longer pattern.
    """
    from ..native import best_overlap_native  # noqa: PLC0415

    return best_overlap_native(
        m1.pwm, m1.comp_pwm, m1.length, m1.n_sites,
        m2.pwm, m2.comp_pwm, m2.length, m2.n_sites,
        both_strands, background, MIN_MERGE_OVERLAP,
    )


def merge_motifs(longer: Motif, shorter: Motif, is_comp: bool, background,
                 shift: int) -> Motif:
    """Merge two overlapping motifs into one longer motif
    (reference merge constructor: src/iupac_pattern.cpp:75-172)."""
    off_shorter = -min(shift, 0)
    off_larger = max(shift, 0)
    overlap = min(longer.length - off_larger, shorter.length - off_shorter)

    longer_pwm, shorter_pwm = longer.pwm, shorter.pwm
    if is_comp and longer.n_sites < shorter.n_sites:
        longer_pwm = longer.comp_pwm
    elif is_comp:
        shorter_pwm = shorter.comp_pwm

    new_len = longer.length + shorter.length - overlap
    merged = Motif(None, new_len)

    for p in range(shorter.length):
        merged.local_n_sites[max(shift, 0) + p] += shorter.local_n_sites[p]
    for p in range(longer.length):
        merged.local_n_sites[-min(shift, 0) + p] += longer.local_n_sites[p]
    merged.n_sites = int(merged.local_n_sites.sum()) // new_len

    pwm = np.zeros((new_len, 4), dtype=F32)
    for p in range(new_len):
        pos_in_shorter = p - max(0, shift)
        pos_in_longer = p + min(shift, 0)
        in_shorter = 0 <= pos_in_shorter < shorter.length
        in_longer = 0 <= pos_in_longer < longer.length
        if in_longer and not in_shorter:
            pwm[p] = longer_pwm[pos_in_longer]
        if in_shorter and not in_longer:
            pwm[p] = shorter_pwm[pos_in_shorter]
        if in_shorter and in_longer:
            # float32 throughout, matching the reference expression
            # (size_t weights convert to float before multiplying,
            # src/iupac_pattern.cpp:154-158)
            ws = F32(shorter.local_n_sites[pos_in_shorter])
            wl = F32(longer.local_n_sites[pos_in_longer])
            denom = F32(int(shorter.local_n_sites[pos_in_shorter])
                        + int(longer.local_n_sites[pos_in_longer]))
            num = (ws * shorter_pwm[pos_in_shorter].astype(F32)
                   + wl * longer_pwm[pos_in_longer].astype(F32)).astype(F32)
            pwm[p] = (num / denom).astype(F32)

    merged.pwm = pwm
    numerics.normalize_pwm(merged.pwm)
    merged.calculate_comp_pwm()
    merged.log_pvalue = _merged_pvalue(longer, shorter, is_comp, background,
                                       shift)
    merged.bg_p = F32(0.0)
    merged.merged = True
    return merged


def _merged_pvalue(longer: Motif, shorter: Motif, is_comp: bool, background,
                   shift: int) -> np.float32:
    """Heuristic p-value for a merged motif
    (reference: src/iupac_pattern.cpp:240-289).

    Faithfully reproduces the reference's asymmetric orientation choice:
    the shorter motif's *complement* PWM is used whenever the first
    branch does not apply — even for non-complement merges
    (src/iupac_pattern.cpp:245-250 has no is_comp guard on the else).
    """
    longer_pwm, shorter_pwm = longer.pwm, shorter.pwm
    if is_comp and longer.n_sites < shorter.n_sites:
        longer_pwm = longer.comp_pwm
    else:
        shorter_pwm = shorter.comp_pwm

    off_shorter = -min(shift, 0)
    off_longer = max(shift, 0)
    overlap = min(longer.length - off_longer, shorter.length - off_shorter)

    if longer.log_pvalue < shorter.log_pvalue:
        if off_shorter != 0:
            d = calculate_d_bg(shorter_pwm, background, off_shorter, 0)
        else:
            start = off_shorter + overlap
            d = calculate_d_bg(shorter_pwm, background,
                               shorter.length - start, start)
        d_div = calculate_d_bg(shorter_pwm, background, shorter.length)
        return F32(longer.log_pvalue + F32(d / d_div) * shorter.log_pvalue)
    else:
        if off_longer != 0:
            d = calculate_d_bg(longer_pwm, background, off_longer, 0)
        else:
            start = off_longer + overlap
            d = calculate_d_bg(longer_pwm, background,
                               longer.length - start, start)
        d_div = calculate_d_bg(longer_pwm, background, longer.length)
        return F32(shorter.log_pvalue + F32(d / d_div) * longer.log_pvalue)


def sort_by_log_pvalue(motifs: List[Motif]) -> List[Motif]:
    """Ascending log p-value (reference: sort_IUPAC_patterns,
    src/iupac_pattern.cpp:847-849), by native std::sort: bitwise-tied
    log p-values (every optimized reverse-complement pair) land in
    libstdc++'s introsort tie order, matching the reference binary."""
    from ..native import float_sort_indices_asc  # noqa: PLC0415

    values = np.array([m.log_pvalue for m in motifs], dtype=F32)
    return [motifs[i] for i in float_sort_indices_asc(values)]
