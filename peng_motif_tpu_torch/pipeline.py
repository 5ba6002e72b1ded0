"""Pipeline orchestrator: the motif discovery driver.

Counterpart of the reference's Peng::process
(reference: src/peng.cpp:322-435):

  1. count base patterns + statistics    (device, engine.py)
  2. IUPAC hill climbing                 (device walks, host replay)
  3. PWM construction                    (device)
  4. EM sharpening + motif merging       (device EM, host merge loop)

Greedy, order-dependent decisions (seed walk, seen-set replay, filter,
merging) run on host; every 4**W-table phase runs on the selected torch
device (engine.process_gpu).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import List, Set

import numpy as np
import torch

from .alphabets import IUPAC_N, iupac_id_to_digits
from .engine import process_gpu
from .models.background import BackgroundModel
from .models.motif import (
    Motif,
    build_iupac_profile,
    calculate_best_overlap,
    calculate_s,
    merge_motifs,
    sort_by_log_pvalue,
)
from .pattern_tables import OptimizationScore, Strand
from .utils import numerics
from .utils.logging_utils import PhaseTimer, get_logger

F32 = np.float32


@dataclass
class PengParameters:
    """Pipeline configuration (reference: PengParameters, src/peng.h:14-35;
    defaults from src/Global.cpp:12-56)."""

    max_pattern_length: int = 10
    zscore_threshold: float = 10.0
    count_threshold: int = 3
    pseudo_counts: int = 10
    opt_score_type: OptimizationScore = OptimizationScore.MUTUAL_INFO
    enrich_pseudocount_factor: float = 0.005
    use_em: bool = True
    em_saturation_factor: float = 1e4
    em_min_threshold: float = 0.08
    em_max_iterations: int = 10
    use_merging: bool = True
    bit_factor_merge_threshold: float = 0.4
    adv_pwm: bool = True
    minimum_processed_motifs: int = 0
    filter_neighbors: bool = True
    max_optimized_patterns: int = 50
    max_merged_length: int = 14
    # device of the 4**W-table phases (device.resolve_device); as on the CLI,
    # cuda unless the caller names the CPU
    device: torch.device = torch.device("cuda")


class Peng:
    """Motif discovery pipeline (reference: class Peng, src/peng.{h,cpp})."""

    def __init__(
        self,
        strand: Strand,
        k: int,
        max_opt_k: int,
        sequence_set,
        bg_model: BackgroundModel,
        stdout=None,
    ):
        self.strand = strand
        self.k = k
        self.max_k = max(k, max_opt_k)
        self.sequence_set = sequence_set
        self.bg_model = bg_model
        self.n_sequences = sequence_set.n
        self._iupac_profile = None  # lazy: bg_model may still be counting
        # resolve at call time so redirect_stdout works
        self.out = stdout if stdout is not None else sys.stdout
        self.log = get_logger()
        self.timer = PhaseTimer()

    @property
    def iupac_profile(self):
        """Nearest-IUPAC rendering profiles (reference:
        src/iupac_pattern.cpp:215-238).  Computed on first use so a
        deferred background model can overlap the count phase."""
        if self._iupac_profile is None:
            self._iupac_profile = build_iupac_profile(self.bg_model.v[0])
        return self._iupac_profile

    # ------------------------------------------------------------------
    def process(self, params: PengParameters) -> List[Motif]:
        return process_gpu(self, params)

    # -- phase 2b: filter (reference: src/peng.cpp:543-599) --------------
    def _filter_iupac_patterns(
        self, W: int, minimum_retained: int, motifs: List[Motif]
    ) -> List[Motif]:
        kept = []
        for motif in motifs:
            digits = iupac_id_to_digits(motif.pattern_id, W)
            informative = sum(1 for c in digits if c != IUPAC_N)
            if informative > 3:
                kept.append(motif)

        kept = sort_by_log_pvalue(kept)
        min_pvalue = F32(-5.0)
        if kept:
            min_pvalue = min(F32(-5.0), F32(kept[0].log_pvalue * F32(0.2)))

        return [
            m for i, m in enumerate(kept)
            if m.log_pvalue < min_pvalue or i < minimum_retained
        ]

    # -- phase 4b: merging (reference: src/peng.cpp:237-313) -------------
    def _merge_patterns(
        self, W: int, threshold: float, motifs: List[Motif],
        max_merged_length: int,
    ):
        both = self.strand == Strand.BOTH_STRANDS
        bg0 = self.bg_model.v[0]
        # The reference recomputes every pair each merge round
        # (src/peng.cpp:247-263); scores are pure functions of the two
        # (immutable) motifs, so memoizing unchanged pairs is
        # outcome-identical and turns the loop from O(rounds * n^2) into
        # O(n^2 + rounds * n) overlap scans.
        pair_cache: dict = {}
        while True:
            best_score = -np.inf
            best_i = best_j = 0
            best_shift = 0
            best_comp = False
            for i in range(len(motifs)):
                if motifs[i].log_pvalue > -5:
                    continue
                for j in range(i + 1, len(motifs)):
                    if motifs[j].log_pvalue > -5:
                        continue
                    key = (motifs[i], motifs[j])
                    hit = pair_cache.get(key)
                    if hit is None:
                        hit = calculate_best_overlap(
                            motifs[i], motifs[j], both, bg0
                        )
                        pair_cache[key] = hit
                    s, shift, comp = hit
                    if s > best_score:
                        best_i, best_j = i, j
                        best_score, best_shift, best_comp = s, shift, comp

            if not (
                best_score > W * threshold
                and motifs
                and motifs[best_i].length <= max_merged_length
                and motifs[best_j].length <= max_merged_length
            ):
                return

            if motifs[best_i].length < motifs[best_j].length:
                longer, shorter = motifs[best_j], motifs[best_i]
            else:
                longer, shorter = motifs[best_i], motifs[best_j]
            merged = merge_motifs(longer, shorter, best_comp, bg0, best_shift)

            if (merged.length <= self.sequence_set.max_l
                    and merged.length <= max_merged_length):
                print(
                    f"merge: "
                    f"{motifs[best_j].pattern_string(self.iupac_profile)} + "
                    f"{motifs[best_i].pattern_string(self.iupac_profile)} -> "
                    f"{merged.pattern_string(self.iupac_profile)}",
                    file=self.out,
                )
                del motifs[best_j]
                del motifs[best_i]
                motifs.append(merged)
            else:
                # reference `continue`s with found_better still false,
                # terminating the merge loop (src/peng.cpp:308-310)
                return

    # -- redundancy filter (reference: src/peng.cpp:199-235) -------------
    def filter_redundancy(self, threshold: float, motifs: List[Motif]):
        motifs[:] = sort_by_log_pvalue(motifs)
        bg0 = self.bg_model.v[0]
        deselected: Set[int] = set()
        for i in range(len(motifs)):
            if i in deselected:
                continue
            for j in range(i + 1, len(motifs)):
                if j in deselected or motifs[i].length != motifs[j].length:
                    continue
                length = motifs[i].length
                s1 = calculate_s(motifs[i].pwm, motifs[j].pwm, bg0, 0, 0,
                                 length)
                s2 = calculate_s(motifs[i].comp_pwm, motifs[j].pwm, bg0, 0, 0,
                                 length)
                thr = F32(threshold) * length
                if s1 > thr or s2 > thr:
                    deselected.add(j)
                    break  # reference breaks after one deselection per i
        for index in sorted(deselected, reverse=True):
            del motifs[index]

    # -- status printing ---------------------------------------------------
    def _status(self, header: str, leading_newline: bool = True):
        if leading_newline:
            print(file=self.out)
        print(f"[STATUS] {header}:", file=self.out)

    def _print_climb_row(self, motif: Motif, score):
        enr = (motif.n_sites / motif.expected_counts
               if motif.expected_counts else np.inf)
        # cout is sticky std::fixed from the first seed table on
        # (reference: src/base_pattern.cpp:524), so the climb columns are
        # fixed-point with 2 / 6 decimals (src/peng.cpp:459-463)
        print(
            f"\t{motif.iupac_string():>15}\t{motif.n_sites:>10}\t"
            f"{enr:>5.2f}\t{score:>10.6f}", file=self.out,
        )

    def _print_motif_table(self, motifs: List[Motif]):
        print(
            f"{'pattern':>15}\t{'observed':>15}\t{'enrichment':>15}\t"
            f"{'zscore':>15}\n", file=self.out,
        )
        for m in motifs:
            enr = m.n_sites / m.expected_counts if m.expected_counts else np.inf
            print(
                f"{m.iupac_string():>15}\t{m.n_sites:>15}\t{enr:>15.2f}\t"
                f"{m.zscore:>15.2f}", file=self.out,
            )

    def _print_pwm_row(self, prefix: str, motif: Motif):
        info = numerics.pwm_info_content(motif.pwm) / motif.length
        print(
            f"{prefix}{motif.iupac_string()} -> "
            f"{motif.pattern_string(self.iupac_profile)}   "
            f"[ avg. info: {info:.2f} ]", file=self.out,
        )
