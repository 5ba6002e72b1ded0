"""Pipeline orchestrator: the motif discovery driver.

Counterpart of the reference's Peng::process
(reference: src/peng.cpp:322-435), with the reference package's two
engines:

  * the device engine (``--engine tpu``, engine.process_gpu): every
    4**W-table phase — count, stats, climb, adv-PWM, EM — runs on the
    selected torch device; floats within the reference engine's
    tolerance;
  * the exact engine (``--engine exact``, :meth:`Peng._process_exact`):
    the count (native host scan, or the batch device count) feeds host
    tables and native phases built in the reference binary's operation
    order, so its output is byte-identical to the reference binary.

The device engine falls back to the exact engine wherever it cannot
guarantee the reference's semantics (engine.EngineFallback).  Greedy,
order-dependent decisions (seed walk, climb bookkeeping, filter,
merging) run on host in both.
"""

from __future__ import annotations

import io
import sys
from dataclasses import dataclass
from typing import List, Optional, Set

import numpy as np
import torch

from . import engine as engine_mod
from .alphabets import (
    IUPAC_N,
    IUPAC_SIMILAR,
    LOG_BONFERRONI,
    base_id_to_iupac_id,
    iupac_id_to_digits,
)
from .checkpoint import load_checkpoint, save_checkpoint
from .engine import EngineFallback, process_gpu
from .models.background import BackgroundModel
from .models.motif import (
    MIN_MERGE_OVERLAP,
    Motif,
    build_iupac_profile,
    calculate_best_overlap,
    calculate_s,
    merge_motifs,
    sort_by_log_pvalue,
)
from .native import em_optimize_native
from .pattern_tables import OptimizationScore, PatternTables, Strand
from .utils import numerics
from .utils.logging_utils import PhaseTimer, get_logger

F32 = np.float32

# vectorized hill-climb move tables (see _optimize_iupac_patterns)
_IUPAC_SIMILAR_ARR = tuple(
    np.asarray(s, dtype=np.int32) for s in IUPAC_SIMILAR)
_POW11 = 11 ** np.arange(19, dtype=np.int64)  # 11**19 would overflow int64


def resolve_engine(engine: str, device: torch.device, length: int) -> str:
    """The engine ``--engine`` runs: "tpu" (the device engine, on
    ``device``) or "exact".  ``auto`` follows the reference's rule
    (peng_motif_tpu/pipeline.py:157-169), reading "an accelerator is
    attached" as a CUDA ``device``: the device engine for W < 12, the
    exact engine for W >= 12 or on the CPU."""
    if engine == "auto":
        return "tpu" if device.type == "cuda" and length < 12 else "exact"
    return engine


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
    # "tpu" (the device engine), "exact" or "auto" (resolve_engine)
    engine: str = "auto"
    # mesh for sharded counting (parallel/mesh.make_data_mesh: a tuple of
    # torch devices); None counts on ``device`` alone
    mesh: Optional[tuple] = None
    save_checkpoint: Optional[str] = None  # persist count table + bg model
    load_checkpoint: Optional[str] = None  # resume from a persisted table
    precomputed: Optional[tuple] = None    # (counts_np, ltot) from an
    #                                        external count (multi-process)
    threads: int = 0                       # native EM threads (0 = auto)


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
        timer: Optional[PhaseTimer] = None,
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
        # the job's recorder (cli.main's), or one of this pipeline's own
        self.timer = timer if timer is not None else PhaseTimer()

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
        """Run the engine :func:`resolve_engine` names; a device-engine
        run that raises EngineFallback (and nothing else) restarts on the
        exact engine, its stdout discarded."""
        engine_mod.LAST_ENGINE_USED = None
        engine_mod.LAST_CLIMB_ENGINE = engine_mod.LAST_PWM_ENGINE = None
        engine_mod.LAST_HYBRID_FRAC = None
        engine = resolve_engine(params.engine, params.device,
                                params.max_pattern_length)
        if engine == "tpu":
            # buffer stdout so a mid-run fallback can restart cleanly
            real_out, buf = self.out, io.StringIO()
            self.out = buf
            try:
                result = process_gpu(self, params)
                real_out.write(buf.getvalue())
                return result
            except EngineFallback as e:
                self.log.info(f"device engine fallback: {e}; "
                              "running exact engine")
                # a deferred background model (the fused device count
                # never delivered) starts its threaded host scan now, so
                # it overlaps the exact engine's count
                with self.timer.span("fallback"):
                    self.bg_model.start_host_counting()
            finally:
                self.out = real_out
        result = self._process_exact(params)
        engine_mod.LAST_ENGINE_USED = "exact"
        engine_mod.LAST_CLIMB_ENGINE = engine_mod.LAST_PWM_ENGINE = "host"
        return result

    def _process_exact(self, params: PengParameters) -> List[Motif]:
        """The byte-exact engine (reference package: pipeline.py:199-304)."""
        W = params.max_pattern_length
        self._status(f"Processing kmers of length {W}", leading_newline=False)
        self._status("Finding overrepresented kmers (base patterns)",
                     leading_newline=False)

        current_k = min(W - 1, self.k)
        current_max_k = min(W - 1, self.max_k)

        precomputed = params.precomputed
        if params.load_checkpoint:
            loaded = load_checkpoint(
                params.load_checkpoint, W, self.strand.name)
            if loaded is not None:
                precomputed = loaded[:2]

        with self.timer.phase("count"):
            tables = PatternTables(
                W, self.strand, current_k, current_max_k,
                self.sequence_set.padded(), self.bg_model, self.n_sequences,
                params.device, mesh=params.mesh, precomputed=precomputed,
                zscore_threshold=params.zscore_threshold)

        if params.save_checkpoint:
            save_checkpoint(params.save_checkpoint, W, self.strand.name,
                            tables.counts_np, tables.ltot, self.bg_model)

        selected = tables.select_base_patterns(
            params.zscore_threshold, params.count_threshold,
            self.strand == Strand.PLUS_STRAND, params.filter_neighbors)
        if not selected:
            print("No overrepresented seed patterns found. Stopping.",
                  file=self.out)
        self._print_seed_table(tables, selected)

        self._status("Optimizing base patterns")
        print(file=self.out)
        if len(selected) > params.max_optimized_patterns:
            selected = selected[: params.max_optimized_patterns]

        with self.timer.phase("optimize"):
            candidates = self._optimize_iupac_patterns(
                params.opt_score_type, tables, selected,
                params.enrich_pseudocount_factor)
        print(file=self.out)
        self._status("Filtering degenerated IUPAC patterns")
        candidates = self._filter_iupac_patterns(
            W, params.minimum_processed_motifs, candidates)
        for motif in candidates:
            print(f"selected iupac pattern: {motif.iupac_string()}",
                  file=self.out)

        self._status("Calculating PWMs")
        with self.timer.phase("pwm"):
            self._calculate_pwms(tables, candidates, params)

        self._status("Optimizing expectation-maximization / merging patterns")
        # the reference prints and tags the *unclamped* max_k
        # (src/peng.cpp:397-399); tables are clamped to W-1 (at W-1 <
        # max_k the <=3-informative-positions filter leaves no motifs)
        background = self.max_k
        table_order = min(background, W - 1)
        print(f"\nbackground order: {background}", file=self.out)
        with self.timer.phase("em+merge"):
            if params.use_em:
                optimized = self._em_optimize(
                    candidates, tables, params.em_saturation_factor,
                    params.em_min_threshold, params.em_max_iterations,
                    table_order, params.threads)
            else:
                optimized = candidates
            if params.use_merging:
                if W >= MIN_MERGE_OVERLAP:
                    self._merge_patterns(
                        W, params.bit_factor_merge_threshold, optimized,
                        params.max_merged_length)
                else:
                    print(f"Warning: Specified pattern length ({W}) is too "
                          "low for merging!", file=sys.stderr)

        for motif in optimized:
            motif.opt_bg_order = background
        return optimized

    # -- exact engine, phase 2: hill climb (reference: src/peng.cpp:437-541)
    def _optimize_iupac_patterns(
        self, score_type: OptimizationScore, tables: PatternTables,
        selected: List[int], enrich_pseudocount_factor: float,
    ) -> List[Motif]:
        W = tables.pattern_length
        seen: Set[int] = set()
        best_ids: Set[int] = set()
        best_motifs: List[Motif] = []
        pseudo_expected = int(self.n_sequences * enrich_pseudocount_factor)

        for base_pattern in selected:
            best = self._make_motif(base_id_to_iupac_id(base_pattern, W),
                                    tables)
            best_score = tables.optimization_score(
                score_type, base_pattern, pseudo_expected)
            self._print_climb_row(best, best_score)

            improved = True
            while improved:
                improved = False
                mother = best.pattern_id
                mother_digits = iupac_id_to_digits(mother, W)

                # candidate batch: every position x every similar letter,
                # in reference evaluation order (src/peng.cpp:470-501)
                sims = [_IUPAC_SIMILAR_ARR[c] for c in mother_digits]
                pos_idx = np.repeat(
                    np.arange(W), [s.shape[0] for s in sims])
                letters = np.concatenate(sims)
                n_cand = letters.shape[0]
                cand_digits = np.repeat(
                    mother_digits[None].astype(np.int32), n_cand, 0)
                cand_digits[np.arange(n_cand), pos_idx] = letters
                pow_p = _POW11[pos_idx]
                cand_ids = (
                    mother
                    - mother_digits[pos_idx].astype(np.int64) * pow_p
                    + letters.astype(np.int64) * pow_p)
                counts, expected, bgp, zs, logp, scores = \
                    tables.aggregate_and_score(cand_digits, score_type,
                                               pseudo_expected)
                current_seen = set(cand_ids.tolist())
                # the reference walk accepts every strict improvement over
                # the running best (printing each); the accept set is
                # exactly scores[i] < min(best, scores[:i]) (fmin: NaN
                # scores never update the running min, matching
                # `NaN < best` = false in the scalar walk)
                runmin = np.fmin.accumulate(
                    np.concatenate(([np.float32(best_score)], scores)))
                for idx in np.flatnonzero(scores < runmin[:-1]):
                    idx = int(idx)
                    improved = True
                    best_score = scores[idx]
                    mutant = Motif(int(cand_ids[idx]), W)
                    mutant.bg_p = bgp[idx]
                    mutant.expected_counts = expected[idx]
                    mutant.zscore = zs[idx]
                    mutant.n_sites = int(counts[idx])
                    mutant.local_n_sites[:] = mutant.n_sites
                    mutant.log_pvalue = logp[idx]
                    best = mutant
                    self._print_climb_row(best, best_score)

                if best.pattern_id in seen:
                    improved = False
                current_seen.discard(best.pattern_id)
                seen.update(current_seen)

            if best.pattern_id not in best_ids and best.pattern_id not in seen:
                best_motifs.append(best)
                best_ids.add(best.pattern_id)
                seen.add(best.pattern_id)
                print(f"optimization: {tables.to_string(base_pattern)} -> "
                      f"{best.iupac_string()}\n", file=self.out)
            else:
                print(f"optimization: {tables.to_string(base_pattern)} "
                      f"removed\t\n", file=self.out)

        self._print_motif_table(best_motifs)
        return best_motifs

    def _make_motif(self, iupac_id: int, tables: PatternTables) -> Motif:
        motif = Motif(iupac_id, tables.pattern_length)
        digits = iupac_id_to_digits(iupac_id, tables.pattern_length)
        counts, expected, bgp = tables.aggregate_digits(
            np.asarray(digits)[None])
        motif.set_aggregates(int(counts[0]), expected[0], bgp[0],
                             LOG_BONFERRONI)
        return motif

    # -- exact engine, phase 3: PWMs (reference: src/peng.cpp:372-393) ---
    def _calculate_pwms(self, tables: PatternTables, motifs: List[Motif],
                        params: PengParameters):
        W = tables.pattern_length
        bg0 = self.bg_model.v[0]
        if not params.adv_pwm:
            # the reference's default-PWM quirk (engine.default_pwm)
            for motif in motifs:
                motif.pwm = engine_mod.default_pwm(self, params, motif, W)
                motif.calculate_comp_pwm()
                self._print_pwm_row("def pwm: ", motif)
            return
        # one batched call: 4 letter-substitutions x W positions x all
        # motifs (the reference computes these counts one expansion at a
        # time, src/iupac_pattern.cpp:505-536)
        digit_batch = []
        for motif in motifs:
            digits = iupac_id_to_digits(motif.pattern_id, W)
            for p in range(W):
                for letter in range(4):
                    d = digits.copy()
                    d[p] = letter
                    digit_batch.append(d)
        if digit_batch:
            counts, _, _ = tables.aggregate_digits(np.stack(digit_batch))
        idx = 0
        for motif in motifs:
            pwm = np.zeros((W, 4), dtype=F32)
            for p in range(W):
                i_total = np.zeros(4, dtype=np.int64)
                for letter in range(4):
                    i_total[letter] = int(
                        params.pseudo_counts * F32(bg0[letter])
                    ) + int(counts[idx])
                    idx += 1
                n_total = int(i_total.sum())
                pwm[p] = (i_total.astype(np.float64) / n_total).astype(F32)
            motif.pwm = pwm
            motif.calculate_comp_pwm()
            self._print_pwm_row("adv pwm: ", motif)

    # -- exact engine, phase 4a: EM (reference: src/peng.cpp:48-178) -----
    def _em_optimize(self, motifs: List[Motif], tables: PatternTables,
                     saturation_factor: float, min_threshold: float,
                     max_iterations: int, background_order: int,
                     threads: int = 0) -> List[Motif]:
        """Native EM in the reference's operation order (bit-exact),
        threaded over motifs."""
        if not motifs:
            return []
        W = tables.pattern_length
        final_pwms = em_optimize_native(
            np.stack([m.pwm for m in motifs]).astype(np.float32),
            tables.counts_np.astype(np.float32),
            tables.bg_tensors.host_flat(background_order),
            saturation_factor, min_threshold, max_iterations,
            n_threads=threads)
        optimized = []
        for i, motif in enumerate(motifs):
            new_motif = motif.clone_with_pwm(final_pwms[i])
            optimized.append(new_motif)
            info = numerics.pwm_info_content(new_motif.pwm) / W
            print(f"em: {motif.iupac_string()} -> "
                  f"{new_motif.pattern_string(self.iupac_profile)}   "
                  f"[ avg. info: {info:.2f} ]", file=self.out)
        return optimized

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

    def _print_seed_table(self, tables: PatternTables, selected: List[int]):
        # reference: src/base_pattern.cpp:517-532
        print(f"{'pattern':>15}\t{'observed':>15}\t{'enrichment':>15}\t"
              f"{'zscore':>15}\n", file=self.out)
        for pattern in selected:
            obs = int(tables.counts_np[pattern])
            enr = obs / tables.expected_np[pattern]
            print(f"{tables.to_string(pattern):>15}\t{obs:>15}\t"
                  f"{enr:>15.2f}\t{tables.zscores_np[pattern]:>15.2f}",
                  file=self.out)

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
