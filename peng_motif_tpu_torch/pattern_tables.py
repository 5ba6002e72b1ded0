"""The exact engine's phase-1 tables: counts, background probabilities,
per-pattern statistics, seed selection and IUPAC aggregation.

Counterpart of ``peng_motif_tpu/pattern_tables.py`` (reference:
src/base_pattern.{h,cpp}): one object owning the 4**W host tables.  The
count is ops/counting.CountJob (the threaded native scan, or the batch
device count on ``device``); every float table is built by the native
library in the reference's operation order, so the exact engine's output
is byte-identical to the reference binary.  The native library is
mandatory in this package, so the reference's non-native branches (numpy
statistics and log p-values, the Python seed walk, the device
aggregation) are not here.
"""

from __future__ import annotations

import threading
from enum import Enum
from typing import List

import numpy as np

from .alphabets import base_id_to_string
from .native import (
    base_log_pvalues_native,
    base_opt_score_native,
    base_stats_native,
    bg_prob_table_native_fn,
    iupac_aggregate_exact,
    iupac_aggregate_score,
    select_patterns_walk_native,
    zscore_sort_indices,
    zscore_sort_prefix_indices,
)
from .ops import counting


class Strand(Enum):
    PLUS_STRAND = 0
    BOTH_STRANDS = 1


class OptimizationScore(Enum):
    LOGPVAL = 0
    ENRICHMENT = 1
    MUTUAL_INFO = 2


class _LazyBgTensors:
    """Per-order background probability tables, computed on demand in
    the reference's exact multiply order (reference:
    src/base_pattern.cpp:42-49 builds all orders eagerly)."""

    def __init__(self, v_host, length: int, both: bool):
        self._v_host = v_host
        self._length = length
        self._both = both
        self._host: dict = {}

    def host_flat(self, order: int) -> np.ndarray:
        if order not in self._host:
            self._host[order] = bg_prob_table_native_fn(
                self._v_host[: order + 1], self._length, order, self._both)
        return self._host[order]


class PatternTables:
    """4**W count table + background probabilities + per-pattern stats.

    Mirrors the phase-1 construction order of the reference BasePattern
    ctor (src/base_pattern.cpp:17-64): background tables, double-strand
    aggregation, counting, expected counts, log p-values, z-scores.
    ``precomputed`` = (counts, ltot) (a loaded checkpoint, or the
    multi-process count) skips the count; with a ``mesh`` the sequences
    shard over its devices and the tables are summed
    (parallel/sharded.count_patterns_sharded).
    """

    def __init__(self, pattern_length: int, strand: Strand, k: int,
                 max_k: int, padded_codes: np.ndarray, bg_model,
                 n_sequences: int, device, mesh=None, precomputed=None,
                 zscore_threshold=None):
        self.pattern_length = W = pattern_length
        self.strand = strand
        self.k = k
        self.max_k = max(k, max_k)
        self.n_sequences = n_sequences
        self.number_patterns = 4 ** W
        self.both = strand == Strand.BOTH_STRANDS

        # the count starts first, so the scan overlaps the background
        # model (a lazily counting model joins on .v) and its table
        job = None
        if precomputed is None and mesh is not None:
            from .parallel.sharded import count_patterns_sharded  # noqa: PLC0415

            precomputed = count_patterns_sharded(padded_codes, W, self.both,
                                                 mesh)
        elif precomputed is None:
            job = counting.CountJob(padded_codes, W, self.both, device)
        v_host = [np.asarray(vk, dtype=np.float32)
                  for vk in bg_model.v[: self.max_k + 1]]
        self.bg_tensors = _LazyBgTensors(v_host, W, self.both)
        self.bgp_np = self.bg_tensors.host_flat(self.k)
        if job is None:
            self.counts_np = np.asarray(precomputed[0], dtype=np.int32)
            self.ltot = int(precomputed[1])
        else:
            self.counts_np, self.ltot = job.finish()

        # float statistics in the reference's exact operation order
        # (src/base_pattern.cpp:56-63; log through the native helper for
        # the reference binary's libm)
        self.expected_np, self.zscores_np = base_stats_native(
            self.counts_np, self.bgp_np, self.ltot)
        # the z-sort (native, GIL released) overlaps the log-p table;
        # _seed_order joins it.  With a known selection threshold the
        # prefix-pruned sort runs (identical on the consumed prefix)
        self._order_result = [None]
        self._order_thr = (None if zscore_threshold is None
                           else float(zscore_threshold))
        z, thr = self.zscores_np, self._order_thr

        def _sort():
            self._order_result[0] = (
                zscore_sort_indices(z) if thr is None
                else zscore_sort_prefix_indices(z, thr))

        self._order_thread = threading.Thread(target=_sort, daemon=True)
        self._order_thread.start()
        self._logp_np = base_log_pvalues_native(self.counts_np,
                                                self.expected_np)

    # -- aggregation -------------------------------------------------------

    def aggregate_digits(self, digit_batch: np.ndarray):
        """Batched IUPAC aggregation from digit vectors [B, W]: (counts
        [B] int64, expected [B] f32, bg_p [B] f32), bit-exact in the
        reference's summation order."""
        return iupac_aggregate_exact(
            np.asarray(digit_batch, dtype=np.int32), self.both,
            self.counts_np, self.expected_np, self.bgp_np)

    def aggregate_and_score(self, digit_batch: np.ndarray, score_type,
                            pseudo_expected: int):
        """Aggregation + statistics + optimization score of a candidate
        batch in one native pass: (counts, expected, bgp, zscore, logp,
        score)."""
        return iupac_aggregate_score(
            np.asarray(digit_batch, dtype=np.int32), self.both,
            self.counts_np, self.expected_np, self.bgp_np,
            score_type.value, pseudo_expected, self.n_sequences)

    # -- per-pattern host-side accessors ----------------------------------

    def optimization_score(self, score_type: OptimizationScore, pattern: int,
                           pseudo_expected: int) -> np.float32:
        """Seed score from the base tables
        (reference: src/base_pattern.cpp:180-224)."""
        if score_type == OptimizationScore.LOGPVAL:
            # the reference returns the precomputed table value
            # (src/base_pattern.cpp:202-204)
            return np.float32(self._logp_np[pattern])
        return base_opt_score_native(
            score_type.value, int(self.counts_np[pattern]),
            self.expected_np[pattern], pseudo_expected, self.n_sequences)

    def to_string(self, pattern: int) -> str:
        return base_id_to_string(pattern, self.pattern_length)

    # -- seed selection (reference: src/base_pattern.cpp:443-515) ---------

    def select_base_patterns(self, zscore_threshold: float,
                             count_threshold: int, single_stranded: bool,
                             filter_neighbors: bool) -> List[int]:
        """Greedy threshold walk over z-sorted patterns with optional
        Hamming-1 neighbor suppression and revcomp dedup (native)."""
        order = self._seed_order(zscore_threshold)
        return [int(p) for p in select_patterns_walk_native(
            order, self.zscores_np, self.counts_np, self.pattern_length,
            zscore_threshold, count_threshold, single_stranded,
            filter_neighbors)]

    def _seed_order(self, zscore_threshold: float) -> np.ndarray:
        """Patterns in descending-z order: the full std::sort via the
        native helper, so bitwise z-score ties (every reverse-complement
        pair) land where the reference binary's libstdc++ sort puts them
        (reference: src/base_pattern.cpp:454-458)."""
        if self._order_thread is not None:
            self._order_thread.join()
            self._order_thread = None
            if self._order_thr in (None, float(zscore_threshold)):
                return self._order_result[0]
        return zscore_sort_indices(self.zscores_np)
