"""Pattern tables over a counted 4**W table: background probabilities,
per-pattern statistics and IUPAC aggregation.

Counterpart of the reference's BasePattern (reference:
src/base_pattern.{h,cpp}) for the host twins of phases 2-5: the count
table and ltot arrive precomputed from the device count
(engine.process_gpu); every float table is built by the native library
in the reference's exact operation order.
"""

from __future__ import annotations

from enum import Enum

import numpy as np

from .alphabets import base_id_to_string
from .models.background import BackgroundModel


class Strand(Enum):
    PLUS_STRAND = 0
    BOTH_STRANDS = 1


class OptimizationScore(Enum):
    LOGPVAL = 0
    ENRICHMENT = 1
    MUTUAL_INFO = 2


class _LazyBgTensors:
    """Per-order background probability tables, built on demand by the
    native library in the reference's exact multiply order (reference:
    src/base_pattern.cpp:42-49 builds all orders eagerly)."""

    def __init__(self, v_host, length: int, both: bool):
        self._v_host = v_host
        self._length = length
        self._both = both
        self._host: dict = {}

    def host_flat(self, order: int) -> np.ndarray:
        if order not in self._host:
            from .native import bg_prob_table_native_fn  # noqa: PLC0415

            self._host[order] = bg_prob_table_native_fn(
                self._v_host[: order + 1], self._length, order, self._both)
        return self._host[order]


class PatternTables:
    """4**W count table + background probabilities + per-pattern stats.

    Mirrors the phase-1 construction order of the reference BasePattern
    ctor (src/base_pattern.cpp:17-64) from a precomputed ``(counts,
    ltot)``: background tables, expected counts, z-scores, log p-values.
    """

    def __init__(
        self,
        pattern_length: int,
        strand: Strand,
        k: int,
        max_k: int,
        bg_model: BackgroundModel,
        n_sequences: int,
        precomputed,
    ):
        from .native import (  # noqa: PLC0415
            base_log_pvalues_native, base_stats_native)

        self.pattern_length = W = pattern_length
        self.strand = strand
        self.k = k
        self.max_k = max(k, max_k)
        self.n_sequences = n_sequences
        self.number_patterns = 4 ** W
        self.both = strand == Strand.BOTH_STRANDS

        v_host = [np.asarray(vk, dtype=np.float32)
                  for vk in bg_model.v[: self.max_k + 1]]
        self.bg_tensors = _LazyBgTensors(v_host, W, self.both)
        self.counts_np = np.asarray(precomputed[0], dtype=np.int32)
        self.ltot = int(precomputed[1])

        # float statistics with the reference's float/double promotion
        # points and its binary's exact libm (src/base_pattern.cpp:56-63)
        self.bgp_np = self.bg_tensors.host_flat(self.k)
        self.expected_np, self.zscores_np = base_stats_native(
            self.counts_np, self.bgp_np, self.ltot)
        self._logp_np = base_log_pvalues_native(
            self.counts_np, self.expected_np)

    # -- aggregation -------------------------------------------------------

    def aggregate_digits(self, digit_batch: np.ndarray):
        """Batched IUPAC aggregation from digit vectors [B, W]: returns
        (counts [B] int64, expected [B] f32, bg_p [B] f32), folded in the
        reference's summation order (native, bit-exact)."""
        from .native import iupac_aggregate_exact  # noqa: PLC0415

        return iupac_aggregate_exact(
            np.asarray(digit_batch, dtype=np.int32), self.both,
            self.counts_np, self.expected_np, self.bgp_np)

    def aggregate_and_score(
        self, digit_batch: np.ndarray, score_type, pseudo_expected: int
    ):
        """Single native pass: aggregation + statistics + optimization
        score for a candidate batch (bit-exact reference semantics; see
        pengnative.cpp).  Returns (counts, expected, bgp, zscore, logp,
        score) arrays."""
        from .native import iupac_aggregate_score  # noqa: PLC0415

        return iupac_aggregate_score(
            np.asarray(digit_batch, dtype=np.int32), self.both,
            self.counts_np, self.expected_np, self.bgp_np,
            score_type.value, pseudo_expected, self.n_sequences,
        )

    # -- per-pattern host-side accessors ----------------------------------

    def optimization_score(
        self, score_type: OptimizationScore, pattern: int, pseudo_expected: int
    ) -> np.float32:
        """Seed score from the base tables
        (reference: src/base_pattern.cpp:180-224)."""
        if score_type == OptimizationScore.LOGPVAL:
            # the reference returns the precomputed table value
            # (src/base_pattern.cpp:202-204)
            return np.float32(self._logp_np[pattern])
        from .native import base_opt_score_native  # noqa: PLC0415

        return base_opt_score_native(
            score_type.value, int(self.counts_np[pattern]),
            self.expected_np[pattern], pseudo_expected, self.n_sequences,
        )

    def to_string(self, pattern: int) -> str:
        return base_id_to_string(pattern, self.pattern_length)
